"""Process groups and process identity: the port of the JAX package's
``parallel/mesh.py``.

JAX's mesh is a grid of devices inside one program; here each device is a
rank (a process), and ``make_mesh`` lays the ranks out on the same grid:
mesh rank r sits at the row-major coordinates of ``cfg.axis_order`` (with
the default order and only data and fsdp > 1, r = d * fsdp + f, JAX's
device order), and every axis of size > 1 gets the process groups of the
ranks that differ only along it. Collectives are explicit calls on those
groups (``parallel/zero``).

- ``spawn_ranks``: the twins' ``--cpu-devices N`` (and the
  ``decode_bench`` twin's multi-rank sub-legs), N ranks of a module
  started on this host as a launcher would, ended at ``SPAWN_LIMIT_S``;
  its ranks join their group with the ``RANK_TIMEOUT_S`` timeout, so a
  rank stuck in a collective its peers never reach fails well inside
  that limit.
- The one launcher for every child process the port (and
  ``chip_smoke.py``) starts: ``launch`` (one child), ``run`` (one child to
  its end, ``subprocess.run``'s contract) and ``run_group`` (ranks). Each
  child starts in a session of its own, so its whole process group can be
  killed; on a timeout, an exception or a rank that exits nonzero the
  launcher kills the groups (SIGKILL) and waits on them, and when one rank
  fails the others are killed at once, as torchrun does. Every group is
  registered until it is reaped (``registered`` lists them), so
  ``kill_all`` (a signal handler's or ``atexit``'s) reaches every group
  still alive. A child that is itself Python calls ``bind_to_parent``
  first thing: the kernel then kills it when its parent dies
  (``PR_SET_PDEATHSIG``), which ``finally`` blocks and signal handlers
  cannot do for a parent that is SIGKILLed.
  ``live_descendants`` lists what is left below a process.
- ``initialize_distributed()``: the env:// rendezvous torchrun sets up
  (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); without
  them a world of one on a free localhost port. Backend ``nccl`` for a
  CUDA rank and ``gloo`` for a CPU rank, unless the caller names one
  (gloo on CUDA tensors stages them through the host: the way two ranks
  share one card, which NCCL refuses). Every group gets ``timeout``
  (default: ``RANK_TIMEOUT_S`` in a rank ``spawn_ranks`` started,
  ``DEFAULT_TIMEOUT_S`` otherwise).
- ``process_info()``, ``data_parallel_size``, ``batch_partition_spec``
  (JAX's spec as a tuple), ``batch_rows`` (the rows of the global
  [A, B, T] batch a rank owns: B split over data x fsdp x expert, data
  major) and
  ``seq_cols`` (the positions of T a rank owns: T split over seq).
- ``fold_batch_shard_key``: the JAX package folds the batch shard's index
  (over data, fsdp and expert) and the seq index into the dropout key; the
  port's ``DropoutKey`` takes ``shard`` = 1 + (batch shard index x seq +
  seq index) (0 stays "not folded"). JAX's threefry streams cannot be
  matched, so this is held to the port itself: each shard's masks differ,
  and a world of one keeps the single-device masks.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from pytorch_distributed_tpu_torch.config import MeshConfig
from pytorch_distributed_tpu_torch.utils.prng import DropoutKey

DEFAULT_TIMEOUT_S = 600.0
# A twin's ranks that ``spawn_ranks`` started: the group timeout each
# joins with, and the wall the whole group may take.
RANK_TIMEOUT_S = 120.0
SPAWN_LIMIT_S = 900.0
_TIMEOUT_ENV = "PDTPU_GROUP_TIMEOUT_S"
# The axes a batch is split over, in the order of JAX's batch spec.
BATCH_AXES = ("data", "fsdp", "expert")


def free_port() -> int:
    """A free TCP port on 127.0.0.1 (a rendezvous's)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- child processes ----------------------------------------------------------

# The launcher's pid, as its children see it (``bind_to_parent``).
PARENT_PID_ENV = "PDTPU_PARENT_PID"
_PR_SET_PDEATHSIG = 1  # <linux/prctl.h>
_POLL_S = 0.05
_live: dict[int, subprocess.Popen] = {}  # process group id -> its leader
_live_lock = threading.Lock()


def bind_to_parent() -> None:
    """Die with the launcher: ask the kernel for SIGKILL when the parent
    exits (``prctl(PR_SET_PDEATHSIG)`` through ``ctypes``), then exit at
    once if the parent is already gone (it died before the call). A no-op
    in a process the launcher did not start, or off Linux. The variable
    naming the launcher is taken out of the environment, so a process this
    one starts by other means does not read it."""
    want = os.environ.pop(PARENT_PID_ENV, None)
    if want is None or not sys.platform.startswith("linux"):
        return
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(_PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG) failed")
    if os.getppid() != int(want) and not _alive(int(want)):
        os._exit(1)  # orphaned before the prctl: the parent is gone


def _alive(pid: int) -> bool:
    return _proc_state(pid) not in (None, "Z", "X")


def launch(argv: list[str], *, env: dict | None = None, stdout=None,
           stderr=None) -> subprocess.Popen:
    """Start ``argv`` in a session of its own (its own process group) and
    register the group until ``kill_group`` takes it off.
    ``env`` (default: this process's) gains ``PARENT_PID_ENV``."""
    env = dict(os.environ if env is None else env)
    env[PARENT_PID_ENV] = str(os.getpid())
    proc = subprocess.Popen(argv, env=env, stdout=stdout, stderr=stderr,
                            text=True, start_new_session=True)
    with _live_lock:
        _live[proc.pid] = proc
    return proc


def kill_group(proc: subprocess.Popen) -> None:
    """SIGKILL ``proc``'s whole process group, wait on ``proc`` and take
    the group off the register. Safe after ``proc`` exited: the group id
    is not reused while any member lives, and an empty group is gone."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass
    proc.wait()
    with _live_lock:
        _live.pop(proc.pid, None)


def registered() -> list[int]:
    """The process group ids (their leaders' pids) registered now: the
    groups ``launch`` started that ``kill_group`` has not reaped."""
    with _live_lock:
        return list(_live)


def kill_all() -> None:
    """``kill_group`` every registered group still alive (``atexit``'s)."""
    with _live_lock:
        procs = list(_live.values())
    for proc in procs:
        kill_group(proc)


def _kill_all_from_handler(reap_s: float = 2.0) -> list[int]:
    """``kill_all`` for a signal handler, which may have interrupted the
    launcher inside a lock it would need: SIGKILL every registered group
    without locks, then reap the leaders for up to ``reap_s``."""
    pids = list(_live)
    for pid in pids:
        try:
            os.killpg(pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
    left, end = set(pids), time.monotonic() + reap_s
    while left and time.monotonic() < end:
        for pid in list(left):
            try:
                if os.waitpid(pid, os.WNOHANG)[0]:
                    left.discard(pid)
            except ChildProcessError:
                left.discard(pid)
        time.sleep(0.01)
    return pids


def install_exit_handlers(name: str) -> None:
    """For a process that launches children (``chip_smoke.py``, a twin):
    SIGTERM and SIGINT kill every registered group and end the process
    with 128 + the signal's number, one line on stderr saying so; and
    ``atexit`` kills whatever is still registered at a normal exit."""
    import atexit

    def handler(signum, frame):
        pids = _kill_all_from_handler()
        print(f"{name}: ended by signal {signum}; killed the process "
              f"groups of {pids}", file=sys.stderr, flush=True)
        os._exit(128 + signum)

    signal.signal(signal.SIGTERM, handler)
    signal.signal(signal.SIGINT, handler)
    atexit.register(kill_all)


def run(argv: list[str], *, timeout: float | None, env: dict | None = None,
        log=None) -> subprocess.CompletedProcess:
    """``subprocess.run(argv, timeout=...)`` through ``launch``: on the
    timeout (``subprocess.TimeoutExpired``) or any exception the child's
    whole group is killed, not only the child; after a normal exit the
    group is swept too, so nothing the child left behind outlives it.
    The child's stdout and stderr, interleaved, are captured in the
    result's ``stdout``, or go to the open file ``log``."""
    proc = launch(argv, env=env,
                  stdout=subprocess.PIPE if log is None else log,
                  stderr=subprocess.STDOUT)
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        kill_group(proc)
    return subprocess.CompletedProcess(argv, proc.returncode, out, err)


def run_group(argvs: list[list[str]], envs: list[dict], *,
              timeout_s: float | None, stdout=None,
              capture_stderr: bool = True,
              while_running=None) -> list[tuple[int, str]]:
    """Start one child per ``argvs[i]`` with ``envs[i]`` (``launch``) and
    wait for all: when one exits nonzero the others are killed at once;
    at ``timeout_s`` (``TimeoutError``) or on any exception (an
    interrupt, a signal handler's ``SystemExit``) all of them are.
    ``while_running``: called here once the children are started (its
    exception kills them too). Returns each child's (exit code, stderr
    text; "" unless ``capture_stderr``): -9 for a child the launcher
    killed."""
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    files = [tempfile.TemporaryFile("w+") if capture_stderr else None
             for _ in argvs]
    procs = []
    try:
        for argv, env, f in zip(argvs, envs, files):
            procs.append(launch(argv, env=env, stdout=stdout, stderr=f))
        if while_running is not None:
            while_running()
        while True:
            codes = [p.poll() for p in procs]  # every one polled
            if None not in codes or any(codes):
                break  # all done, or one failed: the rest killed below
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"{len(procs)} processes did not finish in "
                    f"{timeout_s:.0f} s: {argvs[0]}")
            time.sleep(_POLL_S)
    finally:
        for p in procs:
            kill_group(p)
    out = []
    for p, f in zip(procs, files):
        err = ""
        if f is not None:
            f.seek(0)
            err = f.read()
            f.close()
        out.append((p.returncode, err))
    return out


def _proc_state(pid: int) -> str | None:
    try:
        stat = Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return None
    return stat.rsplit(")", 1)[1].split()[0]


def _is_process(pid: int) -> bool:
    """Whether ``pid`` is a process (its thread group's leader), not one
    of its other threads: some kernels list a child's threads in
    ``children`` too."""
    try:
        status = Path(f"/proc/{pid}/status").read_text()
    except OSError:
        return False
    for line in status.splitlines():
        if line.startswith("Tgid:"):
            return int(line.split()[1]) == pid
    return False


def live_descendants(pid: int | None = None) -> list[tuple[int, str]]:
    """(pid, command line) of every living process below ``pid`` (default:
    this one), from ``/proc/<pid>/task/*/children`` recursively; a zombie
    counts as gone, and a thread is not a process."""
    out = []
    todo = [os.getpid() if pid is None else pid]
    seen = set(todo)
    while todo:
        p = todo.pop()
        try:
            tasks = os.listdir(f"/proc/{p}/task")
        except OSError:
            continue
        for tid in tasks:
            try:
                kids = Path(f"/proc/{p}/task/{tid}/children").read_text()
            except OSError:
                continue
            for c in map(int, kids.split()):
                if c in seen or not _is_process(c):
                    continue
                seen.add(c)
                todo.append(c)
                if _proc_state(c) not in (None, "Z", "X"):
                    try:
                        cmd = Path(f"/proc/{c}/cmdline").read_bytes()
                    except OSError:
                        continue
                    out.append((c, cmd.replace(b"\0", b" ").decode(
                        errors="replace").strip()))
    return out


def spawn_ranks(n: int, module: str, argv: list[str]) -> int:
    """Start ``n`` ranks of ``python -m module argv`` on this host, as a
    launcher would (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE`` and a free
    127.0.0.1 port), through ``run_group``: a rank that exits nonzero ends
    the others at once, so a rank whose peer died does not wait out the
    group's timeout; and all of them end at ``SPAWN_LIMIT_S``, which then
    returns 124 with a line on stderr. Each rank joins its group with
    ``RANK_TIMEOUT_S``. The highest exit code wins."""
    port = free_port()
    envs = [dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                 WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port),
                 **{_TIMEOUT_ENV: str(RANK_TIMEOUT_S)})
            for r in range(n)]
    try:
        out = run_group([[sys.executable, "-m", module, *argv]] * n, envs,
                        timeout_s=SPAWN_LIMIT_S, capture_stderr=False)
    except TimeoutError as err:
        print(f"spawn_ranks: {err}; killed", file=sys.stderr, flush=True)
        return 124
    return max(rc for rc, _ in out)


def initialize_distributed(*, device: str | torch.device | None = None,
                           backend: str | None = None,
                           timeout_s: float | None = None) -> None:
    """Join the process group (idempotent). ``device``: where this rank
    computes (None: the card), which picks the default backend.
    ``timeout_s`` None: the module docstring's default."""
    if dist.is_initialized():
        return
    if timeout_s is None:
        timeout_s = float(os.environ.get(_TIMEOUT_ENV, DEFAULT_TIMEOUT_S))
    dev = torch.device("cuda" if device is None else device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        init = "env://"
    else:  # one process, no launcher: a world of one
        rank, world = 0, 1
        init = f"tcp://127.0.0.1:{free_port()}"
    kw = {}
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", "0"))
        kw["device_id"] = torch.device("cuda", local if dev.index is None
                                       else dev.index)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=timeout_s), **kw)


def process_info() -> dict:
    """The JAX package's keys: each rank is a process driving one device."""
    init = dist.is_initialized()
    world = dist.get_world_size() if init else 1
    return {
        "process_index": dist.get_rank() if init else 0,
        "process_count": world,
        "local_device_count": 1,
        "global_device_count": world,
    }


@dataclasses.dataclass
class Mesh:
    """This rank's place on the mesh: ``coords`` (axis -> index), the
    mesh's process group and, per axis of size > 1, the group of ranks
    that differ only along that axis (``groups``). ``device``: where the
    rank computes. ``backend``: the groups' backend. ``batch_group``: the
    ranks that differ only in their data and fsdp indices (the gradients'
    and the loss's reduction over JAX's data and fsdp axes) — the mesh's
    group without a tensor, seq, pipe or expert axis, else the data x fsdp
    plane of this rank's other indices, None when the batch is not split
    there. The expert axis splits the batch too, but its ranks hold
    different experts, so it reduces on its own group
    (``parallel/explicit.reduce_at_boundary``). Under a pipe axis
    ``axis_index("pipe")`` is this rank's stage, and the pipe group joins
    the ranks that hold the same rows and slices in every stage
    (``parallel/pipeline``'s hops); the batch group is then a data x fsdp
    plane too."""

    cfg: MeshConfig
    rank: int
    coords: dict
    group: object
    groups: dict
    device: torch.device
    backend: str
    batch_group: object = None

    @property
    def size(self) -> int:
        return self.cfg.num_devices

    def axis_size(self, axis: str) -> int:
        return getattr(self.cfg, axis)

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def axis_group(self, axis: str):
        """The group along ``axis`` (the mesh's own group when it is the
        only axis of size > 1)."""
        return self.groups[axis]


def _default_device(cfg: MeshConfig, rank: int, backend: str):
    if cfg.device_ids is not None:
        return torch.device("cuda", cfg.device_ids[rank])
    if backend == "gloo" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on the GPU by default, but CUDA is not "
            "available here — pass device='cpu' to make_mesh")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def make_mesh(cfg: MeshConfig, *, group=None,
              device: str | torch.device | None = None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """The mesh of ``cfg`` over ``group``'s ranks (default: the world,
    which ``initialize_distributed`` must have joined), in group-rank
    order; the group's size must be ``cfg.num_devices``. Every rank of the
    group calls this, in the same order as its other group creations."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "initialize_distributed() first")
    group = group or dist.group.WORLD
    size = dist.get_world_size(group)
    if size != cfg.num_devices:
        raise ValueError(f"mesh needs {cfg.num_devices} ranks "
                         f"({cfg.shape}) but the group has {size}")
    rank = dist.get_rank(group)
    global_ranks = dist.get_process_group_ranks(group)
    shape = tuple(cfg.shape.values())
    grid = np.arange(size).reshape(shape)
    coords = dict(zip(cfg.axis_order,
                      (int(i) for i in np.unravel_index(rank, shape))))
    backend = dist.get_backend(group)
    live = [ax for ax in cfg.axis_order if getattr(cfg, ax) > 1]
    groups = {}
    for ax in live:
        if len(live) == 1:
            groups[ax] = group
            continue
        lines = np.moveaxis(grid, cfg.axis_order.index(ax), -1)
        for line in lines.reshape(-1, getattr(cfg, ax)):
            members = [global_ranks[int(i)] for i in line]
            if rank not in line:
                continue
            groups[ax] = dist.new_group(
                members, timeout=timedelta(seconds=timeout_s),
                backend=backend, use_local_synchronization=True)
    batch_group = group
    if cfg.tensor > 1 or cfg.seq > 1 or cfg.pipe > 1 or cfg.expert > 1:
        batch = [ax for ax in ("data", "fsdp") if getattr(cfg, ax) > 1]
        if not batch:
            batch_group = None
        elif len(batch) == 1:
            batch_group = groups[batch[0]]
        else:  # one group per index of the other axes: a data x fsdp plane
            planes = np.moveaxis(
                grid, [cfg.axis_order.index(ax) for ax in batch],
                [-2, -1])
            for plane in planes.reshape(-1, cfg.data * cfg.fsdp):
                if rank not in plane:
                    continue
                batch_group = dist.new_group(
                    [global_ranks[int(i)] for i in plane],
                    timeout=timedelta(seconds=timeout_s), backend=backend,
                    use_local_synchronization=True)
    dev = (torch.device(device) if device is not None
           else _default_device(cfg, rank, backend))
    return Mesh(cfg=cfg, rank=rank, coords=coords, group=group,
                groups=groups, device=dev, backend=backend,
                batch_group=batch_group)


def data_parallel_size(cfg: MeshConfig) -> int:
    """How many ways the batch is split (the reference's world size in the
    accumulation rule)."""
    return cfg.data * cfg.fsdp * cfg.expert


def batch_partition_spec(cfg: MeshConfig) -> tuple:
    """JAX's ``P(None, batch_axes, seq_axis)`` as a tuple: the [A, B, T]
    batch's B split over the batch axes of size > 1, T over seq."""
    axes = tuple(ax for ax in BATCH_AXES if getattr(cfg, ax) > 1) or None
    if axes is not None and len(axes) == 1:
        axes = axes[0]  # JAX's PartitionSpec spells one axis bare
    return (None, axes, "seq" if cfg.seq > 1 else None)


def batch_shard_index(mesh: Mesh) -> int:
    """This rank's shard of the batch dim: the batch axes' coordinates,
    first axis major (JAX's tiling of a dim over several mesh axes)."""
    idx = 0
    for ax in BATCH_AXES:
        idx = idx * mesh.axis_size(ax) + mesh.coords.get(ax, 0)
    return idx


def batch_rows(mesh: Mesh, global_rows: int) -> slice:
    """The rows of a global batch dim of ``global_rows`` this rank owns."""
    n = data_parallel_size(mesh.cfg)
    if global_rows % n:
        raise ValueError(f"global batch of {global_rows} rows does not "
                         f"split over {n} batch shards")
    per = global_rows // n
    i = batch_shard_index(mesh)
    return slice(i * per, (i + 1) * per)


def seq_cols(mesh: Mesh, global_len: int) -> slice:
    """The positions of a global sequence of ``global_len`` tokens this
    rank owns: rank i of the seq axis the i-th of ``seq`` equal spans."""
    n = mesh.cfg.seq
    if global_len % n:
        raise ValueError(f"sequence of {global_len} tokens does not split "
                         f"over seq={n}")
    per = global_len // n
    i = mesh.coords.get("seq", 0)
    return slice(i * per, (i + 1) * per)


def make_batch_put(mesh: Mesh):
    """``put(batch)``: a host {inputs, targets} batch of GLOBAL [A, B, T]
    arrays -> this rank's block as tensors on the mesh's device: its rows
    of B (the batch axes) and its span of T (the seq axis), JAX's
    ``P(None, batch_axes, "seq")``."""

    def put(batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            v = np.asarray(v)
            rows = batch_rows(mesh, v.shape[1])
            cols = seq_cols(mesh, v.shape[2])
            out[k] = torch.from_numpy(
                np.ascontiguousarray(v[:, rows, cols])).to(mesh.device)
        return out

    return put


def fold_batch_shard_key(key: DropoutKey, mesh: Mesh) -> DropoutKey:
    """The key of this rank's batch and sequence shard (module
    docstring): unchanged when neither is split."""
    if data_parallel_size(mesh.cfg) == 1 and mesh.cfg.seq == 1:
        return key
    idx = batch_shard_index(mesh) * mesh.cfg.seq + mesh.coords.get("seq", 0)
    return key._replace(shard=1 + idx)


def fold_tensor_key(key: DropoutKey, mesh: Mesh) -> DropoutKey:
    """Under tensor parallelism, the key whose attention masks are this
    tensor rank's own (``tensor`` = 1 + its tensor index; the JAX
    package's ``fold_in(k_attn, axis_index("tensor"))`` under
    ``tensor_dropout="folded"``); unchanged without a tensor axis."""
    if mesh.cfg.tensor == 1:
        return key
    return key._replace(tensor=1 + mesh.coords["tensor"])
