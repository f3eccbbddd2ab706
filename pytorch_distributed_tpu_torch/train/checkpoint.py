"""Checkpoint save and load in the npz format: the port of the JAX
package's ``train/checkpoint.py``, writing the JAX package's layout and
keys, so a checkpoint either side writes, the other resumes.

One ``arrays.npz`` holds the train state's leaves keyed by their JAX tree
path: the params through ``interop.params_to_jax`` (``params/wte``,
``params/blocks/attn/c_attn/kernel`` stacked [L, ...], ...), the optimizer
state as the JAX optax chain lays it out (``opt_state/1/count``,
``opt_state/1/mu/...``, ``opt_state/1/nu/...`` for ``scale_by_adam``,
``opt_state/3/count`` for the schedule; the chain's other elements hold no
arrays), and ``step``, counts as int32 scalars, and with the anomaly guard
``guard/ema`` (f32), ``guard/seen``, ``guard/consecutive``,
``guard/total`` and ``guard/trip`` (int32), the JAX ``GuardState``'s
names. The keys are built here without optax or JAX. A ``meta.json``
sidecar carries the caller's metadata (the step and the loader's
position). A checkpoint without guard leaves restores into a guarded
state with fresh counters (the run turned the guard on mid-life); guard
leaves restoring into an unguarded state are ignored, as in JAX.

**Integrity contract**, as in the JAX package: a save writes a per-leaf
crc32 ``manifest.json`` (meta.json's crc32 included) and a ``COMMIT``
marker inside a temporary directory that is renamed into place, the old
checkpoint parked in a ``.trash_`` sibling during the swap, so no crash
destroys both generations. ``list_checkpoints``/``latest_checkpoint``
return only committed directories, and ``load_checkpoint`` verifies the
manifest first and raises ``CheckpointCorrupt`` on a mismatch;
``Trainer.resume_latest`` then falls back to the next-older checkpoint.
``set_save_hook`` installs a host hook fired with ("pre_commit",
directory) the instant before a save becomes visible (the training fault
injector's crash inside a save).

**The async save** is the npz format's, on one rank (the JAX package's is
orbax's). ``save_checkpoint_async`` copies the
whole state to host memory before it returns — the next step overwrites
params and moments in place, so a thread reading live tensors would save
a later step's values — and writes the npz payload (and takes its
checksums) in a background thread into a ``.tmp_<name>`` sibling. The
save becomes visible — ``meta.json``, the manifest, ``COMMIT`` and the
atomic swap — only in ``finalize_async_save()``, which the next async
save calls first, so at most one save is in flight.
``pending_async_directory`` names its target; ``prune_checkpoints`` never
touches it or its temporary directory.

**Several ranks** (``train/distributed_trainer``; every rank calls save
and load, ``sharding`` the ``parallel/sharding.StateSharding`` of its
state). ``format="orbax"`` is the port's own sharded format, the
counterpart of JAX's orbax save: in ``tree/`` each rank of the first data
replica writes its blocks (``shard_<i>.npz``, i = f * tensor + t from its
fsdp and tensor indices; a leaf is written by the ranks at index 0 along
each axis it is not split over, so shard 0 holds the replicated leaves and
every tensor rank's slices are written; bf16 as its 16-bit payload) and
rank 0 an ``index.json`` with every leaf's global shape, dtype, fsdp dim
and the axis of each dim (``axes``), and the file grid;
after a barrier rank 0 writes meta.json, a per-file crc32 manifest and
``COMMIT`` and swaps the directory into place, as JAX's ``_save_orbax``
does, and every rank waits for the swap. A load rebuilds each leaf from
the shards and keeps the slice the template's sharding gives this rank,
so a state restores onto any fsdp and tensor size (saved at tensor 2, it
restores at tensor 1, and back). Under a pipe axis a stage holds only
its layers (``parallel/sharding.stage_state``): the files are laid out
over pipe x fsdp x tensor (shard i = (p * fsdp + f) * tensor + t), each
stage writes its own layers under their global ids, the leaves every
stage holds are written by stage 0 only, and ``index.json`` names each
layer's stage; a pipe-2 save restores at pipe 1 and back. Under an
expert axis the files are laid out over pipe x fsdp x expert x tensor
(shard i = ((p * fsdp + f) * expert + e) * tensor + t): each expert rank
writes its experts' blocks, a leaf not split over expert is written by
expert rank 0 only, and an expert-2 save restores on one rank. "npz" on
several ranks gathers the sharded leaves (and every stage's layers) and
only rank 0 writes; "auto" is "orbax" when a leaf
is sharded, else "npz". **A deliberate difference**: the port's sharded
directories and JAX's tensorstore ones do not load across (a JAX one is
refused by name); npz loads both ways. ``prune_checkpoints`` acts on
rank 0 only.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import shutil
import tempfile
import threading
import zlib
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.config import ModelConfig, TrainConfig
from pytorch_distributed_tpu_torch.train.guard import GuardState
from pytorch_distributed_tpu_torch.train.optim import make_optimizer
from pytorch_distributed_tpu_torch.train.state import (
    TrainState,
    init_train_state,
)
from pytorch_distributed_tpu_torch.utils import tree

COMMIT_NAME = "COMMIT"
MANIFEST_NAME = "manifest.json"
# The optax chain's element holding (count, mu, nu), and the schedule's.
_ADAM, _SCHEDULE = "opt_state/1", "opt_state/3"
_SHARDED_FORMAT = "pdtpu-torch-sharded-v2"
_JAX_ORBAX = ("is a JAX orbax (tensorstore) checkpoint: the port's sharded "
              "format (ROADMAP queue 1 item 7(a)) does not read it; write "
              "npz on the JAX side, which both packages load")


class CheckpointCorrupt(RuntimeError):
    """The checkpoint directory fails its integrity contract: missing
    COMMIT marker, missing/unreadable payload, or a checksum mismatch
    against its manifest."""


# Host hook fired with (stage, directory) the instant before a save becomes
# visible ("pre_commit"); the training fault injector (train/chaos) kills
# saves there. None in production.
_SAVE_HOOK: Callable[[str, Path], None] | None = None


def set_save_hook(hook: Callable[[str, Path], None] | None) -> None:
    global _SAVE_HOOK
    _SAVE_HOOK = hook


def _fire_save_hook(stage: str, directory: Path) -> None:
    if _SAVE_HOOK is not None:
        _SAVE_HOOK(stage, directory)


def _crc32(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def _flatten(prefix: str, nested, out: dict) -> None:
    """Leaves of a nested dict keyed ``prefix/a/b``, keys sorted at every
    level (the JAX tree flattening order)."""
    if isinstance(nested, dict):
        for k in sorted(nested):
            _flatten(f"{prefix}/{k}", nested[k], out)
    else:
        out[prefix] = np.asarray(nested)


def _unflatten(prefix: str, arrays: dict) -> dict:
    """The nested dict of every ``prefix/...`` key (the inverse of
    ``_flatten``)."""
    nested: dict = {}
    for key, a in arrays.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        node = nested
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return nested


def _state_arrays(state: TrainState, cfg: ModelConfig) -> dict:
    """The train state as the JAX checkpoint's {key: numpy array}, in the
    JAX flattening order."""
    opt = state.opt_state
    out: dict = {}
    _flatten("params", interop.params_to_jax(state.params, cfg), out)
    out[f"{_ADAM}/count"] = np.asarray(int(opt["count"]), np.int32)
    _flatten(f"{_ADAM}/mu", interop.params_to_jax(opt["mu"], cfg), out)
    _flatten(f"{_ADAM}/nu", interop.params_to_jax(opt["nu"], cfg), out)
    out[f"{_SCHEDULE}/count"] = np.asarray(int(opt["schedule_count"]),
                                           np.int32)
    out["step"] = np.asarray(int(state.step), np.int32)
    if state.guard is not None:
        for name, v in state.guard._asdict().items():
            out[f"guard/{name}"] = v.detach().cpu().numpy()
    return out


def _write_commit(tmp: Path) -> None:
    (tmp / COMMIT_NAME).write_text('{"format": "pdtpu-ckpt-commit-v1"}\n')


def _swap_into_place(tmp: Path, directory: Path) -> None:
    """Publish ``tmp`` as ``directory``: the previous generation is parked
    in a ``.trash_`` sibling for the swap (a crash between the two renames
    leaves the old data there, and no half directory at the final name)
    and removed after."""
    trash = directory.parent / (".trash_" + directory.name)
    if trash.exists():
        shutil.rmtree(trash)
    _fire_save_hook("pre_commit", directory)
    if directory.exists():
        os.replace(directory, trash)
    os.replace(tmp, directory)
    shutil.rmtree(trash, ignore_errors=True)


def _leaf_entries(arrays: dict) -> dict:
    return {k: {"crc32": _crc32(np.ascontiguousarray(a).tobytes()),
                "shape": list(a.shape), "dtype": str(a.dtype)}
            for k, a in arrays.items()}


def _meta_text(keys, metadata: dict | None) -> str:
    return json.dumps({"format": "pdtpu-ckpt-v1", "keys": sorted(keys),
                       "metadata": metadata or {}}, indent=1)


def _commit(tmp: Path, directory: Path, meta_text: str,
            leaves: dict) -> None:
    """meta.json, the manifest and COMMIT into ``tmp``, then the swap: the
    publishing tail of the sync save and of ``finalize_async_save``."""
    (tmp / "meta.json").write_text(meta_text)
    manifest = {"format": "pdtpu-ckpt-manifest-v1",
                "meta_crc32": _crc32(meta_text.encode()), "leaves": leaves}
    (tmp / MANIFEST_NAME).write_text(json.dumps(manifest, indent=1))
    _write_commit(tmp)
    _swap_into_place(tmp, directory)


def _rank_world() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier() -> None:
    import torch.distributed as dist

    if _rank_world()[1] > 1:
        dist.barrier()


def _is_sharded(sharding) -> bool:
    """Whether ``sharding`` splits any leaf (over fsdp, expert or tensor,
    or the layers over pipe stages)."""
    from pytorch_distributed_tpu_torch.parallel.sharding import sharded_axes

    if sharding is None:
        return False
    return sharding.mesh.axis_size("pipe") > 1 or any(
        sharded_axes(s)
        for s in tree.leaves([sharding.params, sharding.opt_state]))


def _offset(state: TrainState, sharding) -> int:
    """The global id of ``state``'s first layer (a pipeline stage's)."""
    from pytorch_distributed_tpu_torch.parallel.sharding import stage_range

    mesh = sharding and sharding.mesh
    n_stages = 1 if mesh is None else mesh.axis_size("pipe")
    return stage_range(len(state.params["blocks"]) * n_stages, mesh).start


def _global(path: tuple, offset: int) -> tuple:
    """A port tree path with a block's local layer index made global."""
    if offset and len(path) > 1 and path[0] == "blocks":
        return ("blocks", path[1] + offset, *path[2:])
    return path


def save_checkpoint(directory: str | Path, state: TrainState,
                    cfg: ModelConfig, *, metadata: dict | None = None,
                    format: str = "auto", sharding=None) -> str:
    """Write ``state`` (the port's TrainState of a ``cfg`` model): "npz",
    the JAX package's npz layout, or "orbax", the port's sharded format
    (module docstring); "auto" picks "orbax" when ``sharding`` shards a
    leaf. On several ranks every rank calls it."""
    if format not in ("auto", "npz", "orbax"):
        raise ValueError(f"unknown checkpoint format {format!r}")
    if format == "orbax" or (format == "auto" and _is_sharded(sharding)):
        return _save_sharded(Path(directory), state, cfg, metadata,
                             sharding)
    directory = Path(directory)
    if _is_sharded(sharding):
        state = gather_state(state, sharding)
    if _rank_world()[0] != 0:
        _barrier()  # npz has one writer: wait for it
        return str(directory)
    os.makedirs(directory.parent, exist_ok=True)
    arrays = _state_arrays(state, cfg)
    tmp = Path(tempfile.mkdtemp(dir=directory.parent, prefix=".ckpt_tmp_"))
    try:
        np.savez(tmp / "arrays.npz", **arrays)
        _commit(tmp, directory, _meta_text(arrays, metadata),
                _leaf_entries(arrays))
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _barrier()
    return str(directory)


def gather_state(state: TrainState, sharding) -> TrainState:
    """The full train state on every rank: each sharded leaf all-gathered
    over the fsdp group, then over the expert and tensor groups, and
    every stage's layers over the pipe group (every rank calls it)."""
    from pytorch_distributed_tpu_torch.parallel.zero import (
        unshard,
        unstage_blocks,
    )

    mesh = sharding.mesh

    def whole(t, specs):
        t = tree.map_tree2(lambda x, s: unshard(x, s, mesh), t, specs)
        return dict(t, blocks=unstage_blocks(t["blocks"], mesh))

    with torch.no_grad():
        params = whole(state.params, sharding.params)
        opt = dict(state.opt_state)
        for k in ("mu", "nu"):
            opt[k] = whole(opt[k], sharding.opt_state[k])
    return state._replace(params=params, opt_state=opt)


def _sharded_leaves(state: TrainState, sharding):
    """(key, tensor or count, spec) for every leaf of the state, keyed by
    the port's own tree paths, a block's by its global layer id."""
    offset = _offset(state, sharding)
    specs = sharding.params if sharding is not None else None
    for path, t in tree.leaves_with_path(state.params):
        yield ("/".join(map(str, ("params", *_global(path, offset)))), t,
               _spec_at(specs, path))
    opt = state.opt_state
    for k in ("mu", "nu"):
        specs = sharding.opt_state[k] if sharding is not None else None
        for path, t in tree.leaves_with_path(opt[k]):
            yield ("/".join(map(str, ("opt_state", k,
                                      *_global(path, offset)))), t,
                   _spec_at(specs, path))
    for k in ("count", "schedule_count"):
        yield f"opt_state/{k}", opt[k], ()
    yield "step", state.step, ()
    if state.guard is not None:
        for name, v in state.guard._asdict().items():
            yield f"guard/{name}", v, ()


def _spec_at(specs, path) -> tuple:
    if specs is None:
        return ()
    for p in path:
        specs = specs[p]
    return specs


def _payload(v) -> tuple[np.ndarray, str]:
    """A leaf as a numpy array and its dtype's name (bf16 as its 16-bit
    payload; counts as int32)."""
    if not torch.is_tensor(v):
        return np.asarray(int(v), np.int32), "int32"
    v = v.detach().cpu()
    name = str(v.dtype).replace("torch.", "")
    if v.dtype == torch.bfloat16:
        v = v.view(torch.int16)
    return np.ascontiguousarray(v.numpy()), name


# The mesh axes a sharded save lays its files out over, major first: file
# i holds the blocks of the grid point whose row-major index is i. An axis
# an index leaves out has size 1 (older saves name no expert axis).
_FILE_AXES = ("pipe", "fsdp", "expert", "tensor")


def _file_index(at: dict, grid: dict) -> int:
    i = 0
    for ax in _FILE_AXES:
        i = i * grid.get(ax, 1) + at.get(ax, 0)
    return i


def _stage_key(key: str) -> bool:
    """Whether ``key`` is a block leaf's (a pipeline stage's own)."""
    parts = key.split("/")
    return "blocks" in parts[:3]


def _save_sharded(directory: Path, state: TrainState, cfg: ModelConfig,
                  metadata: dict | None, sharding) -> str:
    """The port's sharded format (module docstring); every rank calls."""
    from pytorch_distributed_tpu_torch.parallel.sharding import (
        full_shape,
        shard_dim,
    )

    rank, _ = _rank_world()
    mesh = sharding.mesh if sharding is not None else None
    grid = {ax: mesh.axis_size(ax) if mesh is not None else 1
            for ax in _FILE_AXES}
    at = {ax: mesh.axis_index(ax) if mesh is not None else 0
          for ax in _FILE_AXES}
    writer = mesh is None or all(
        i == 0 for ax, i in mesh.coords.items() if ax not in _FILE_AXES)
    file_i = _file_index(at, grid)
    n_local = len(state.params["blocks"])
    directory = directory.resolve()
    tmp = directory.parent / (".tmp_" + directory.name)
    if rank == 0:
        if tmp.exists():
            shutil.rmtree(tmp)
        (tmp / "tree").mkdir(parents=True)
    _barrier()
    try:
        if writer:
            arrays, index = {}, {}
            for key, v, spec in _sharded_leaves(state, sharding):
                # One holder a block: index 0 along each axis the leaf is
                # not split over (a block leaf is split over pipe).
                split = set(spec) | ({"pipe"} if _stage_key(key) else set())
                if any(at[ax] for ax in _FILE_AXES if ax not in split):
                    continue
                arrays[key], dtype = _payload(v)
                shape = (full_shape(v, spec, mesh.cfg) if mesh is not None
                         else tuple(v.shape)) if torch.is_tensor(v) else ()
                entry = {"shape": list(shape), "dtype": dtype,
                         "dim": shard_dim(spec) if spec else None,
                         "axes": list(spec) if spec else None}
                if grid["pipe"] > 1 and _stage_key(key):
                    # Every stage's layers are shaped alike: file 0's
                    # writer (stage 0) indexes each stage's under its ids.
                    parts = key.split("/")
                    i = parts.index("blocks") + 1
                    layer = int(parts[i])
                    for s in range(grid["pipe"]):
                        parts[i] = str(layer + s * n_local)
                        index["/".join(parts)] = dict(entry, pipe=s)
                else:
                    index[key] = entry
            np.savez(tmp / "tree" / f"shard_{file_i}.npz", **arrays)
            if file_i == 0:
                (tmp / "tree" / "index.json").write_text(json.dumps(
                    {"format": _SHARDED_FORMAT,
                     "shards": math.prod(grid.values()),
                     # pipe and expert named only when they split: an
                     # index without one reads it as 1
                     "grid": {ax: n for ax, n in grid.items()
                              if ax not in ("pipe", "expert") or n > 1},
                     "leaves": index}, indent=1))
        _barrier()  # every shard written
        if rank == 0:
            _commit_sharded(tmp, directory, metadata or {})
    except BaseException:
        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
        raise
    _barrier()  # the swap is done before any rank uses the path
    return str(directory)


def _assemble(files: list, grid: dict, key: str, entry: dict) -> np.ndarray:
    """A leaf of the sharded format whole: its blocks from the files of
    the grid points along the axes it is split over (fsdp, expert,
    tensor), in its stage's files (``entry["pipe"]``), each put at its
    place along its dims."""
    pipe = entry.get("pipe", 0)
    axes = entry.get("axes")
    if axes is None and entry.get("dim") is not None:  # fsdp alone
        axes = [None] * len(entry["shape"])
        axes[entry["dim"]] = "fsdp"
    if not axes:
        return files[_file_index(dict(pipe=pipe), grid)][key]
    split = [ax for ax in _FILE_AXES[1:] if ax in axes]
    full = None
    for point in itertools.product(*(range(grid.get(ax, 1))
                                     for ax in split)):
        at = dict(zip(split, point), pipe=pipe)
        block = files[_file_index(at, grid)][key]
        if full is None:
            full = np.empty(entry["shape"], block.dtype)
        full[tuple(slice(None) if ax is None else
                   slice(at[ax] * n, (at[ax] + 1) * n)
                   for ax, n in zip(axes, block.shape))] = block
    return full


def _file_crcs(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): _crc32(p.read_bytes())
            for p in sorted(root.rglob("*")) if p.is_file()}


def _commit_sharded(tmp: Path, directory: Path, metadata: dict) -> None:
    meta_text = json.dumps({"format": _SHARDED_FORMAT,
                            "metadata": metadata}, indent=1)
    (tmp / "meta.json").write_text(meta_text)
    (tmp / MANIFEST_NAME).write_text(json.dumps(
        {"format": "pdtpu-ckpt-manifest-v1",
         "meta_crc32": _crc32(meta_text.encode()),
         "files": _file_crcs(tmp / "tree")}, indent=1))
    _write_commit(tmp)
    _swap_into_place(tmp, directory)


# The one async save in flight (module-level, as the JAX package's: the
# trainer treats checkpointing as a process-wide side effect).
_PENDING_ASYNC: dict | None = None


def pending_async_directory() -> Path | None:
    """The target directory of the async save in flight, if any (so
    ``prune_checkpoints`` can never race it)."""
    return None if _PENDING_ASYNC is None else _PENDING_ASYNC["directory"]


def _write_payload(pend: dict) -> None:
    """The background thread: the npz payload and its checksums."""
    try:
        arrays = pend.pop("arrays")
        np.savez(pend["tmp"] / "arrays.npz", **arrays)
        pend["leaves"] = _leaf_entries(arrays)
    except BaseException as e:  # re-raised by finalize_async_save
        pend["error"] = e


def save_checkpoint_async(directory: str | Path, state: TrainState,
                          cfg: ModelConfig, *,
                          metadata: dict | None = None) -> str:
    """Start an npz save that overlaps training: finalize the save in
    flight, copy ``state`` to host memory (before returning: the caller's
    next step may overwrite it in place), then write the payload in a
    background thread. The checkpoint becomes visible only at
    ``finalize_async_save()``."""
    global _PENDING_ASYNC
    if _rank_world()[1] > 1:
        raise NotImplementedError(
            "the async save writes from one rank; on several ranks use the "
            "sync save (format 'orbax' or 'npz')")
    finalize_async_save()
    directory = Path(directory).resolve()
    directory.parent.mkdir(parents=True, exist_ok=True)
    tmp = directory.parent / (".tmp_" + directory.name)
    if tmp.exists():
        shutil.rmtree(tmp)
    arrays = _state_arrays(state, cfg)  # the host snapshot
    if tree.leaves(state.params)[0].device.type == "cpu":
        # .cpu() of a host tensor is that tensor: its numpy view would
        # follow the next step's in-place update.
        arrays = {k: np.array(a, copy=True) for k, a in arrays.items()}
    tmp.mkdir()
    pend = {"directory": directory, "tmp": tmp,
            "meta_text": _meta_text(arrays, metadata), "arrays": arrays}
    pend["thread"] = threading.Thread(target=_write_payload, args=(pend,),
                                      name="ckpt-async", daemon=True)
    pend["thread"].start()
    _PENDING_ASYNC = pend
    return str(directory)


def finalize_async_save() -> str | None:
    """Wait for the async save in flight (if any) to write its payload,
    then publish it: meta.json, manifest, COMMIT, the atomic swap. Returns
    its path (None when no save is in flight). Call it before another
    save, before reading the newest checkpoint, and before exit; the
    Trainer does."""
    global _PENDING_ASYNC
    if _PENDING_ASYNC is None:
        return None
    pend, _PENDING_ASYNC = _PENDING_ASYNC, None
    pend["thread"].join()
    tmp, directory = pend["tmp"], pend["directory"]
    try:
        if "error" in pend:
            raise pend["error"]
        _commit(tmp, directory, pend["meta_text"], pend["leaves"])
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return str(directory)


def is_committed(directory: str | Path) -> bool:
    return (Path(directory) / COMMIT_NAME).is_file()


def _load_manifest(directory: Path) -> dict:
    """COMMIT + manifest + meta.json checks (the cheap, non-payload part
    of verification); returns the parsed manifest."""
    if not is_committed(directory):
        raise CheckpointCorrupt(
            f"checkpoint {directory} has no {COMMIT_NAME} marker "
            "(half-written save or pre-integrity format)"
        )
    try:
        manifest = json.loads((directory / MANIFEST_NAME).read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorrupt(
            f"checkpoint {directory}: unreadable {MANIFEST_NAME}: {e}"
        ) from e
    want_meta = manifest.get("meta_crc32")
    if want_meta is not None:
        try:
            meta_bytes = (directory / "meta.json").read_bytes()
        except OSError as e:
            raise CheckpointCorrupt(
                f"checkpoint {directory}: unreadable meta.json: {e}"
            ) from e
        got = _crc32(meta_bytes)
        if got != want_meta:
            raise CheckpointCorrupt(
                f"checkpoint {directory}: meta.json checksum mismatch "
                f"(manifest {want_meta}, file {got}) — the loader "
                "position would be untrustworthy"
            )
    return manifest


def _load_npz_arrays(directory: Path) -> dict:
    try:
        with np.load(directory / "arrays.npz") as data:
            return {k: data[k] for k in data.files}
    except Exception as e:  # zip/format damage surfaces many ways
        raise CheckpointCorrupt(
            f"checkpoint {directory}: unreadable arrays.npz: {e}"
        ) from e


def _verify_npz_leaves(directory: Path, manifest: dict, arrays: dict) -> None:
    for key, want in manifest["leaves"].items():
        if key not in arrays:
            raise CheckpointCorrupt(
                f"checkpoint {directory}: leaf {key!r} missing from "
                "arrays.npz"
            )
        got = _crc32(np.ascontiguousarray(arrays[key]).tobytes())
        if got != want["crc32"]:
            raise CheckpointCorrupt(
                f"checkpoint {directory}: leaf {key!r} checksum "
                f"mismatch (manifest {want['crc32']}, file {got})"
            )


def verify_checkpoint(directory: str | Path) -> None:
    """Integrity check without a restore: COMMIT present, manifest present,
    meta.json and every leaf (npz) or file (sharded) checksum matching.
    Raises ``CheckpointCorrupt`` naming the first offending leaf or file."""
    directory = Path(directory)
    if _is_sharded_dir(directory):
        _verify_files(directory, _load_manifest(directory))
        return
    manifest = _load_manifest(directory)
    _verify_npz_leaves(directory, manifest, _load_npz_arrays(directory))


def _is_sharded_dir(directory: Path) -> bool:
    """A ``tree/`` directory: the port's sharded format, or JAX's
    tensorstore one (refused)."""
    if not (directory / "tree").exists():
        return False
    if not (directory / "tree" / "index.json").exists():
        raise NotImplementedError(f"{directory} {_JAX_ORBAX}")
    return True


def _verify_files(directory: Path, manifest: dict) -> None:
    want = manifest.get("files", {})
    got = _file_crcs(directory / "tree")
    for name, crc in want.items():
        if got.get(name) != crc:
            raise CheckpointCorrupt(
                f"checkpoint {directory}: file tree/{name} "
                + ("missing" if name not in got else
                   f"checksum mismatch (manifest {crc}, file {got[name]})"))


def _restore_like(key: str, got: torch.Tensor, like: torch.Tensor):
    if tuple(got.shape) != tuple(like.shape):
        raise ValueError(
            f"checkpoint leaf {key!r} shape {tuple(got.shape)} != expected "
            f"{tuple(like.shape)}"
        )
    if like.dtype == torch.bfloat16 and got.dtype in (torch.uint16,
                                                      torch.int16):
        got = got.view(torch.bfloat16)  # a raw bf16 payload
    return got.to(like.device, like.dtype)


def _restore_tree(prefix: str, arrays: dict, like_tree, cfg: ModelConfig,
                  specs=None, mesh=None, offset: int = 0):
    """A port params-shaped tree from the ``prefix/...`` keys, each leaf
    placed and typed like ``like_tree``'s (with ``specs``: this rank's
    slice of it; ``offset``: the global id of ``like_tree``'s first
    layer, a pipeline stage's)."""
    try:
        got = interop.params_from_jax(_unflatten(prefix, arrays), cfg)
    except KeyError as e:
        raise KeyError(f"checkpoint missing leaf {prefix}/{e.args[0]}; has "
                       f"{len(arrays)} leaves") from e
    by_path = dict(tree.leaves_with_path(got))
    out = []
    for path, like in tree.leaves_with_path(like_tree):
        gpath = _global(path, offset)
        key = "/".join(map(str, (prefix, *gpath)))
        if gpath not in by_path:
            raise KeyError(f"checkpoint missing leaf {key!r}; has "
                           f"{len(arrays)} leaves")
        got_leaf = by_path[gpath]
        if specs is not None:
            from pytorch_distributed_tpu_torch.parallel.sharding import (
                shard_slice,
            )

            got_leaf = shard_slice(got_leaf, _spec_at(specs, path), mesh)
        out.append(_restore_like(key, got_leaf, like))
    return tree.unflatten(like_tree, out)


def load_checkpoint(directory: str | Path, like: TrainState,
                    cfg: ModelConfig, *, sharding=None) -> TrainState:
    """Restore a checkpoint (npz from either package, or the port's
    sharded format) into the structure, dtypes and devices of ``like`` (a
    port TrainState, e.g. a fresh ``Trainer.init_state()``; with
    ``sharding``, a sharded one, and each rank keeps its slices). The
    integrity manifest is checked first (``CheckpointCorrupt`` on damage);
    the npz payload is read once, and the checksums are taken on the
    arrays the restore uses."""
    directory = Path(directory)
    if _is_sharded_dir(directory):
        return _load_sharded(directory, like, sharding)
    manifest = _load_manifest(directory)
    arrays = _load_npz_arrays(directory)
    _verify_npz_leaves(directory, manifest, arrays)
    for key in (f"{_ADAM}/count", f"{_SCHEDULE}/count", "step"):
        if key not in arrays:
            raise KeyError(f"checkpoint {directory} missing leaf {key!r}; "
                           f"has {len(arrays)} leaves")
    opt = like.opt_state
    sh = sharding if _is_sharded(sharding) else None
    mesh = sh.mesh if sh is not None else None
    off = _offset(like, sh)
    return TrainState(
        params=_restore_tree("params", arrays, like.params, cfg,
                             sh and sh.params, mesh, off),
        opt_state=dict(
            opt,
            count=_restore_count(arrays[f"{_ADAM}/count"], opt["count"]),
            mu=_restore_tree(f"{_ADAM}/mu", arrays, opt["mu"], cfg,
                             sh and sh.opt_state["mu"], mesh, off),
            nu=_restore_tree(f"{_ADAM}/nu", arrays, opt["nu"], cfg,
                             sh and sh.opt_state["nu"], mesh, off),
            schedule_count=_restore_count(arrays[f"{_SCHEDULE}/count"],
                                          opt["schedule_count"]),
        ),
        step=int(arrays["step"]),
        guard=_restore_guard(arrays, like.guard),
    )


def _load_sharded(directory: Path, like: TrainState,
                  sharding) -> TrainState:
    """The port's sharded format into ``like``: each leaf rebuilt from its
    shards, this rank's slice kept (``sharding`` None: the whole leaf)."""
    from pytorch_distributed_tpu_torch.parallel.sharding import (
        full_shape,
        shard_slice,
    )

    _verify_files(directory, _load_manifest(directory))
    index = json.loads((directory / "tree" / "index.json").read_text())
    files = [np.load(directory / "tree" / f"shard_{i}.npz")
             for i in range(index["shards"])]
    grid = index.get("grid", {"fsdp": index["shards"], "tensor": 1})
    mesh = sharding.mesh if sharding is not None else None
    try:
        def read(key):
            entry = index["leaves"].get(key)
            if entry is None:
                raise KeyError(f"checkpoint {directory} missing leaf "
                               f"{key!r}")
            a = _assemble(files, grid, key, entry)
            t = torch.from_numpy(np.array(a))
            if entry["dtype"] == "bfloat16":
                t = t.view(torch.bfloat16)
            return t, entry

        out = {}
        for key, v, spec in _sharded_leaves(like, sharding):
            got, entry = read(key)
            if not torch.is_tensor(v):
                out[key] = int(got)
                continue
            want = (full_shape(v, spec, mesh.cfg) if mesh is not None
                    else tuple(v.shape))
            if tuple(entry["shape"]) != want:
                raise ValueError(f"checkpoint leaf {key!r} shape "
                                 f"{tuple(entry['shape'])} != expected "
                                 f"{want}")
            if mesh is not None:
                got = shard_slice(got, spec, mesh)
            out[key] = _restore_like(key, got, v)
    finally:
        for f in files:
            f.close()
    guard = like.guard
    if guard is not None and all(f"guard/{k}" in out
                                 for k in guard._fields):
        guard = GuardState(**{k: out[f"guard/{k}"] for k in guard._fields})

    offset = _offset(like, sharding)

    def rebuilt(prefix, like_tree):
        return tree.map_tree_with_path(
            lambda path, _: out["/".join(map(
                str, (prefix, *_global(path, offset))))], like_tree)

    opt = like.opt_state
    return TrainState(
        params=rebuilt("params", like.params),
        opt_state=dict(
            opt,
            count=_restore_count(out["opt_state/count"], opt["count"]),
            mu=rebuilt("opt_state/mu", opt["mu"]),
            nu=rebuilt("opt_state/nu", opt["nu"]),
            schedule_count=_restore_count(out["opt_state/schedule_count"],
                                          opt["schedule_count"])),
        step=int(out["step"]),
        guard=guard)


def _restore_count(got: np.ndarray, like):
    """A count like the template's: a Python int, or (guarded state) a 0-d
    int32 tensor on the template's device."""
    if torch.is_tensor(like):
        return torch.tensor(int(got), dtype=like.dtype, device=like.device)
    return int(got)


def _restore_guard(arrays: dict, like: GuardState | None):
    """The guard leaves into a guarded template; a checkpoint written
    without them keeps the template's fresh values (JAX's pre-guard
    upgrade path). An unguarded template takes no guard."""
    if like is None:
        return None
    fields = like._asdict()
    if not all(f"guard/{k}" in arrays for k in fields):
        return like
    return GuardState(**{
        k: _restore_like(f"guard/{k}",
                         torch.from_numpy(np.array(arrays[f"guard/{k}"])), v)
        for k, v in fields.items()})


def load_params_checkpoint(directory: str | Path, params,
                           cfg: ModelConfig):
    """The params of a checkpoint, restored into the structure, dtypes and
    devices of ``params`` (the generation and serving twins' weights;
    the optimizer state that ``load_checkpoint`` restores with them is
    dropped)."""
    tx = make_optimizer(TrainConfig(
        global_batch_size=1, micro_batch_size=1, num_steps=1,
        learning_rate=1e-4,
    ))
    like = init_train_state(params, tx)
    return load_checkpoint(directory, like, cfg).params


def read_metadata(directory: str | Path) -> dict:
    meta = json.loads((Path(directory) / "meta.json").read_text())
    return meta.get("metadata", {})


def _step_dirs(root: Path) -> list[tuple[int, Path]]:
    steps: list[tuple[int, Path]] = []
    for child in root.iterdir():
        if child.is_dir() and child.name.startswith("checkpoint_step_"):
            try:
                steps.append((int(child.name.rsplit("_", 1)[1]), child))
            except ValueError:
                continue
    return steps


def _step_dirs_by_commit(checkpoint_root: str | Path, *,
                         committed: bool) -> list[str]:
    root = Path(checkpoint_root)
    if not root.exists():
        return []
    steps = [(s, p) for s, p in _step_dirs(root)
             if is_committed(p) == committed]
    steps.sort(reverse=True)
    return [str(p) for _, p in steps]


def list_checkpoints(checkpoint_root: str | Path) -> list[str]:
    """COMMITTED ``checkpoint_step_{n}`` dirs, newest first — the fallback
    order ``Trainer.resume_latest`` walks when the newest one fails
    verification."""
    return _step_dirs_by_commit(checkpoint_root, committed=True)


def uncommitted_checkpoints(checkpoint_root: str | Path) -> list[str]:
    """``checkpoint_step_{n}`` dirs WITHOUT a COMMIT marker: half-written
    saves. Never resumable; surfaced so ``Trainer.resume_latest`` can warn
    instead of silently restarting from scratch next to them."""
    return _step_dirs_by_commit(checkpoint_root, committed=False)


def prune_checkpoints(checkpoint_root: str | Path, keep: int) -> list[str]:
    """Delete all but the newest ``keep`` ``checkpoint_step_{n}`` dirs, and
    sweep ``.trash_`` leftovers of a swap and temporary save dirs orphaned
    by a crash mid-save. Call after a completed save. Never touches the
    target of the async save in flight (``pending_async_directory``) or
    its ``.tmp_`` dir. Acts on rank 0 only. Returns the removed paths."""
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    if _rank_world()[0] != 0:
        return []  # rank 0 prunes, after the save's barriers
    root = Path(checkpoint_root)
    if not root.exists():
        return []
    pending = pending_async_directory()
    pending_tmp = None if pending is None else ".tmp_" + pending.name
    for child in root.iterdir():
        if child.is_dir() and child.name != pending_tmp and \
                child.name.startswith((".trash_", ".ckpt_tmp_", ".tmp_")):
            shutil.rmtree(child, ignore_errors=True)
    steps = sorted(((s, p) for s, p in _step_dirs(root)
                    if pending is None or p.resolve() != pending),
                   reverse=True)
    removed = []
    for _, path in steps[keep:]:
        shutil.rmtree(path, ignore_errors=True)
        removed.append(str(path))
    return removed


def latest_checkpoint(checkpoint_root: str | Path) -> str | None:
    """The newest COMMITTED ``checkpoint_step_{n}`` dir; half-written
    directories (no COMMIT marker) are never returned."""
    newest = list_checkpoints(checkpoint_root)
    return newest[0] if newest else None
