"""The port's launcher leaves no process behind (``parallel/mesh``).

CPU only, no card, no JAX: plain Python children that sleep.

- ``run`` with a 2 s limit on a child that started a sleeping grandchild:
  both are gone afterwards (the child's whole process group is killed).
- ``spawn_ranks`` with a rank that exits 1: its sleeping peer is killed
  within a few seconds and the launcher returns nonzero.
- A launcher process (``install_exit_handlers``, as ``chip_smoke.py``
  installs them) sent SIGTERM: its ranks are gone, killed by its handler
  (these ranks do not bind themselves to their parent).
- A launcher sent SIGKILL, which runs no handler: its ranks are gone,
  killed by the kernel through ``bind_to_parent``'s parent-death signal.

A zombie (state Z in ``/proc/<pid>/stat``: dead, not yet reaped by
whoever adopted it) counts as gone.
"""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from pytorch_distributed_tpu_torch.parallel import mesh

ROOT = Path(__file__).resolve().parents[1]
# A rank: writes its pid, then exits 1 if it is the failing rank, else
# sleeps; binds itself to its parent when asked.
RANK_MODULE = """
import os, sys, time
from pathlib import Path
if os.environ.get("TEST_BIND") == "1":
    from pytorch_distributed_tpu_torch.parallel.mesh import bind_to_parent
    bind_to_parent()
rank = int(os.environ["RANK"])
(Path(sys.argv[1]) / f"pid_{rank}").write_text(str(os.getpid()))
if rank == int(os.environ.get("TEST_FAIL_RANK", "-1")):
    time.sleep(0.5)
    sys.exit(1)
time.sleep(120)
"""

pytestmark = pytest.mark.skipif(not sys.platform.startswith("linux"),
                                reason="reads /proc and uses prctl")


def _gone(pid: int) -> bool:
    try:
        stat = Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return True
    return stat.rsplit(")", 1)[1].split()[0] in ("Z", "X")


def _wait_gone(pids, limit_s: float) -> list:
    end = time.monotonic() + limit_s
    while time.monotonic() < end:
        left = [p for p in pids if not _gone(p)]
        if not left:
            return []
        time.sleep(0.05)
    return [p for p in pids if not _gone(p)]


def _pids(out: Path, n: int, limit_s: float = 60.0) -> list:
    end = time.monotonic() + limit_s
    while time.monotonic() < end:
        files = [out / f"pid_{r}" for r in range(n)]
        if all(f.exists() and f.read_text() for f in files):
            return [int(f.read_text()) for f in files]
        time.sleep(0.05)
    raise AssertionError(f"the ranks did not start in {limit_s} s")


@pytest.fixture
def rank_env(tmp_path, monkeypatch):
    (tmp_path / "rankmod.py").write_text(RANK_MODULE)
    out = tmp_path / "out"
    out.mkdir()
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(tmp_path), str(ROOT), os.environ.get("PYTHONPATH", "")]))
    return out


def test_run_timeout_kills_the_child_and_its_grandchild(tmp_path):
    pid_file = tmp_path / "grandchild"
    code = ("import subprocess, sys, time, pathlib\n"
            "p = subprocess.Popen([sys.executable, '-c', "
            "'import time; time.sleep(120)'])\n"
            "pathlib.Path(sys.argv[1]).write_text(str(p.pid))\n"
            "time.sleep(120)\n")
    t0 = time.monotonic()
    with pytest.raises(subprocess.TimeoutExpired):
        mesh.run([sys.executable, "-c", code, str(pid_file)], timeout=2)
    assert time.monotonic() - t0 < 10
    grandchild = int(pid_file.read_text())
    assert _wait_gone([grandchild], 5) == []
    assert not mesh.registered()


def test_failed_rank_ends_its_peer(rank_env, monkeypatch):
    monkeypatch.setenv("TEST_FAIL_RANK", "1")
    t0 = time.monotonic()
    rc = mesh.spawn_ranks(2, "rankmod", [str(rank_env)])
    took = time.monotonic() - t0
    assert rc != 0
    assert took < 30, f"the peer was not ended at once ({took:.1f} s)"
    assert _wait_gone(_pids(rank_env, 2, 1), 5) == []


def _launcher(rank_env, handlers: bool) -> subprocess.Popen:
    code = ("import sys\n"
            "from pytorch_distributed_tpu_torch.parallel import mesh\n"
            + ("mesh.install_exit_handlers('launcher')\n" if handlers
               else "")
            + f"sys.exit(mesh.spawn_ranks(2, 'rankmod', [{str(rank_env)!r}]))\n")
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)


def test_sigterm_to_the_launcher_ends_its_ranks(rank_env, monkeypatch):
    monkeypatch.setenv("TEST_BIND", "0")  # only the handler can end them
    proc = _launcher(rank_env, handlers=True)
    try:
        ranks = _pids(rank_env, 2)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=30)
        assert proc.returncode == 128 + signal.SIGTERM, err
        assert "ended by signal" in err
        assert _wait_gone(ranks, 10) == []
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_sigkill_to_the_launcher_ends_its_ranks(rank_env, monkeypatch):
    monkeypatch.setenv("TEST_BIND", "1")  # the parent-death signal
    proc = _launcher(rank_env, handlers=False)
    try:
        ranks = _pids(rank_env, 2)
        proc.kill()
        proc.wait(timeout=30)
        assert _wait_gone(ranks, 10) == []
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_live_descendants_lists_a_launched_child_until_killed():
    proc = mesh.launch([sys.executable, "-c", "import time; time.sleep(120)"])
    try:
        assert proc.pid in [p for p, _ in mesh.live_descendants()]
    finally:
        mesh.kill_group(proc)
    assert proc.pid not in [p for p, _ in mesh.live_descendants()]
    assert proc.returncode == -signal.SIGKILL


def test_bind_to_parent_is_a_noop_outside_the_launcher(monkeypatch):
    monkeypatch.delenv(mesh.PARENT_PID_ENV, raising=False)
    mesh.bind_to_parent()  # no prctl, no exit
