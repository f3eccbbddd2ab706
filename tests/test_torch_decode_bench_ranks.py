"""The ``decode_bench`` twin's multi-rank sub-legs on two gloo CPU ranks,
and the limit of the port's rank launcher.

- ``--serving --serving-spec --rank-legs only --cpu-devices 2 --dryrun``:
  the twin starts its two ranks through ``parallel/mesh.spawn_ranks``;
  ``serving_spec_tp``'s plain and speculative TP engines give n/n
  outputs equal and no steady loads; the ``zero3_decode`` row at
  ``prefetch_buffers=0`` carries the JAX leg's fields, its hidden
  communication share null over gloo (no device kernel to see), with the
  reason; the ``prefetch_buffers=1`` side is skipped, naming item 7(d).
  Neither sub-leg's old skip line (item 4c) is printed.
- The one-process modes at ``--device cpu`` alone skip both sub-legs,
  saying why (one device).
- ``spawn_ranks`` ends two ranks that wait on each other forever (each
  receives from the other, and neither sends) at ``SPAWN_LIMIT_S``: it
  returns 124 and no rank is left; its ranks join their group with
  ``RANK_TIMEOUT_S``.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

from pytorch_distributed_tpu_torch.parallel import mesh
from pytorch_distributed_tpu_torch.serving import decode_bench

ROOT = Path(__file__).resolve().parents[1]
# A rank of a gloo group of two that waits for a message its peer never
# sends: it writes its pid, then blocks in recv.
HUNG_RANK = """
import os, sys
from pathlib import Path
import torch, torch.distributed as dist
from pytorch_distributed_tpu_torch.parallel.mesh import (
    bind_to_parent, initialize_distributed)
bind_to_parent()
initialize_distributed(device="cpu")
rank = dist.get_rank()
(Path(sys.argv[1]) / f"pid_{rank}").write_text(str(os.getpid()))
dist.recv(torch.zeros(1), src=1 - rank)
"""


def test_rank_legs_on_two_cpu_ranks(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_tpu_torch.serving."
         "decode_bench", "--serving", "--serving-spec", "--rank-legs",
         "only", "--cpu-devices", "2", "--dryrun"],
        cwd=tmp_path, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = [json.loads(x) for x in proc.stdout.splitlines()
            if x.startswith("{")]
    assert [r["leg"] for r in rows] == ["zero3_decode", "serving_spec_tp"]
    zero3, tp = rows
    assert tp["outputs_match"] == f"{tp['requests']}/{tp['requests']}"
    assert tp["requests"] == 4 and tp["mesh"] == "tensor=2"
    assert tp["observed_compile_count_steady"] == 0
    assert tp["invariant_failures"] == []
    assert {"plain_tokens_per_sec_span_s", "spec_tokens_per_sec_span_s",
            "aggregate_speedup", "spec_accept_rate"} <= set(tp)
    assert "roofline" not in tp
    assert zero3["prefetch_buffers"] == 0 and zero3["fsdp"] == 2
    assert zero3["batch"] == 8 and zero3["decode_steps"] == 15
    assert zero3["tokens_per_sec"] > 0
    assert zero3["hidden_comm_pct"] is None
    assert zero3["hidden_comm_pct_trials"] == [None]
    assert "gloo" in zero3["hidden_comm_pct_note"]
    assert "prefetch_buffers=1 skipped" in proc.stderr
    assert "7(d)" in proc.stderr
    assert "4c" not in proc.stderr


def test_one_cpu_device_skips_the_rank_legs(capsys):
    args = decode_bench.parse_args(["--serving-spec", "--device", "cpu"])
    assert decode_bench._zero3_decode(args) == []
    assert decode_bench._rank_leg(args, "serving_spec_tp") == []
    err = capsys.readouterr().err
    assert "zero3_decode skipped: it needs 2 ranks" in err
    assert "serving_spec_tp skipped: it needs 2 ranks" in err
    assert "4c" not in err


def test_spawn_ranks_ends_a_hung_pair_at_its_limit(tmp_path, monkeypatch):
    (tmp_path / "hungrank.py").write_text(HUNG_RANK)
    out = tmp_path / "out"
    out.mkdir()
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(tmp_path), str(ROOT), os.environ.get("PYTHONPATH", "")]))
    monkeypatch.setattr(mesh, "SPAWN_LIMIT_S", 15.0)
    t0 = time.monotonic()
    rc = mesh.spawn_ranks(2, "hungrank", [str(out)])
    took = time.monotonic() - t0
    assert rc == 124
    assert took < 40, took
    pids = [int((out / f"pid_{r}").read_text()) for r in range(2)]
    for pid in pids:
        try:
            state = Path(f"/proc/{pid}/stat").read_text().rsplit(
                ")", 1)[1].split()[0]
        except OSError:
            continue
        assert state in ("Z", "X"), (pid, state)
    assert not mesh.registered()
    assert not mesh.live_descendants()


def test_spawned_ranks_join_with_the_rank_timeout(tmp_path, monkeypatch):
    """A rank ``spawn_ranks`` started joins its group with
    ``RANK_TIMEOUT_S`` (the twins' ranks: a collective its peer never
    reaches fails in 2 minutes, well inside the launcher's limit)."""
    (tmp_path / "timeoutrank.py").write_text(
        "import os, sys\n"
        "from pathlib import Path\n"
        "Path(sys.argv[1], os.environ['RANK']).write_text(\n"
        "    os.environ['PDTPU_GROUP_TIMEOUT_S'])\n")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(tmp_path), str(ROOT), os.environ.get("PYTHONPATH", "")]))
    assert mesh.spawn_ranks(2, "timeoutrank", [str(tmp_path)]) == 0
    assert [float((tmp_path / str(r)).read_text()) for r in range(2)] == \
        [mesh.RANK_TIMEOUT_S] * 2 == [120.0, 120.0]
