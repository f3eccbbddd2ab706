"""The twin of ``scripts/soak.py``
(``python -m pytorch_distributed_tpu_torch.serving.soak``) at CI scale on
the CPU: the seeded storm over the dense ``BatchedDecodeEngine`` holds
all five invariants (exit 0), and breaking any one of them — a duplicated
rid, a changed token, a steady-state compile, a leaked cache, a fault
kind that never fired — makes it exit 1 and name the failure.
"""

import json

import numpy as np
import pytest

from pytorch_distributed_tpu_torch.serving import engine as engine_mod
from pytorch_distributed_tpu_torch.serving import soak

DRYRUN = ["--dryrun", "--device", "cpu"]
# The dryrun's settings written out, so one probability can be set to 0
# (--dryrun would raise it back to its floor).
EXPLICIT = ["--device", "cpu", "--requests", "24", "--engine-loss-tick",
            "20", "--p-dispatch-error", "0.08", "--p-drop-result", "0.08",
            "--p-nan-row", "0.3", "--p-slow-tick", "0.25", "--p-abort", "0.2",
            "--deadline-range", "0.3", "1.5"]


def _report(capsys):
    out = capsys.readouterr().out
    return json.loads(out[out.index("{\n"): out.rindex("}") + 1])


@pytest.mark.parametrize("seed", [0, 1])
def test_dryrun_storm_holds_every_invariant(seed, capsys, tmp_path):
    log = tmp_path / "soak.log"
    assert soak.main(DRYRUN + ["--seed", str(seed), "--log",
                               str(log)]) == 0
    rep = _report(capsys)
    assert rep["ok"] and rep["invariant_failures"] == []
    assert rep["engine_rebuilds"] == 1
    assert all(n > 0 for n in rep["fault_counts"].values())
    assert rep["terminal_states"].get("ABORTED")
    assert rep["terminal_states"].get("EXPIRED")
    assert sum(rep["terminal_states"].values()) == 24
    assert rep["steady_compiles"] == [0, 0]
    assert "event=dispatch_fail" in log.read_text()


def test_a_duplicated_rid_fails_the_soak(monkeypatch, capsys):
    """The storm engine issues one rid twice: invariant 1 names it."""
    submit = engine_mod.BatchedDecodeEngine.submit

    def duplicating(self, *a, **kw):
        if self._injector is not None and self._next_rid == 5:
            self._next_rid = 4
        return submit(self, *a, **kw)

    monkeypatch.setattr(engine_mod.BatchedDecodeEngine, "submit",
                        duplicating)
    assert soak.main(DRYRUN) == 1
    assert any("duplicated rids [4]" in f
               for f in _report(capsys)["invariant_failures"])


def test_a_changed_token_fails_the_soak(monkeypatch, capsys):
    drive = soak.drive

    def corrupting(engine, *a, **kw):
        res = drive(engine, *a, **kw)
        if kw.get("injector") is not None:
            done = next(r for r in res[0].values() if r.state == "DONE")
            done.tokens = np.asarray(done.tokens).copy()
            done.tokens[-1] = (done.tokens[-1] + 1) % 97
        return res

    monkeypatch.setattr(soak, "drive", corrupting)
    assert soak.main(DRYRUN) == 1
    assert any("DONE but tokens diverge" in f
               for f in _report(capsys)["invariant_failures"])


def test_a_steady_state_compile_fails_the_soak(monkeypatch, capsys):
    monkeypatch.setattr(
        engine_mod.BatchedDecodeEngine, "compile_count",
        lambda self: int(self._injector is not None and self._ticks > 3))
    assert soak.main(DRYRUN) == 1
    assert any("steady-state compiles" in f
               for f in _report(capsys)["invariant_failures"])


def test_a_leaked_cache_fails_the_soak(monkeypatch, capsys):
    drop = engine_mod.BatchedDecodeEngine._drop_cache_after_failure

    def leaking(self):
        self.counters["cache_allocs"] += 1
        drop(self)

    monkeypatch.setattr(engine_mod.BatchedDecodeEngine,
                        "_drop_cache_after_failure", leaking)
    assert soak.main(DRYRUN) == 1
    assert any("cache allocs" in f
               for f in _report(capsys)["invariant_failures"])


def test_a_fault_kind_that_never_fired_fails_the_soak(capsys):
    argv = list(EXPLICIT)
    argv[argv.index("--p-nan-row") + 1] = "0"
    assert soak.main(argv) == 1
    assert any("'nan_row' never fired" in f
               for f in _report(capsys)["invariant_failures"])
    assert soak.main(EXPLICIT) == 0  # the same settings with nan_row on
