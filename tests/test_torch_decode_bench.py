"""The ``decode_bench`` twin on the CPU: its paged, disaggregated and
scenario legs at ``--dryrun`` exit 0 and carry their invariant fields, and
``--cpu-devices`` other than 2 is refused (the other modes:
``tests/test_torch_decode_bench_legs.py``; the two ranks:
``tests/test_torch_decode_bench_ranks.py``).

The legs' clock is replaced by a counter that advances 1 ms per read, so
their latencies and rates count steps, not this host's load: the timing
gates (interactive p99 ratio, tenant tok/s ratio) are then a function of
the schedule alone, as the structural gates are. On the card the twin runs
on the host clock (``chip_smoke.py`` phase decode_bench_twin).
"""

import itertools
import json

import pytest
import torch

from pytorch_distributed_tpu_torch.serving import decode_bench


@pytest.fixture(autouse=True)
def _step_clock(monkeypatch):
    ticks = itertools.count()
    monkeypatch.setattr(decode_bench, "_now", lambda: next(ticks) * 1e-3)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(capsys, *flags, tmp_path=None):
    argv = [*flags, "--dryrun", "--device", "cpu"]
    if tmp_path is not None:
        argv += ["--json", str(tmp_path / "rows.json")]
    assert decode_bench.main(argv) == 0
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def test_serving_paged_leg(capsys):
    (row,) = _run(capsys, "--serving-paged")
    assert row["leg"] == "serving_paged_stream"
    assert row["invariant_failures"] == []
    assert row["outputs_match"] == "16/16"  # exact on the CPU
    assert row["paged"]["slots"] == 2 * row["dense"]["slots"]
    assert row["paged"]["cache_hbm_bytes"] == row["dense"][
        "cache_hbm_bytes"]  # equal pool HBM
    assert row["paged_extras"]["prefix_hit_rate"] > 0
    for leg in ("dense", "paged"):
        assert row[leg]["observed_compile_count_steady"] == 0
        assert row[leg]["steady_tokens_per_sec"] > 0


def test_serving_disagg_leg(capsys, tmp_path):
    (row,) = _run(capsys, "--serving-disagg", tmp_path=tmp_path)
    assert row["leg"] == "serving_disagg_stream"
    assert row["invariant_failures"] == []
    assert row["outputs_match"] == "16/16"
    assert row["observed_compile_count_steady"] == 0
    assert row["roles"] == {"0": "prefill", "1": "decode"}
    h = row["handoffs"]
    assert h["count"] == row["requests"] == 16
    assert h["useful_bytes_total"] == h["pages_total"] * h["bytes_per_page"]
    assert h["wire_bytes_total"] >= h["useful_bytes_total"] > 0
    assert row["interactive_p99_ratio"] > 0
    assert row["interactive_p99_ratio_gated"] is False
    assert json.loads((tmp_path / "rows.json").read_text()) == [row]


def test_serving_scenarios_legs(capsys):
    rows = _run(capsys, "--serving-scenarios")
    assert [r["leg"] for r in rows] == [
        "serving_scenarios_tiered_slo", "serving_scenarios_sessions",
        "serving_scenarios_multi_tenant_lora"]
    tiered, sessions, lora = rows
    assert all(r["invariant_failures"] == [] for r in rows)
    assert all(r["observed_compile_count_steady"] == 0 for r in rows)
    assert tiered["interactive_p99_ratio"] <= 1.75
    assert tiered["max_batch_queue_depth"] >= 1
    assert sessions["turn_prefill_hit_rate"] >= 0.9
    assert sessions["turns_bit_equal_oneshot"] == sessions["turns_done"] == 9
    assert lora["rows_bit_equal_isolated"] == "12/12"
    assert lora["aggregate_tokens_per_sec_ratio"] >= 0.7
    assert lora["tenants"] == 4 and lora["rank"] == 8


@pytest.mark.parametrize("argv, item", [
    (["--serving-paged", "--cpu-devices", "8"], "--device cpu"),
    (["--cpu-devices", "3"], "virtual-device mesh"),
])
def test_other_modes_are_refused_naming_their_item(argv, item):
    """Every mode of the JAX script runs (tests/test_torch_decode_bench_
    legs.py), and ``--cpu-devices 2`` starts the multi-rank sub-legs' two
    gloo CPU ranks (tests/test_torch_decode_bench_ranks.py); a virtual
    mesh of any other size is refused."""
    with pytest.raises(SystemExit, match=item):
        decode_bench.parse_args(argv)
