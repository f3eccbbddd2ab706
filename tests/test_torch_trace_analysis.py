"""The port's trace analysis against the JAX package's, on the CPU.

The JAX package's own test traces (XLA device tracks, built as in
``tests/test_profiling.py``) go through both packages and must give the
same dicts exactly; the same events laid out as a Kineto trace (the layout
``torch.profiler`` writes on the card: a GPU process labelled "GPU 0",
stream threads named in lower case, device rows keyed on ``cat``) must give
the port the same breakdowns; a real CPU ``torch.profiler`` trace holds no
device rows and gives the zero breakdown.
"""

import gzip
import json

import pytest
import torch

from pytorch_distributed_tpu.profiling import trace_analysis as jta
from pytorch_distributed_tpu_torch.profiling import trace_analysis as ta
from pytorch_distributed_tpu_torch.profiling.profiler import (
    ScheduledProfiler,
    find_trace_files,
)

# Every op name the JAX package's profiling tests classify or lay out,
# XLA's collective spellings, and kernel names from a card's Kineto trace
# of the GPT-2 train step (cuBLAS's nvjet, ATen, the port's own kernels).
NAMES = [
    "fusion.123", "all-reduce-start", "AllGather(1)", "copy-start",
    "infeed-dequeue", "fusion", "all-reduce", "all-reduce.1", "host_thing",
    "all-gather-start.2", "all_gather.3", "reduce-scatter.1",
    "collective-permute-done", "all-to-all.4", "ragged-all-to-all", "send",
    "recv-done", "psum", "ppermute", "copy.7", "copy-done",
    "transpose-copy", "outfeed", "host-callback", "convolution.5",
    "nvjet_tst_192x128_64x5_1x2_h_bz_coopB_TNT",
    "void (anonymous namespace)::flash_fwd_sm90<64>((anonymous "
    "namespace)::FwdArgs)",
    "void (anonymous namespace)::paged_decode_kernel<__nv_bfloat16, "
    "__nv_bfloat16, 64, 1>((anonymous namespace)::Args)",
    "void at::native::vectorized_elementwise_kernel<8, "
    "at::native::bfloat16_copy_kernel_cuda(at::TensorIteratorBase&)",
    "void at::native::(anonymous namespace)::sum_and_scatter<float, long>",
    "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
    "Memcpy DtoD (Device -> Device)", "Memset (Device)",
]


@pytest.mark.parametrize("name", NAMES)
def test_classify_op_equals_jax(name):
    assert ta.classify_op(name) == jta.classify_op(name)


@pytest.mark.parametrize("cat, name, want", [
    ("kernel", "ncclDevKernel_Broadcast_RING_LL(ncclDevKernelArgs)",
     "communication"),
    ("kernel", "void ncclKernel_AllGather_RING_LL_Sum_int8_t(ncclWorkElem)",
     "communication"),
    ("kernel", "void cutlass::device_kernel<cutlass::gemm::collective::"
               "CollectiveMma<float>>(Params)", "compute"),
    ("kernel", "void (anonymous namespace)::flash_bwd_dq_sm90<64>("
               "(anonymous namespace)::BwdArgs)", "compute"),
    ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", "memcpy"),
    ("gpu_memset", "Memset (Device)", "memcpy"),
])
def test_kineto_classification(cat, name, want):
    assert ta.classify_kineto(cat, name) == want


# ---- the JAX package's test traces, through both packages ----------------
def _mk_trace(events):
    """The JAX package's test layout: one device pid=1 ('XLA Ops' tid=2,
    'Async XLA Ops' tid=3) and a host pid=9."""
    meta = [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "/device:TPU:0"}},
        {"ph": "M", "pid": 9, "name": "process_name",
         "args": {"name": "/host:CPU"}},
        {"ph": "M", "pid": 1, "tid": 2, "name": "thread_name",
         "args": {"name": "XLA Ops"}},
        {"ph": "M", "pid": 1, "tid": 3, "name": "thread_name",
         "args": {"name": "Async XLA Ops"}},
    ]
    evs = [
        {"ph": "X", "pid": pid, "tid": tid, "name": name, "ts": ts, "dur": d}
        for (name, pid, tid, ts, d) in events
    ]
    return {"traceEvents": meta + evs}


TRACES = {
    "host_and_device": [("fusion", 1, 2, 0, 10), ("host_thing", 9, 7, 0, 99)],
    "overlap": [("fusion", 1, 2, 0, 100), ("all-reduce", 1, 3, 50, 80),
                ("copy-start", 1, 2, 140, 10)],
    "base": [("fusion", 1, 2, 0, 100)],
    "ddp": [("fusion", 1, 2, 0, 90), ("all-reduce.1", 1, 3, 50, 40)],
    "tiny": [("fusion", 1, 2, 0, 5)],
    "empty": [],
}


@pytest.mark.parametrize("fn", ["device_op_events", "temporal_breakdown",
                                "comm_comp_overlap", "op_summary"])
@pytest.mark.parametrize("key", sorted(TRACES))
def test_jax_traces_give_jax_results(fn, key):
    trace = _mk_trace(TRACES[key])
    assert getattr(ta, fn)(trace) == getattr(jta, fn)(trace)


@pytest.mark.parametrize("cats, top", [(None, 0), ({"communication"}, 0),
                                       (None, 1)])
def test_jax_traces_give_jax_ops_diff(cats, top):
    a, b = _mk_trace(TRACES["base"]), _mk_trace(TRACES["ddp"])
    assert ta.ops_diff(a, b, only_categories=cats, top=top) == jta.ops_diff(
        a, b, only_categories=cats, top=top)
    assert list(ta.ops_diff(a, b, only_categories={"communication"})[
        "added"]) == ["all-reduce.1"]


# ---- the same events in Kineto's layout -----------------------------------
# Each XLA op name of the test traces and the device row a card's Kineto
# trace holds for that kind of work.
KINETO_NAME = {
    "fusion": ("kernel", "void (anonymous namespace)::flash_fwd_sm90<64>("
                         "(anonymous namespace)::FwdArgs)"),
    "all-reduce": ("kernel", "ncclDevKernel_AllReduce_Sum_f32_RING_LL("
                             "ncclDevKernelArgsStorage<4096ul>)"),
    "all-reduce.1": ("kernel", "ncclDevKernel_AllReduce_Sum_bf16_RING_LL("
                               "ncclDevKernelArgsStorage<4096ul>)"),
    "copy-start": ("gpu_memcpy", "Memcpy DtoD (Device -> Device)"),
}


def _kineto_trace(events):
    """The layout of a card's ``torch.profiler`` trace: host pid 118, GPU
    pid 0 with streams 7 and 13, device rows keyed on ``cat``, and the host
    rows and annotations that must never count as device time."""
    meta = [
        {"name": "process_name", "ph": "M", "pid": 118, "tid": 0,
         "args": {"name": "python3"}},
        {"name": "process_labels", "ph": "M", "pid": 118, "tid": 0,
         "args": {"labels": "CPU"}},
        {"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
         "args": {"name": "python3"}},
        {"name": "process_labels", "ph": "M", "pid": 0, "tid": 0,
         "args": {"labels": "GPU 0"}},
        {"name": "thread_name", "ph": "M", "pid": 0, "tid": 7,
         "args": {"name": "stream 7 "}},
        {"name": "thread_name", "ph": "M", "pid": 0, "tid": 13,
         "args": {"name": "stream 13 "}},
        {"name": "thread_name", "ph": "M", "pid": 118, "tid": 118,
         "args": {"name": "thread 118 (python3)"}},
    ]
    evs, corr = [], 1000
    for name, pid, tid, ts, d in events:
        corr += 1
        if pid != 1:  # a host row of the XLA layout
            evs.append({"ph": "X", "cat": "cpu_op", "name": name,
                        "pid": 118, "tid": 118, "ts": ts, "dur": d,
                        "args": {"External id": corr}})
            continue
        cat, kname = KINETO_NAME[name]
        stream = 7 if tid == 2 else 13
        evs += [
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "pid": 118, "tid": 118, "ts": ts - 5.0, "dur": 4.0,
             "args": {"correlation": corr}},
            {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": corr,
             "pid": 118, "tid": 118, "ts": ts - 5.0},
            {"ph": "X", "cat": cat, "name": kname, "pid": 0, "tid": stream,
             "ts": ts, "dur": d,
             "args": {"device": 0, "stream": stream, "correlation": corr}},
            {"ph": "f", "cat": "ac2g", "name": "ac2g", "id": corr, "pid": 0,
             "tid": stream, "ts": ts, "bp": "e"},
        ]
    if evs:
        span = max(e["ts"] + e.get("dur", 0) for e in evs) + 50
        evs += [
            {"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#4",
             "pid": 118, "tid": 118, "ts": -20.0, "dur": span},
            {"ph": "X", "cat": "gpu_user_annotation", "name": "train_step#4",
             "pid": 0, "tid": 7, "ts": -10.0, "dur": span},
            {"ph": "X", "cat": "python_function", "name": "step",
             "pid": 118, "tid": 118, "ts": -15.0, "dur": span},
        ]
    return {"schemaVersion": 1, "traceEvents": meta + evs,
            "deviceProperties": [{"id": 0, "name": "NVIDIA H100 80GB HBM3"}]}


def _renamed(summary: dict) -> dict:
    back = {k: name for name, (_, k) in KINETO_NAME.items()}
    return {back[k]: v for k, v in summary.items()}


def _close(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, float):
        assert a == pytest.approx(b, abs=1e-9, rel=1e-9)
    else:
        assert a == b


@pytest.mark.parametrize("key", sorted(TRACES))
def test_kineto_layout_gives_the_same_results(key):
    events = TRACES[key]
    jax_trace, kineto = _mk_trace(events), _kineto_trace(events)
    for fn in ("temporal_breakdown", "comm_comp_overlap"):
        _close(getattr(ta, fn)(kineto), getattr(jta, fn)(jax_trace))
    _close(_renamed(ta.op_summary(kineto)), jta.op_summary(jax_trace))
    assert len(ta.device_op_events(kineto)) == len(
        jta.device_op_events(jax_trace))


def test_kineto_ops_diff_finds_the_added_collective():
    a = _kineto_trace(TRACES["base"])
    b = _kineto_trace(TRACES["ddp"])
    diff = ta.ops_diff(a, b, only_categories={"communication"})
    assert list(diff["added"]) == [KINETO_NAME["all-reduce.1"][1]]
    assert diff["removed"] == {} and diff["changed"] == {}
    full = ta.ops_diff(a, b)
    fwd = KINETO_NAME["fusion"][1]
    assert full["changed"][fwd]["delta_us"] == pytest.approx(-10)


def test_the_jax_heuristics_miss_kineto_rows():
    """Why the port keys Kineto rows on ``cat``: the JAX package's track
    heuristics find no device rows in the card's layout."""
    kineto = _kineto_trace(TRACES["overlap"])
    assert jta.device_op_events(kineto) == []
    assert ta.temporal_breakdown(kineto)["busy_us"] == pytest.approx(140)


@pytest.mark.parametrize("layout", ["xla", "kineto"])
def test_gzip_round_trip(tmp_path, layout):
    events = TRACES["overlap"]
    trace = _mk_trace(events) if layout == "xla" else _kineto_trace(events)
    p = tmp_path / "t.pt.trace.json.gz"
    with gzip.open(p, "wt") as f:
        json.dump(trace, f)
    assert ta.load_trace(p) == trace
    assert ta.temporal_breakdown(ta.load_trace(p)) == \
        ta.temporal_breakdown(trace)
    plain = tmp_path / "t.json"
    plain.write_text(json.dumps(trace))
    assert ta.load_trace(plain) == trace


def test_cpu_profiler_trace_gives_the_zero_breakdown(tmp_path):
    with ScheduledProfiler(tmp_path, wait=1, warmup=1, active=2,
                           device="cpu") as prof:
        for step in range(5):
            with prof.step_context(step):
                (torch.randn(64, 64) @ torch.randn(64, 64)).sum()
            prof.step()
    files = find_trace_files(tmp_path)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json.gz")
    trace = ta.load_trace(files[0])
    assert any(e.get("cat") == "cpu_op" for e in trace["traceEvents"])
    assert ta.device_op_events(trace) == []
    zero = jta.temporal_breakdown({"traceEvents": []})
    assert ta.temporal_breakdown(trace) == zero
    assert ta.comm_comp_overlap(trace) == jta.comm_comp_overlap(
        {"traceEvents": []})
    assert ta.op_summary(trace) == {}


def test_lost_launches_and_the_kernels_traced_count():
    """chip_smoke's trace checks on the card's layout: a launch call whose
    device row is missing is lost; K1-K4 are counted by kernel name."""
    import chip_smoke

    trace = _kineto_trace(TRACES["overlap"])
    assert chip_smoke.lost_launches(trace) == []
    first = next(e for e in trace["traceEvents"] if e.get("cat") == "kernel")
    dropped = {"traceEvents": [e for e in trace["traceEvents"]
                               if e is not first]}
    (lost,) = chip_smoke.lost_launches(dropped)
    assert lost["name"] == "cudaLaunchKernel"
    assert lost["args"]["correlation"] == first["args"]["correlation"]
    ops = {
        "void (anonymous namespace)::flash_fwd_sm90<64>(FwdArgs)":
            dict(count=48),
        "void (anonymous namespace)::flash_bwd_delta<__nv_bfloat16, 64>(x)":
            dict(count=48),
        "void (anonymous namespace)::flash_bwd_dkdv_sm90<64>(BwdArgs)":
            dict(count=48),
        "void (anonymous namespace)::flash_bwd_dq_sm90<64>(BwdArgs)":
            dict(count=47),
        "void (anonymous namespace)::paged_decode_kernel<__nv_bfloat16, "
        "__nv_bfloat16, 64, 1>(Args)": dict(count=120),
        "void (anonymous namespace)::paged_decode_kernel<__nv_bfloat16, "
        "signed char, 64, 1>(Args)": dict(count=96),
        "nvjet_tst_64x8_64x16_4x1_v_bz_NNT": dict(count=360),
    }
    assert chip_smoke.trace_launches(ops) == dict(
        K1=48, K2={"flash_bwd_delta": 48, "flash_bwd_dkdv": 48,
                   "flash_bwd_dq": 47}, K3=120, K4=96)
