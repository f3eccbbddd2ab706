"""Trace analysis over Chrome-trace JSON (the HTA analogue).

The port of the JAX package's ``profiling/trace_analysis.py``, with the
same functions, signatures and output keys:

- ``temporal_breakdown`` — compute / communication / memcpy / idle time on
  the device over the span of its activity (HTA get_temporal_breakdown);
- ``comm_comp_overlap`` — how much communication is hidden under compute
  (HTA get_comm_comp_overlap: exposed vs hidden);
- ``op_summary`` and ``ops_diff`` — per-op count and duration, and their
  diff between two traces (HTA TraceDiff, with the reference notebook's
  collective filter through ``only_categories``).

Two trace layouts are read:

- **Kineto** (what ``torch.profiler`` writes, ``*.pt.trace.json.gz``):
  device events are keyed on their ``cat``, as HTA does: ``kernel``,
  ``gpu_memcpy`` and ``gpu_memset``. Host rows (``cpu_op``,
  ``cuda_runtime``, ``python_function``, ``user_annotation``, and
  ``gpu_user_annotation``, which only projects a host annotation onto a
  stream) are never device time. ``gpu_memcpy``/``gpu_memset`` are
  ``memcpy``; a kernel whose name starts with ``nccl`` is
  ``communication`` (broadcast included); every other kernel goes through
  ``classify_op``, except that on this layout ``communication`` is kept
  for NCCL: a kernel name such as CUTLASS's ``collective::`` namespace
  carries a marker word but moves nothing between devices.
- **XLA tracks** (``jax.profiler``'s Chrome trace): the per-op threads
  ("XLA Ops", "Async XLA Ops", "Stream") of device processes, as in the
  JAX package, so a JAX trace gives the same numbers in both packages.

A trace holding neither (a CPU-only ``torch.profiler`` run) has no device
rows, and every analysis returns its zero dict. The JAX package's XLA:CPU
fallback (per-op rows of the virtual-device CPU runtime's threads) has no
counterpart here: the port has no virtual-device mesh.

Pure stdlib (json/gzip).
"""

from __future__ import annotations

import gzip
import json
from collections import defaultdict
from pathlib import Path

_COMM_MARKERS = (
    # Hyphen-normalised (classify_op folds "_" -> "-"): XLA's all-gather /
    # all_gather / allgather spellings plus async -start/-done forms.
    "all-reduce", "allreduce", "all-gather", "allgather", "reduce-scatter",
    "reducescatter", "collective-permute", "all-to-all", "alltoall",
    "ragged-all-to-all", "psum", "pmean", "ppermute", "send", "recv",
    "collective",
)
_MEMCPY_MARKERS = ("copy-start", "copy-done", "copy.", "memcpy", "transpose-copy")
_INFRA_MARKERS = ("infeed", "outfeed", "host-callback")

# Kineto's device-side categories (HTA's device event set).
KINETO_KERNEL = "kernel"
KINETO_MEMORY = ("gpu_memcpy", "gpu_memset")


def classify_op(name: str) -> str:
    n = name.lower().replace("_", "-")
    if any(m in n for m in _COMM_MARKERS):
        return "communication"
    if any(m in n for m in _MEMCPY_MARKERS):
        return "memcpy"
    if any(m in n for m in _INFRA_MARKERS):
        return "infra"
    return "compute"


def classify_kineto(cat: str, name: str) -> str:
    """The category of one Kineto device event (module docstring)."""
    if cat in KINETO_MEMORY:
        return "memcpy"
    bare = name.removeprefix("void ").lstrip()
    if bare.lower().startswith("nccl"):
        return "communication"
    kind = classify_op(name)
    return "compute" if kind == "communication" else kind


def load_trace(path: str | Path) -> dict:
    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        return json.load(f)


def _device_pids(trace: dict) -> set[int]:
    pids = set()
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "M" and e.get("name") == "process_name":
            name = (e.get("args") or {}).get("name", "")
            if "TPU" in name or "GPU" in name or "device" in name.lower():
                if "CPU" not in name and "host" not in name.lower():
                    pids.add(e["pid"])
    return pids


def _op_threads(trace: dict, pids: set[int]) -> set[tuple[int, int]]:
    """(pid, tid) pairs for per-op device tracks ('XLA Ops' and async)."""
    keys = set()
    for e in trace.get("traceEvents", []):
        if (
            e.get("ph") == "M"
            and e.get("name") == "thread_name"
            and e.get("pid") in pids
        ):
            tname = (e.get("args") or {}).get("name", "")
            if "XLA Ops" in tname or "Async" in tname or "Stream" in tname:
                keys.add((e["pid"], e["tid"]))
    return keys


def _is_kineto_device(e: dict) -> bool:
    return e.get("ph") == "X" and (
        e.get("cat") == KINETO_KERNEL or e.get("cat") in KINETO_MEMORY)


def _event(e: dict, category: str) -> dict:
    return {
        "name": e["name"],
        "ts": float(e.get("ts", 0.0)),
        "dur": float(e.get("dur", 0.0)),
        "pid": e["pid"],
        "tid": e["tid"],
        "category": category,
    }


def device_op_events(trace: dict) -> list[dict]:
    """Complete ('X') events on the device: [{name, ts, dur, pid, tid,
    category}]. Kineto device events where the trace has any, else the
    per-op rows of XLA device tracks; none on a host-only trace."""
    events = trace.get("traceEvents", [])
    kineto = [e for e in events if _is_kineto_device(e)]
    if kineto:
        return [_event(e, classify_kineto(e["cat"], e["name"]))
                for e in kineto]
    threads = _op_threads(trace, _device_pids(trace))
    return [_event(e, classify_op(e["name"])) for e in events
            if e.get("ph") == "X"
            and (e.get("pid"), e.get("tid")) in threads]


def _merge_intervals(intervals: list[tuple[float, float]]):
    if not intervals:
        return []
    intervals = sorted(intervals)
    merged = [list(intervals[0])]
    for s, e in intervals[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _total(intervals) -> float:
    return sum(e - s for s, e in intervals)


def _intersect(a, b):
    """Intersection of two merged interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def temporal_breakdown(trace: dict) -> dict:
    """Device time split into compute / communication / memcpy / idle over
    the span of device activity (HTA get_temporal_breakdown analogue).
    Overlapped comm+compute time counts as compute (busy), matching the
    'non-compute = exposed only' convention."""
    events = device_op_events(trace)
    if not events:
        return {
            "total_us": 0.0, "busy_us": 0.0, "idle_us": 0.0,
            "compute_us": 0.0, "communication_us": 0.0,
            "communication_exposed_us": 0.0, "memcpy_us": 0.0,
            "idle_pct": 0.0, "compute_pct": 0.0, "communication_pct": 0.0,
            "communication_exposed_pct": 0.0, "memcpy_pct": 0.0,
        }
    by_cat = defaultdict(list)
    for ev in events:
        by_cat[ev["category"]].append((ev["ts"], ev["ts"] + ev["dur"]))
    merged = {c: _merge_intervals(iv) for c, iv in by_cat.items()}

    all_iv = _merge_intervals(
        [iv for ivs in merged.values() for iv in ivs]
    )
    t0 = min(s for s, _ in all_iv)
    t1 = max(e for _, e in all_iv)
    total = t1 - t0
    busy = _total(all_iv)

    compute = _total(merged.get("compute", []))
    comm_iv = merged.get("communication", [])
    comm_exposed = _total(comm_iv) - _total(
        _intersect(comm_iv, merged.get("compute", []))
    )
    memcpy = _total(merged.get("memcpy", []))

    def pct(x):
        return 100.0 * x / total if total else 0.0

    return {
        "total_us": total,
        "busy_us": busy,
        "idle_us": total - busy,
        "compute_us": compute,
        "communication_us": _total(comm_iv),
        "communication_exposed_us": comm_exposed,
        "memcpy_us": memcpy,
        "compute_pct": pct(compute),
        "communication_pct": pct(_total(comm_iv)),
        "communication_exposed_pct": pct(comm_exposed),
        "memcpy_pct": pct(memcpy),
        "idle_pct": pct(total - busy),
    }


def comm_comp_overlap(trace: dict) -> dict:
    """Communication overlapped-with-compute vs exposed
    (HTA get_comm_comp_overlap: overlap% = hidden comm / total comm)."""
    events = device_op_events(trace)
    comp = _merge_intervals(
        [
            (e["ts"], e["ts"] + e["dur"])
            for e in events
            if e["category"] == "compute"
        ]
    )
    comm = _merge_intervals(
        [
            (e["ts"], e["ts"] + e["dur"])
            for e in events
            if e["category"] == "communication"
        ]
    )
    total_comm = _total(comm)
    hidden = _total(_intersect(comm, comp))
    return {
        "comm_total_us": total_comm,
        "comm_hidden_us": hidden,
        "comm_exposed_us": total_comm - hidden,
        "overlap_pct": 100.0 * hidden / total_comm if total_comm else 0.0,
        "exposed_pct": (
            100.0 * (total_comm - hidden) / total_comm if total_comm else 0.0
        ),
    }


def op_summary(trace: dict) -> dict[str, dict]:
    """Per-op-name totals: {name: {count, total_us, mean_us, category}}."""
    out: dict[str, dict] = {}
    for e in device_op_events(trace):
        rec = out.setdefault(
            e["name"],
            {"count": 0, "total_us": 0.0, "category": e["category"]},
        )
        rec["count"] += 1
        rec["total_us"] += e["dur"]
    for rec in out.values():
        rec["mean_us"] = rec["total_us"] / rec["count"]
    return out


def ops_diff(
    trace_a: dict, trace_b: dict, *, only_categories=None, top: int = 0
) -> dict:
    """Operator diff between two traces (TraceDiff analogue): ops added in b,
    removed from b, and shared ops with count/duration deltas. Use
    ``only_categories={'communication'}`` for the notebook's collective
    filter (nccl/allreduce/allgather/reduce_scatter/broadcast)."""
    a, b = op_summary(trace_a), op_summary(trace_b)

    def keep(name, rec):
        return only_categories is None or rec["category"] in only_categories

    added = {
        n: r for n, r in b.items() if n not in a and keep(n, r)
    }
    removed = {
        n: r for n, r in a.items() if n not in b and keep(n, r)
    }
    changed = {}
    for n in set(a) & set(b):
        if not keep(n, b[n]):
            continue
        changed[n] = {
            "count_a": a[n]["count"],
            "count_b": b[n]["count"],
            "total_us_a": a[n]["total_us"],
            "total_us_b": b[n]["total_us"],
            "delta_us": b[n]["total_us"] - a[n]["total_us"],
            "category": b[n]["category"],
        }
    if top:
        def trim(d, key):
            return dict(
                sorted(d.items(), key=key, reverse=True)[:top]
            )

        added = trim(added, lambda kv: kv[1]["total_us"])
        removed = trim(removed, lambda kv: kv[1]["total_us"])
        changed = trim(changed, lambda kv: abs(kv[1]["delta_us"]))
    return {"added": added, "removed": removed, "changed": changed}
