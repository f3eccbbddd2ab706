"""Trace analysis report: temporal breakdown, comm/comp overlap, op diffs.

The port's twin of the JAX package's ``scripts/analyze_traces.py`` (the
reference's HTA notebook, analyze_traces.ipynb): for each trace directory
(or ``.json.gz`` file) it prints the compute / communication / memcpy /
idle breakdown and the hidden-vs-exposed communication, and for each
neighbouring pair the operator diff, filtered to collectives unless
``--all-ops``. It reads Kineto traces (``torch.profiler``) and the JAX
package's XLA traces alike (``profiling/trace_analysis``).

``--charts DIR`` also writes the notebook's figures as PNGs (a
temporal-breakdown pie and a top-ops bar per trace). They need
matplotlib: where it is missing, the report runs without them and the
command then exits nonzero, saying so.

    python -m pytorch_distributed_tpu_torch.profiling.analyze_traces \\
        outputs/traces/baseline
    python -m pytorch_distributed_tpu_torch.profiling.analyze_traces \\
        outputs/traces/baseline --charts outputs/charts
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

from pytorch_distributed_tpu_torch.profiling.profiler import find_trace_files
from pytorch_distributed_tpu_torch.profiling.trace_analysis import (
    comm_comp_overlap,
    load_trace,
    op_summary,
    ops_diff,
    temporal_breakdown,
)

NO_MATPLOTLIB = "--charts needs matplotlib, which is not installed here"


def _latest_trace(d: str) -> str | None:
    files = find_trace_files(d)
    return files[-1] if files else None


def _write_charts(outdir: str, label: str, trace, tb: dict, *, top: int):
    """Notebook-parity figures: one pie + one top-ops bar per trace."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    # The last two path components, so runA/traces and runB/traces don't
    # overwrite each other's figures.
    parts = [p for p in Path(label).parts if p not in (".", "/")]
    stem = "_".join(parts[-2:]) if parts else "trace"

    shares = {
        "compute": tb["compute_pct"],
        "communication": tb["communication_pct"],
        "memcpy": tb["memcpy_pct"],
        "idle": tb["idle_pct"],
    }
    shares = {k: v for k, v in shares.items() if v > 0.05}
    if shares:
        fig, ax = plt.subplots(figsize=(5, 5))
        ax.pie(shares.values(), labels=list(shares),
               autopct="%1.1f%%", startangle=90)
        ax.set_title(f"temporal breakdown — {stem}")
        fig.savefig(out / f"{stem}_temporal_pie.png",
                    dpi=120, bbox_inches="tight")
        plt.close(fig)

    ops = sorted(op_summary(trace).items(),
                 key=lambda kv: -kv[1]["total_us"])[:top]
    if ops:
        names = [n[:48] for n, _ in ops][::-1]
        vals = [v["total_us"] / 1e3 for _, v in ops][::-1]
        fig, ax = plt.subplots(figsize=(8, 0.35 * len(names) + 1.2))
        ax.barh(names, vals)
        ax.set_xlabel("total device time (ms)")
        ax.set_title(f"top {len(names)} ops — {stem}")
        fig.savefig(out / f"{stem}_top_ops.png",
                    dpi=120, bbox_inches="tight")
        plt.close(fig)
    print(f"  charts -> {out}/{stem}_*.png")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("trace_dirs", nargs="+",
                   help="trace dirs (or .trace.json.gz files)")
    p.add_argument("--all-ops", action="store_true",
                   help="diff all ops, not just collectives")
    p.add_argument("--top", type=int, default=15)
    p.add_argument("--charts", metavar="DIR", default=None,
                   help="also write PNG charts (pie + top-ops bar) here "
                        "(needs matplotlib)")
    args = p.parse_args(argv)
    charts = args.charts
    if charts and importlib.util.find_spec("matplotlib") is None:
        print(f"!! {NO_MATPLOTLIB}: the report runs without charts",
              file=sys.stderr)
        charts = None

    traces = {}
    for d in args.trace_dirs:
        path = d if d.endswith(".json.gz") else _latest_trace(d)
        if path is None:
            print(f"!! no trace files under {d}", file=sys.stderr)
            continue
        traces[d] = load_trace(path)
        print(f"== {d} ({Path(path).name}) ==")
        tb = temporal_breakdown(traces[d])
        if tb["total_us"] == 0:
            print("  (no device events in this trace — a CPU run records "
                  "host-side events only; run on the GPU for device "
                  "analysis)")
        print(
            f"  temporal: compute {tb['compute_pct']:.1f}% | "
            f"comm {tb['communication_pct']:.1f}% "
            f"(exposed {tb['communication_exposed_pct']:.1f}%) | "
            f"memcpy {tb['memcpy_pct']:.1f}% | idle {tb['idle_pct']:.1f}%"
        )
        ov = comm_comp_overlap(traces[d])
        print(
            f"  overlap: comm {ov['comm_total_us']:.0f}us, "
            f"hidden {ov['overlap_pct']:.1f}%, "
            f"exposed {ov['exposed_pct']:.1f}%"
        )
        if charts:
            _write_charts(charts, d, traces[d], tb, top=args.top)

    names = list(traces)
    for i in range(len(names) - 1):
        a, b = names[i], names[i + 1]
        cats = None if args.all_ops else {"communication"}
        diff = ops_diff(traces[a], traces[b], only_categories=cats,
                        top=args.top)
        label = "all ops" if args.all_ops else "collectives"
        print(f"\n== op diff ({label}): {a} -> {b} ==")
        for name, rec in diff["added"].items():
            print(f"  + {name}: {rec['count']}x, {rec['total_us']:.0f}us")
        for name, rec in diff["removed"].items():
            print(f"  - {name}: {rec['count']}x, {rec['total_us']:.0f}us")
        for name, rec in diff["changed"].items():
            print(
                f"  ~ {name}: {rec['count_a']}x->{rec['count_b']}x, "
                f"{rec['delta_us']:+.0f}us"
            )
        if not any(diff.values()):
            print("  (no differences)")
    if args.charts and not charts:
        raise SystemExit(NO_MATPLOTLIB)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
