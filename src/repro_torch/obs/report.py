"""Per-run time-breakdown reporting over recorded spans (DESIGN.md §16).

Aggregates a :class:`~repro_torch.obs.trace.SpanTracer`'s retained spans into
per-phase totals and renders the breakdown table that BENCH rows cite —
the "why is this configuration fast" answer the tentpole promises.

Coverage is computed over :data:`TOP_LEVEL_SPANS` only: nested phases
(``engine.device_compute`` inside ``engine.step``, ``vpq.refill`` inside
``engine.refill``) would double-count the same wall time.  The §16
acceptance bar is top-level spans summing to ≥90% of measured wall time
on a complete instrumented run.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

# spans that partition a run's wall time without nesting inside each
# other (checkpoint.commit runs on the writer thread and may overlap the
# stepping loop — acceptable for a coverage *floor*)
TOP_LEVEL_SPANS = ("engine.start", "engine.step", "engine.finalize",
                   "checkpoint.save", "checkpoint.commit")


def aggregate(spans: Iterable[tuple]) -> Dict[str, dict]:
    """Per-name totals over ``(name, start_s, dur_s, tid)`` tuples:
    ``{name: {count, total_s, max_s}}``, sorted by total descending."""
    agg: Dict[str, dict] = {}
    for name, _start, dur, _tid in spans:
        row = agg.get(name)
        if row is None:
            agg[name] = {"count": 1, "total_s": dur, "max_s": dur}
        else:
            row["count"] += 1
            row["total_s"] += dur
            row["max_s"] = max(row["max_s"], dur)
    return dict(sorted(agg.items(), key=lambda kv: -kv[1]["total_s"]))


def coverage(spans: Iterable[tuple], wall_s: float,
             top_level: Iterable[str] = TOP_LEVEL_SPANS) -> float:
    """Fraction of ``wall_s`` accounted for by top-level spans."""
    if wall_s <= 0:
        return 0.0
    names = frozenset(top_level)
    covered = sum(dur for name, _s, dur, _t in spans if name in names)
    return covered / wall_s


def format_table(spans: Iterable[tuple],
                 wall_s: Optional[float] = None) -> str:
    """Human-readable breakdown table; with ``wall_s`` each row gets a
    percent-of-wall column and a top-level coverage footer."""
    spans = list(spans)
    agg = aggregate(spans)
    lines = []
    if wall_s is not None:
        lines.append(f"{'phase':<28} {'count':>8} {'total s':>10} "
                     f"{'max ms':>9} {'% wall':>7}")
        for name, row in agg.items():
            lines.append(
                f"{name:<28} {row['count']:>8} {row['total_s']:>10.4f} "
                f"{1e3 * row['max_s']:>9.3f} "
                f"{100 * row['total_s'] / wall_s:>6.1f}%")
        lines.append(f"top-level span coverage: "
                     f"{100 * coverage(spans, wall_s):.1f}% of "
                     f"{wall_s:.3f}s wall")
    else:
        lines.append(f"{'phase':<28} {'count':>8} {'total s':>10} "
                     f"{'max ms':>9}")
        for name, row in agg.items():
            lines.append(
                f"{name:<28} {row['count']:>8} {row['total_s']:>10.4f} "
                f"{1e3 * row['max_s']:>9.3f}")
    return "\n".join(lines)
