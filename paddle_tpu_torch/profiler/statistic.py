"""Event aggregation + summary tables (≈ profiler_statistic.py's
summary views: OverView/OperatorView/MemoryView/DistributedView built
from host spans + the runtime metrics registry)."""
from __future__ import annotations

import enum
import re
from collections import defaultdict
from typing import List, Optional


class SortedKeys(enum.Enum):
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    Calls = 3


_UNIT = {"s": 1e9, "ms": 1e6, "us": 1e3, "ns": 1.0}


def aggregate(events: List[tuple]):
    """events: [(name, start_ns, end_ns, tid, mem)] ->
    {name: dict(calls, total_ns, avg_ns, min_ns, max_ns)}"""
    stats = defaultdict(lambda: {"calls": 0, "total_ns": 0,
                                 "min_ns": None, "max_ns": 0})
    for name, start, end, _tid, _mem in events:
        dur = max(end - start, 0)
        s = stats[name]
        s["calls"] += 1
        s["total_ns"] += dur
        s["max_ns"] = max(s["max_ns"], dur)
        s["min_ns"] = dur if s["min_ns"] is None else min(s["min_ns"], dur)
    for s in stats.values():
        s["avg_ns"] = s["total_ns"] / max(s["calls"], 1)
        s["min_ns"] = s["min_ns"] or 0
    return dict(stats)


def summary_table(events: List[tuple],
                  sorted_by: Optional[SortedKeys] = None,
                  time_unit: str = "ms") -> str:
    stats = aggregate(events)
    div = _UNIT[time_unit]
    key = {
        None: lambda kv: -kv[1]["total_ns"],
        SortedKeys.CPUTotal: lambda kv: -kv[1]["total_ns"],
        SortedKeys.CPUAvg: lambda kv: -kv[1]["avg_ns"],
        SortedKeys.CPUMax: lambda kv: -kv[1]["max_ns"],
        SortedKeys.Calls: lambda kv: -kv[1]["calls"],
    }[sorted_by]
    rows = sorted(stats.items(), key=key)
    name_w = max([len(n) for n, _ in rows] + [8])
    header = (f"{'Name':<{name_w}}  {'Calls':>7}  "
              f"{'Total(' + time_unit + ')':>12}  "
              f"{'Avg(' + time_unit + ')':>12}  "
              f"{'Max(' + time_unit + ')':>12}")
    lines = [header, "-" * len(header)]
    for name, s in rows:
        lines.append(
            f"{name:<{name_w}}  {s['calls']:>7}  "
            f"{s['total_ns'] / div:>12.4f}  {s['avg_ns'] / div:>12.4f}  "
            f"{s['max_ns'] / div:>12.4f}")
    return "\n".join(lines)


# ----------------------------------------------------------- view tables
# Each view renders a titled table from (host spans, metrics snapshot);
# the reference builds the same views from its C++ event/stat collectors
# (profiler_statistic.py OperatorSummary/MemorySummary/DistributedSummary).

def _table(title: str, columns, rows) -> str:
    widths = [max(len(str(c)), *(len(str(r[i])) for r in rows))
              if rows else len(str(c)) for i, c in enumerate(columns)]
    head = "  ".join(f"{c:<{w}}" for c, w in zip(columns, widths))
    lines = [f"---- {title} ----", head, "-" * len(head)]
    for r in rows:
        lines.append("  ".join(f"{str(v):<{w}}"
                               for v, w in zip(r, widths)))
    if not rows:
        lines.append("(no data recorded)")
    return "\n".join(lines)


def _fmt_bytes(n) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}GiB"


_LABELED = re.compile(r"^(?P<base>[^{]+)\{(?P<labels>[^}]*)\}$")


def _split_metric(name: str):
    """'comm.bytes{axis=dp,op=all_reduce}' -> ('comm.bytes',
    {'axis': 'dp', 'op': 'all_reduce'})"""
    m = _LABELED.match(name)
    if not m:
        return name, {}
    labels = dict(kv.split("=", 1) for kv in
                  m.group("labels").split(",") if "=" in kv)
    return m.group("base"), labels


def overview(events, snapshot, time_unit: str = "ms") -> str:
    div = _UNIT[time_unit]
    span_ns = sum(max(e - s, 0) for _, s, e, _, _ in events)
    tids = {t for _, _, _, t, _ in events}
    rows = [
        ("host spans", len(events)),
        (f"host span time ({time_unit})", f"{span_ns / div:.4f}"),
        ("threads", len(tids)),
    ]
    for key, label in (("jit.compile.total", "jit compiles/retraces"),
                       ("static.ops_recorded", "static ops recorded"),
                       ("io.batches", "dataloader batches"),
                       ("amp.scaler.skipped", "amp skipped steps")):
        d = snapshot.get(key)
        if d:
            rows.append((label, d["value"]))
    return _table("OverView", ("Metric", "Value"), rows)


def operator_view(events, snapshot=None, time_unit: str = "ms") -> str:
    ops = [e for e in events if e[0].startswith("op::")]
    body = summary_table(ops, time_unit=time_unit) if ops \
        else "(no op spans recorded)"
    return f"---- OperatorView ----\n{body}"


def memory_view(events, snapshot, time_unit: str = "ms") -> str:
    rows = []
    for name in sorted(snapshot):
        d = snapshot[name]
        base, _ = _split_metric(name)
        if d["kind"] == "gauge" and ("memory" in base or
                                     base.endswith(".bytes_in_use")):
            rows.append((name, _fmt_bytes(d["value"]),
                         _fmt_bytes(d["peak"])))
    # host spans that carried allocation payloads (native tracer mem col)
    mem_spans = defaultdict(int)
    for name, _s, _e, _t, mem in events:
        if mem:
            mem_spans[name] += mem
    for name, total in sorted(mem_spans.items(), key=lambda kv: -kv[1]):
        rows.append((f"span:{name}", _fmt_bytes(total), ""))
    return _table("MemoryView", ("Name", "Current", "Peak"), rows)


def distributed_view(events, snapshot, time_unit: str = "ms") -> str:
    # {(axis, op): [calls, bytes]}
    per = defaultdict(lambda: [0, 0])
    for name, d in snapshot.items():
        base, labels = _split_metric(name)
        if "op" not in labels:
            continue
        key = (labels.get("axis", "?"), labels["op"])
        if base == "comm.ops":
            per[key][0] += d["value"]
        elif base == "comm.bytes":
            per[key][1] += d["value"]
    rows = [(axis, op, calls, _fmt_bytes(nbytes))
            for (axis, op), (calls, nbytes) in
            sorted(per.items(), key=lambda kv: -kv[1][1])]
    return _table("DistributedView", ("Axis", "Op", "Calls", "Bytes"),
                  rows)


_VIEWS = {
    "OverView": overview,
    "OperatorView": operator_view,
    "MemoryView": memory_view,
    "DistributedView": distributed_view,
}


def view_table(view_name: str, events, snapshot,
               time_unit: str = "ms") -> str:
    """Render one SummaryView table by enum name; unknown/legacy views
    (DeviceView, KernelView, ...) fall back to the flat span table."""
    fn = _VIEWS.get(view_name)
    if fn is None:
        return summary_table(events, time_unit=time_unit)
    return fn(events, snapshot, time_unit=time_unit)


def summary_report(events, snapshot, time_unit: str = "ms") -> str:
    """The flat span table plus all four views stacked — what
    Profiler.summary() prints when no specific view is requested and
    metrics were recorded alongside the spans."""
    sections = [summary_table(events, time_unit=time_unit)]
    sections += [fn(events, snapshot, time_unit=time_unit)
                 for fn in (overview, operator_view, memory_view,
                            distributed_view)]
    return "\n\n".join(sections)
