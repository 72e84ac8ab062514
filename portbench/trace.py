"""Reading a ``torch.profiler`` trace: the device's busy time, each port
kernel's device time, the rest (glue), the longest idle gaps by what the
host was doing, and whether the trace holds every launch the program
counted.

The trace is the Chrome-trace JSON that ``export_chrome_trace`` writes:
complete events (``"ph": "X"``) with ``ts`` and ``dur`` in microseconds.
Device operations are the kernels, copies and memsets; the traced window
is the host annotation ``WINDOW`` around the traced calls and the
synchronize after them.
"""
from __future__ import annotations

import bisect
import dataclasses
import re

WINDOW = "portbench.window"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver", "user_annotation"}
TOP = 10


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    device_s: float            # every device operation's time, summed
    family_s: dict             # kernels.json name -> device seconds
    family_n: dict             # kernels.json name -> device launches
    glue_s: float              # device operations of no kernels.json entry
    ops: list                  # [(name, seconds)], most time first
    gaps: list                 # [(host activity, seconds)], longest first


def short_name(name: str) -> str:
    """A kernel's base name: ``void f<...>(...)`` -> ``f``."""
    name = name.removeprefix("void ")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


def _window(events):
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") == WINDOW:
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    raise ValueError(f"the trace has no {WINDOW} annotation")


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _host_at(host, starts, t, scan=512):
    """The innermost host event running at ``t``: the latest started of
    those that contain it, among the ``scan`` that started last before it;
    past those, the benchmark's own loop (``WINDOW``: Python between
    operations)."""
    i = bisect.bisect_right(starts, t)
    for a, b, name in reversed(host[max(0, i - scan):i]):
        if b >= t and name != WINDOW:
            return name
    return WINDOW


def _top(totals: dict):
    return sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]


def summarize(trace: dict, kernels: dict) -> Summary:
    """The summary of ``trace`` within its window; ``kernels``: the
    ``kernels.json`` table (each entry's ``symbols`` a regular expression)."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    w0, w1 = _window(events)
    dev = [e for e in events
           if e.get("cat") in DEVICE_CATS and w0 <= float(e["ts"]) <= w1]
    pats = {name: re.compile(k["symbols"]) for name, k in kernels.items()}
    family_s = dict.fromkeys(kernels, 0.0)
    family_n = dict.fromkeys(kernels, 0)
    ops, glue_us, device_us = {}, 0.0, 0.0
    for e in dev:
        us = float(e["dur"])
        device_us += us
        base = short_name(e["name"])
        ops[base] = ops.get(base, 0.0) + us * 1e-6
        fam = next((n for n, p in pats.items()
                    if e.get("cat") == "kernel" and p.search(e["name"])), None)
        if fam is None:
            glue_us += us
        else:
            family_s[fam] += us * 1e-6
            family_n[fam] += 1
    busy = _merge((max(w0, float(e["ts"])), min(w1, float(e["ts"]) + float(e["dur"])))
                  for e in dev)
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                   for e in events if e.get("cat") in HOST_CATS),
                  key=lambda h: (h[0], -h[1]))  # of equal starts, the enclosing first
    starts = [h[0] for h in host]
    gaps, edge = {}, w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            label = _host_at(host, starts, 0.5 * (edge + a))
            gaps[label] = gaps.get(label, 0.0) + (a - edge) * 1e-6
        edge = max(edge, b)
    return Summary(window_s=(w1 - w0) * 1e-6,
                   busy_s=sum(b - a for a, b in busy) * 1e-6,
                   device_s=device_us * 1e-6, family_s=family_s, family_n=family_n,
                   glue_s=glue_us * 1e-6, ops=_top(ops), gaps=_top(gaps))


def missing_launches(summary: Summary, calls: dict, launches: int) -> dict:
    """What the trace lacks against the program's launch counters over the
    same calls: {kernel: (in the trace, counted)} for each kernel with
    fewer device launches than calls of its wrapper (``calls``), and
    ``"all kernels"`` where the port's kernels together have fewer than
    the CUDA launches counted (``launches``; a mask kernel's wrapper call
    runs several, some of them shared passes)."""
    out = {name: (summary.family_n.get(name, 0), n) for name, n in calls.items()
           if summary.family_n.get(name, 0) < n}
    total = sum(summary.family_n.values())
    if total < launches:
        out["all kernels"] = (total, launches)
    return out
