"""One run of one cell: inputs from the seed, warm-up, the measured window,
an optional traced segment, the check against the plain reference, and the
result line.

Everything a cell is comes from files found by name: the workload entry of
``BENCHMARK.json`` names its configuration (``configs/<config>.json``) and
traffic mix (``traffic/<traffic>.json``); ``cells/<cell>.json`` holds the
limits of its check; each metric is read by ``metrics/<metric>.py``; the
kernels' symbols and work are in ``kernels.json``. The mix's ``kind`` names
the module of the call, ``kinds/<kind>.py``, which holds the timed entry
into the program and what the check reads:

- ``STAMPS``: names of the device-clock intervals of a call;
- ``step(gate, x, clean, traffic, mark)``: one call, ``mark()`` before,
  between and after the intervals; returns the record the check keeps;
- ``readings(cfg, traffic, x, clean, record)``: the numbers compared;
- ``CONTROL``, ``faults(config)``, ``witnesses(config)``: (entry, wrapper)
  pairs of ``faults.py`` that ``calibrate.py`` and the tests plant;
- optionally ``prepare(x, clean)``: the form a call takes its input in,
  made before the window (else as made on the card).
"""
from __future__ import annotations

import collections
import dataclasses
import importlib.util
import json
import pathlib
import sys
import tempfile
import time

import numpy as np
import torch

from portbench import check, gen, program, roofline, trace
from portbench.reference import torchgate as ref

HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "noisereduce_tpu"}


@dataclasses.dataclass
class Plan:
    name: str
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    kernels: dict
    root: pathlib.Path
    calls: object  # the module kinds/<kind>.py

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind_module(kind: str, root: pathlib.Path = HERE.parent):
    """``kinds/<kind>.py`` under ``root``; a kind with no module is refused."""
    path = root / "portbench" / "kinds" / f"{kind}.py"
    if not path.is_file():
        known = sorted(p.stem for p in path.parent.glob("*.py"))
        raise KeyError(f"no module for the traffic kind {kind!r}: {known}")
    return _module(path, f"portbench_kind_{kind}")


def load_plan(name: str, root: pathlib.Path = HERE.parent) -> Plan:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its files."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[cell["config"]]["file"])
    traffic = _json(root / "portbench" / "traffic" / f"{cell['traffic']}.json")
    limits = _json(root / "portbench" / "cells" / f"{name}.json")["limits"]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    kernels = _json(root / "portbench" / "kernels.json")
    return Plan(name, cell, config, traffic, limits, e2e, per_layer, kernels, root,
                kind_module(traffic["kind"], root))


def reader(plan: Plan, metric: str):
    """``read(ctx)`` of ``metrics/<metric>.py``."""
    return _module(plan.root / "portbench" / "metrics" / f"{metric}.py",
                   f"portbench_metric_{metric}").read


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------
def make_pool(plan: Plan, seed: int, device) -> list:
    """The mix's distinct inputs, (noisy, clean) pairs of (rows, samples),
    made on ``device`` from ``seed``, the noisy rows in the configuration's
    dtype; the calls take them in turn."""
    t, sr = plan.traffic, plan.config["gate"]["sr"]
    g = gen.generator(seed, device)
    n = round(t["seconds"] * sr)
    dtype = getattr(torch, plan.config["dtype"])
    pool = []
    for _ in range(t["pool"]):
        x, clean = gen.rows(g, t["signal"], t["rows"], n, sr, device)
        pool.append((x.to(dtype), clean))
    return pool


class Keeper:
    """A uniform sample of ``k`` of the window's calls, drawn from the
    seed (reservoir sampling): the outputs the check compares."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.kept = k, np.random.default_rng(seed % (1 << 63)), []

    def offer(self, i: int, record) -> None:
        if i < self.k:
            self.kept.append(record)
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < self.k:
                self.kept[j] = record


class _HostEvent:
    """A CUDA event's surface on the CPU, where the tests run a cell."""

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


def _event(device):
    return torch.cuda.Event(enable_timing=True) if device.type == "cuda" else _HostEvent()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# the calls: the kind's step, until ``count`` calls or ``seconds`` have passed
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Window:
    calls: int = 0
    seconds: float = 0.0
    spans: list = dataclasses.field(default_factory=list)     # host issue s a call
    event_ms: dict = dataclasses.field(default_factory=dict)  # STAMPS name -> ms a call


class _Marks(list):
    """The events ``step`` records, one a ``mark()``; ``issue_s``: host
    seconds from the end of the first mark to the start of the last, the
    call's own issue without the events'."""

    def __init__(self, device):
        super().__init__()
        self.device, self.first_end, self.last_start = device, None, None

    def __call__(self):
        self.last_start = time.perf_counter()
        e = _event(self.device)
        e.record()
        self.append(e)
        if self.first_end is None:
            self.first_end = time.perf_counter()

    @property
    def issue_s(self) -> float:
        return self.last_start - self.first_end


def run_calls(plan, gate, pool, device, seconds=None, count=None, keeper=None) -> Window:
    """Calls of the kind's ``step`` on the pool's inputs in turn, ``in_flight``
    of them queued on the card at once, until ``count`` calls or ``seconds``
    have passed; the window ends on a synchronize after the last call."""
    calls, t = plan.calls, plan.traffic
    w, flight, stamps = Window(), collections.deque(), []
    depth = t.get("in_flight", 1)
    t0 = time.perf_counter()
    while (count is None or w.calls < count) and (
            seconds is None or time.perf_counter() - t0 < seconds):
        j = w.calls % len(pool)
        marks = _Marks(device)
        record = calls.step(gate, *pool[j][2], t, marks)
        w.spans.append(marks.issue_s)
        stamps.append(marks)
        if keeper is not None:
            keeper.offer(w.calls, (j, record))
        w.calls += 1
        flight.append(marks[-1])
        if len(flight) >= depth:
            flight.popleft().synchronize()
    _sync(device)
    w.seconds = time.perf_counter() - t0
    w.event_ms = {name: [m[k].elapsed_time(m[k + 1]) for m in stamps]
                  for k, name in enumerate(calls.STAMPS)}
    return w


def prepared(plan, pool) -> list:
    """The pool with each input also in the form its calls take it:
    (noisy, clean, (x, clean) as ``step`` takes them)."""
    prep = getattr(plan.calls, "prepare", lambda x, clean: (x, clean))
    return [(x, clean, prep(x, clean)) for x, clean in pool]


def _traced(plan, gate, pool, device):
    """Profile ``trace_calls`` calls: (summary, calls, launches missing
    from the trace)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    wrappers = [k["wrapper"] for k in plan.kernels.values() if k["wrapper"]]
    n = plan.traffic["trace_calls"]
    _sync(device)
    program.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(trace.WINDOW):
                run_calls(plan, gate, pool, device, count=n)
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        raw = _json(path)
    counted = program.launches(wrappers)
    calls = {name: counted[k["wrapper"]][0] for name, k in plan.kernels.items() if k["wrapper"]}
    summary = trace.summarize(raw, plan.kernels)
    return summary, n, trace.missing_launches(summary, calls,
                                              sum(c for _, c in counted.values()))


# ---------------------------------------------------------------------------
# the check against the plain reference
# ---------------------------------------------------------------------------
def readings(plan: Plan, kept: list, pool: list) -> list:
    """The numbers the check compares (``kinds/<kind>.py``'s ``readings``)
    for each (pool index, record) of ``kept``; the reference takes the
    inputs in float32, TF32 off."""
    cfg = plan.config["gate"]
    with ref.no_tf32():
        return [plan.calls.readings(cfg, plan.traffic, pool[j][0].float(), pool[j][1], rec)
                for j, rec in kept]


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------
def run_cell(plan: Plan, seed: int, seconds: float, traced: bool, device,
             t_process: float) -> dict:
    """One run; returns the result line's object (``checks`` last)."""
    device = torch.device(device)
    t = plan.traffic
    gate = program.build(plan.config, device)
    pool = prepared(plan, make_pool(plan, seed, device))
    run_calls(plan, gate, pool, device, count=t["warmup_calls"])
    keeper = Keeper(t["check_calls"], seed)
    setup_s = time.perf_counter() - t_process
    w = run_calls(plan, gate, pool, device, seconds=seconds, keeper=keeper)
    summary = trace_calls = missing = None
    if traced:
        summary, trace_calls, missing = _traced(plan, gate, pool, device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del gate
    correct, failed, checks = check.judge(plan.limits, readings(plan, keeper.kept, pool))
    if missing:
        correct = False
        print(f"the trace lost launches (in the trace, counted): {missing}", file=sys.stderr)
    ctx = Context(plan=plan, shapes=roofline.shapes(plan.config, t, pool[0][0].element_size()),
                  setup_s=setup_s, window=w, summary=summary, trace_calls=trace_calls)
    metrics = {}
    for m in (plan.per_layer if traced else plan.end_to_end):
        value = reader(plan, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": w.calls,
              "failed": failed, "metrics": metrics,
              "device": device_info(plan, device, peak, summary)}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary.ops, "idle_gaps": summary.gaps}
    result["checks"] = checks
    return result


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""
    plan: Plan
    shapes: dict
    setup_s: float
    window: Window
    summary: trace.Summary = None
    trace_calls: int = None

    @property
    def audio_s_per_call(self) -> float:
        """Channel-seconds of audio one call (or step) takes in."""
        return self.plan.traffic["rows"] * self.plan.traffic["seconds"]


def device_info(plan, device, peak, summary) -> dict:
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": plan.cell["chips"], "memory_peak_bytes": int(peak)}
    if summary is not None:
        info["busy_s"], info["window_s"] = summary.busy_s, summary.window_s
    return info


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
