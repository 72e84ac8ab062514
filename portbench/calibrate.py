"""The readings that the limits of ``cells/<cell>.json`` are set from: the
check's numbers for the program, for its lower-precision control, for the
faults a run must fail, and for witnesses, on many seeds in one process
(set-up once).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 [--control 1,2] [--faults 1,2] [--witnesses 1,2]

For each seed it makes the cell's inputs as a run does, runs the first
``check_calls`` of them through the timed path's own loop, and compares
them with the plain reference as a run's check does. The control, the
faults and the witnesses are the kind's (``kinds/<kind>.py``: ``CONTROL``,
``faults``, ``witnesses``), planted in place of its timed entry. One JSON
line a seed and reading on standard output.
"""
import argparse
import contextlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import harness, program  # noqa: E402
from portbench.faults import replaced  # noqa: E402


def plantings(plan) -> dict:
    """{name: (entry, wrapper)}: the control, the faults and the witnesses
    of the plan's kind."""
    calls = plan.calls
    out = {"control": calls.CONTROL, **calls.faults(plan.config)}
    out.update(getattr(calls, "witnesses", lambda config: {})(plan.config))
    return out


def worst(per_record: list) -> dict:
    return {k: max(r[k] for r in per_record) for k in per_record[0]}


def reading(plan, gate, seed, device, kind="program"):
    """The worst of each check number over the seed's checked calls, for
    the program (``kind`` "program") or a planting of ``plantings(plan)``."""
    pool = harness.prepared(plan, harness.make_pool(plan, seed, device))
    n = min(plan.traffic["check_calls"], len(pool))
    keeper = harness.Keeper(n, seed)
    ctx = (contextlib.nullcontext() if kind == "program"
           else replaced(plan.calls, *plantings(plan)[kind]))
    with ctx:
        harness.run_calls(plan, gate, pool, device, count=n, keeper=keeper)
    return worst(harness.readings(plan, keeper.kept, pool))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="", help="seeds of the program's readings")
    p.add_argument("--control", default="", help="seeds of the control's")
    p.add_argument("--faults", default="", help="seeds of each fault's")
    p.add_argument("--witnesses", default="", help="seeds of each witness's")
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    seeds = lambda s: [int(v) for v in s.split(",") if v]
    plan = harness.load_plan(args.workload, ROOT)
    device = torch.device(args.device)
    gate = program.build(plan.config, device)
    witnesses = getattr(plan.calls, "witnesses", lambda config: {})(plan.config)
    jobs = [(s, "program") for s in seeds(args.seeds)] + \
        [(s, "control") for s in seeds(args.control)] + \
        [(s, f) for s in seeds(args.faults) for f in plan.calls.faults(plan.config)] + \
        [(s, w) for s in seeds(args.witnesses) for w in witnesses]
    for seed, kind in jobs:
        t0 = time.perf_counter()
        r = reading(plan, gate, seed, device, kind)
        print(json.dumps({"cell": plan.name, "seed": seed, "kind": kind, "readings": r,
                          "seconds": round(time.perf_counter() - t0, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
