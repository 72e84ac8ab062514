"""The check: a sound run is correct; its lower-precision control and
every fault the cell can have, planted under a whole run that skips only
the look for a card, come out not correct."""
import time

import pytest
import torch

from portbench import calibrate, check, harness, program
from portbench.faults import replaced

from ._small import CELLS, small_plan

SEED = 2**31 + 77


def _run(plan):
    return harness.run_cell(plan, SEED, 0.2, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    r = _run(small_plan(cell))
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_bf16_control_is_not_correct(cell):
    plan = small_plan(cell)
    gate = program.build(plan.config, torch.device("cpu"))
    reading = calibrate.reading(plan, gate, SEED, torch.device("cpu"), "control")
    correct, failed, _ = check.judge(plan.limits, [reading])
    assert not correct and failed == 1


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS for f in small_plan(c).calls.faults(small_plan(c).config)])
def test_a_planted_fault_is_not_correct(cell, fault):
    plan = small_plan(cell)
    name, breaker = plan.calls.faults(plan.config)[fault]
    with replaced(plan.calls, name, breaker):
        r = _run(plan)
    assert not r["correct"] and r["failed"] >= 1


@pytest.mark.gpu
def test_a_cell_runs_correct_on_the_card():
    """The whole command on the card, a short window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json
    import subprocess
    import sys

    from ._small import ROOT

    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "tg8k_ns_batch",
                          "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
