"""Cells cut to sizes the CPU tests can hold (the port's plain versions)."""
import pathlib

from portbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = ("tg8k_ns_batch", "tg8k_st_batch", "tg8k_ns_train", "tg8k_ns_long")
SMALL = {
    "gate_batch": dict(rows=3, seconds=1.0, pool=2, warmup_calls=1, check_calls=2),
    "train": dict(rows=4, seconds=1.0, pool=2, warmup_calls=1, check_calls=2),
    "gate_long": dict(rows=2, seconds=12.0, chunk_size=40000, padding=4000, pool=2,
                      warmup_calls=1, check_calls=1),
}


def small_plan(cell: str, root=ROOT):
    plan = harness.load_plan(cell, root)
    plan.traffic.update(SMALL[plan.kind])
    return plan
