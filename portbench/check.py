"""The comparison that decides ``correct``: the gaps between the program's
outputs and the plain reference's, and the verdict against a cell's limits
(``cells/<cell>.json``). Each kind of call (``kinds/<kind>.py``) picks the
gaps it reads.
"""
from __future__ import annotations

import torch

from portbench.reference import torchgate as ref

REF_BLOCK_ROWS = 32  # rows (or chunk views) the reference takes at once


def finite(value: float) -> float:
    return value if value == value and abs(value) != float("inf") else float("inf")


def row_gaps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """||got - want|| / ||want|| of each row, float64; inf where not finite
    or where the shapes differ."""
    if got is None or got.shape != want.shape:
        return torch.full(want.shape[:1], float("inf"), dtype=torch.float64)
    d = (got.double() - want.double()).norm(dim=-1) / want.double().norm(dim=-1)
    return torch.where(torch.isfinite(d), d, torch.full_like(d, float("inf"))).cpu()


def norm_gaps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """| ||got|| - ||want|| | of each row over the larger of ||want|| and
    the median row's ||want||, float64 (the gap of norms, not the norm of
    the gap); inf where not finite."""
    g, w = got.double().norm(dim=-1), want.double().norm(dim=-1)
    d = (g - w).abs() / torch.maximum(w, w.median())
    return torch.where(torch.isfinite(d), d, torch.full_like(d, float("inf"))).cpu()


def reference_rows(cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """The reference's output of every row of ``x``, in blocks of rows."""
    return torch.cat([ref.gate(x[i:i + REF_BLOCK_ROWS], cfg)
                      for i in range(0, x.shape[0], REF_BLOCK_ROWS)])


def judge(limits: dict, per_record: list):
    """(correct, failed, checks): every number of every record within its
    limit; the records over a limit; each number, the worst over the
    records, beside its limit."""
    worst = lambda name: max((r.get(name, float("inf")) for r in per_record),
                             default=float("inf"))
    checks = {name: {"value": worst(name), "limit": lim} for name, lim in limits.items()}
    failed = sum(any(not r.get(n, float("inf")) <= lim for n, lim in limits.items())
                 for r in per_record)
    return failed == 0 and bool(per_record), failed, checks
