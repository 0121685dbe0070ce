"""The numbers that decide ``correct``: gaps between answers and the
reference's, each beside its limit."""

from __future__ import annotations

import torch


def gap_stats(answer: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(99th percentile, mean) of |answer - ref| over every element, in
    float64."""
    d = (answer.to(torch.float64) - ref.to(torch.float64)).abs().flatten()
    if d.numel() == 0:
        return 0.0, 0.0
    if not bool(torch.isfinite(d).all()):
        return float("inf"), float("inf")
    k = max(1, int(round(0.99 * d.numel())))
    p99 = float(torch.kthvalue(d.cpu(), k).values)
    return p99, float(d.mean())


def checks(values: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every limit; a value that is missing
    or not finite reads as infinite."""
    out = {}
    for name, limit in limits.items():
        v = values.get(name, float("inf"))
        v = float(v) if v == v else float("inf")
        out[name] = {"value": v, "limit": float(limit)}
    return out
