"""The numbers that decide ``correct``, each held to its cell's limit
(``rtbench/limits/<cell>.json``)."""
from __future__ import annotations

import statistics

import torch

OFF = 1e-3            # a checked pixel is off when a channel differs by more
ZERO_GRAD = 1e-3      # leaves under this share of the median leaf's gradient norm do not count


def frame_numbers(program: torch.Tensor, reference: torch.Tensor) -> dict:
    """Served pixels (n, 3) against the reference's: the share of pixels off
    by more than ``OFF`` in a channel, and the mean of each pixel's largest
    channel gap."""
    d = (program.double() - reference.double()).abs().amax(dim=1)
    return {"px_off_share": float((d > OFF).double().mean()), "px_mean_gap": float(d.mean())}


def fit_numbers(program: dict, reference: dict) -> dict:
    """A fit's first steps against the reference's, each a dict of
    ``losses`` (list), ``grad1`` and ``change`` (leaf name -> tensor): the
    largest relative loss gap; and, by the worst leaf, the gap between the
    program's and the reference's norms of the first gradient and of the
    change after the steps, over the reference's norm of that leaf or of the
    median leaf, whichever is larger. Leaves whose reference gradient is
    under ``ZERO_GRAD`` of the median leaf's move by round-off alone and do
    not count."""
    loss_gap = max(abs(float(p) - float(r)) / abs(float(r))
                   for p, r in zip(program["losses"], reference["losses"]))
    gr = {k: float(torch.linalg.vector_norm(v.double())) for k, v in reference["grad1"].items()}
    med_g = statistics.median(gr.values())
    counted = [k for k in gr if gr[k] >= ZERO_GRAD * med_g]

    def worst(key: str) -> float:
        r = {k: float(torch.linalg.vector_norm(reference[key][k].double())) for k in counted}
        p = {k: float(torch.linalg.vector_norm(program[key][k].double())) for k in counted}
        med = statistics.median(r.values())
        return max(abs(p[k] - r[k]) / max(r[k], med) for k in counted)

    return {"loss_gap": loss_gap, "grad_gap": worst("grad1"), "change_gap": worst("change")}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number that is not finite fails."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(v == v and v <= limits[k] for k, v in numbers.items())
    return ok, checks
