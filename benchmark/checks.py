"""The comparisons that decide ``correct``: the numbers read from the
program's outputs and the reference's, each held to its limit in
``limits/<cell>.json``.

Training (the first steps of the object the window then drives):

- ``loss_gap``: the largest over the compared steps of |loss - reference
  loss| / |reference loss|;
- ``grad_gap``: over the units, the largest gap between the norm of the
  first step's gradient as Adam receives it (the program's worked out from
  its first moment after one step, exp_avg / (1 - beta1)) and the
  reference's, over the larger of the reference's norm of that unit and the
  median unit's;
- ``change_gap``: the same for the norm of each unit's change over the
  compared steps;
- ``route_flip_share`` (MoE): the reference replays the program's routes
  (a bf16 router flips near-ties between two gates, after which no free
  run follows another), so the routing stage is checked by itself: the
  share of the program's (token, choice) routes that differ from the
  reference's own top-k on the replayed trajectory;
- ``route_topk_gap`` (MoE): the stage that the replay takes from the
  program, checked by itself: the share of real tokens (over the compared
  steps and the blocks) that the program dispatched to other experts than
  the top k of its own router gates. Exact: the limit is 0.

A cell's limits file names the numbers it compares; the others are read
and not compared.

Units whose reference gradient is under a thousandth of the median unit's
(the key bias under softmax: nought to rounding) move under Adam by
round-off alone; they are left out of both gaps, by that rule and not by
name.

Serving, over every answered request and class, the gap |p - q| / q of a
class probability p against the reference's q for the request's clip:
``prob_gap`` the largest, ``prob_mean_gap`` the mean (steady from seed to
seed, where the largest of some 400,000 swings).
"""

from __future__ import annotations

import statistics

import numpy as np

SETTLED = 1e-3   # a unit counts when its reference gradient is this share of the median's


def _gaps(prog: dict[str, float], ref: dict[str, float], units: list[str]) -> list[float]:
    med = statistics.median(ref[u] for u in units)
    return [abs(prog[u] - ref[u]) / max(ref[u], med) for u in units]


def train_readings(prog: dict, ref: dict) -> dict[str, float]:
    """``prog`` and ``ref``: {"losses": [...], "grad": {unit: norm},
    "change": {unit: norm}}; with MoE blocks the program's
    ``route_topk_gap`` and the reference's ``route_flip_share`` too."""
    if set(prog["grad"]) != set(ref["grad"]):
        raise ValueError("the program's units are not the reference's: "
                         f"{sorted(set(prog['grad']) ^ set(ref['grad']))[:4]}")
    med = statistics.median(ref["grad"].values())
    units = [u for u, g in ref["grad"].items() if g >= SETTLED * med]
    out = {k: side[k] for k, side in (("route_topk_gap", prog), ("route_flip_share", ref))
           if k in side}
    return {
        **out,
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])),
        "grad_gap": max(_gaps(prog["grad"], ref["grad"], units)),
        "change_gap": max(_gaps(prog["change"], ref["change"], units)),
    }


def serve_readings(answers: np.ndarray, clip_of: np.ndarray, ref_probs: np.ndarray
                   ) -> dict[str, float]:
    """``answers`` (n, C) of the answered requests, ``clip_of`` (n,) their
    clips, ``ref_probs`` (pool, C) the reference's."""
    q = ref_probs[clip_of]
    gap = np.abs(answers - q) / q
    return {"prob_gap": float(gap.max()), "prob_mean_gap": float(gap.mean())}


def judge(readings: dict[str, float], limits: dict) -> tuple[bool, dict]:
    """(every reading that ``limits`` names within its limit, {name:
    {"value", "limit"}} of those); the others are not compared."""
    checks = {n: {"value": readings[n], "limit": lim["limit"]} for n, lim in limits.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
