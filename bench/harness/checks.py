"""The numbers that decide `correct`, and their limits.

Training (the first `check_steps` steps of the timed path against the
reference's):
  loss1_gap   |loss - reference loss| at the first step, nats (inf where
              the program ran another number of steps or a loss is not
              finite; PERF.md says why the first step's and not each
              step's);
  grad_gap    the worst leaf's |‖g‖ - ‖g_ref‖| / max(‖g_ref‖, the
              median leaf's ‖g_ref‖), g the first gradient as the
              optimizer takes it;
  change_gap  the same of each leaf's change after the steps, over the
              leaves whose reference gradient is at least a thousandth of
              the median leaf's (those under it move by round-off alone).
Serving:
  logit_gap   the widest gap by which a served token's reference logit
              lies below the reference's best at that position.
Each number has its limit in bench/workloads/<cell>.json; a number that
is not finite fails.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Optional, Tuple

NEGLIGIBLE = 1e-3       # of the median leaf's reference gradient norm


def norm_gap(prog: Dict[str, float], ref: Dict[str, float],
             leaves: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """(the worst leaf's relative gap of norms, that leaf)."""
    names = sorted(ref if leaves is None else leaves)
    med = statistics.median(ref[n] for n in ref)
    worst, at = 0.0, ""
    for n in names:
        g = abs(prog[n] - ref[n]) / max(ref[n], med)
        if not math.isfinite(g):
            return math.inf, n
        if g > worst:
            worst, at = g, n
    return worst, at


def moving_leaves(ref_grads: Dict[str, float]):
    med = statistics.median(ref_grads.values())
    return [n for n, g in ref_grads.items() if g >= NEGLIGIBLE * med]


def train_numbers(prog: dict, ref: dict,
                  where: Optional[dict] = None) -> Dict[str, float]:
    """The training numbers of the program's readings `prog` against the
    reference's `ref` (both: losses, grad_norms, changes); `where`, when
    given, gets the leaf that sets each gap of norms."""
    loss1 = abs(prog["losses"][0] - ref["losses"][0])
    if len(prog["losses"]) != len(ref["losses"]) or \
            not all(map(math.isfinite, prog["losses"] + [loss1])):
        loss1 = math.inf
    grad, g_at = norm_gap(prog["grad_norms"], ref["grad_norms"])
    change, c_at = norm_gap(prog["changes"], ref["changes"],
                            moving_leaves(ref["grad_norms"]))
    if where is not None:
        where.update(grad_gap=g_at, change_gap=c_at)
    return {"loss1_gap": loss1, "grad_gap": grad, "change_gap": change}


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}) of the numbers that have a
    limit: every one read and within it."""
    checks = {n: {"value": numbers.get(n, math.inf), "limit": limits[n]}
              for n in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
