"""The numbers that decide `correct`, from the program's readings and the
reference's (reference/step.py::train's form), and their limits.

Parameters whose first-step gradient is under a thousandth of their
network's median reference gradient on both sides, the program's and the
reference's ("quiet"), are left out of the gradient and change numbers:
their exact gradient is nought (the U-Net's 1x1 bottleneck, where
instance norm over one pixel returns its offset), so what they read is
round-off, which Adam turns into a full step. A parameter that the
program moves and the reference leaves at nought is counted, and reads
its whole gradient as its gap.

  loss_gap: the largest relative gap, |program - reference| / |reference|,
    of any step's generator or discriminator loss;
  grad_gap: the worst parameter's gap between the norms of the first
    step's gradient, |norm_p - norm_r| / max(norm_r, the network's median
    norm_r) (the gap of the norms, not the norm of the difference);
  change_gap: the same of each parameter's change over the steps;
  nonfinite: the window's steps whose losses are not finite (limit 0).
"""

from __future__ import annotations

import math
import statistics

NUMBERS = ("loss_gap", "grad_gap", "change_gap", "nonfinite")
QUIET_GRADIENT = 1e-3


def _gaps(prog: dict, ref: dict, counted) -> dict:
    """{net: [gap of each counted parameter]}."""
    out = {}
    for net, norms in ref.items():
        median = statistics.median(norms.values())
        out[net] = [abs(prog[net][name] - r) / max(r, median, 1e-30)
                    for name, r in norms.items() if counted(net, name)]
    return out


def _worst(gaps: dict) -> float:
    values = [g for gs in gaps.values() for g in gs]
    return math.nan if any(map(math.isnan, values)) else max(values)


def counted_parameters(prog: dict, ref: dict):
    grads, prog_grads = ref["grad_norms"], prog["grad_norms"]
    medians = {net: statistics.median(norms.values()) for net, norms in grads.items()}

    def counted(net, name):
        floor = QUIET_GRADIENT * medians[net]
        return not (grads[net][name] < floor and prog_grads[net][name] < floor)

    return counted


def numbers(prog: dict, ref: dict, nonfinite: int = 0) -> dict:
    loss_gap = 0.0
    for p_step, r_step in zip(prog["losses"], ref["losses"], strict=True):
        for p, r in zip(p_step, r_step, strict=True):
            gap = abs(p - r) / max(abs(r), 1e-30)
            loss_gap = gap if not math.isfinite(gap) else max(loss_gap, gap)
    counted = counted_parameters(prog, ref)
    return {
        "loss_gap": loss_gap,
        "grad_gap": _worst(_gaps(prog["grad_norms"], ref["grad_norms"], counted)),
        "change_gap": _worst(_gaps(prog["change_norms"], ref["change_norms"], counted)),
        "nonfinite": float(nonfinite),
    }


def worst_parameters(prog: dict, ref: dict, key: str, top: int = 4) -> list:
    """The counted parameters with the largest gaps of `key` ("grad_norms"
    or "change_norms"): [[net/name, gap, program, reference], ...]."""
    counted = counted_parameters(prog, ref)
    rows = []
    for net, norms in ref[key].items():
        median = statistics.median(norms.values())
        rows += [[f"{net}/{name}", abs(prog[key][net][name] - r) / max(r, median, 1e-30),
                  prog[key][net][name], r] for name, r in norms.items() if counted(net, name)]
    return sorted(rows, key=lambda row: -row[1])[:top]


def quiet_parameters(prog: dict, ref: dict) -> list[str]:
    """The parameters the gradient and change numbers leave out."""
    counted = counted_parameters(prog, ref)
    return [f"{net}/{name}" for net, norms in ref["grad_norms"].items() for name in norms
            if not counted(net, name)]


def reference_quiet(prog: dict, ref: dict) -> list:
    """The parameters whose reference gradient is under the quiet floor, with
    both sides' first gradient norms: [[net/name, program, reference], ...]."""
    grads = ref["grad_norms"]
    rows = []
    for net, norms in grads.items():
        floor = QUIET_GRADIENT * statistics.median(norms.values())
        rows += [[f"{net}/{name}", prog["grad_norms"][net][name], r]
                 for name, r in norms.items() if r < floor]
    return rows


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): each number within its limit
    (a NaN is never within)."""
    checks = {name: {"value": values[name], "limit": limits[name]["limit"]} for name in NUMBERS}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
