"""What `correct` reads back from the program, through the cell's model
(models/<model>.py): the losses of the first steps, each parameter's first
gradient as the optimizer got it (read from the optimizer's state after
one step, with the optimizer's constants as the configuration states
them, not as the program holds them) and each parameter's change after
the first steps.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def gradient_norms(cell, state) -> dict:
    """Each parameter's first gradient norm, from its optimizer's state
    after one step."""
    return {net: {name: float(first_gradient(opt.state[p]).double().norm())
                  for name, p in module.named_parameters()}
            for net, module, opt, first_gradient in cell.model.networks(state, cell.config)}


@torch.no_grad()
def change_norms(cell, state, weights: dict) -> dict:
    return {net: {name: float((p - weights[net][name]).double().norm())
                  for name, p in module.named_parameters()}
            for net, module, _, _ in cell.model.networks(state, cell.config)}


def first_readings(cell, run_chunk, state, weights: dict, steps: int) -> dict:
    """Drive the program through its first `steps` steps through the
    window's own call (`run_chunk(n)`: n steps, the stacked metrics) and
    read what `correct` compares: one step, then the rest."""
    out = {"losses": cell.model.losses_of(run_chunk(1))}
    out["grad_norms"] = gradient_norms(cell, state)
    out["losses"] += cell.model.losses_of(run_chunk(steps - 1))
    out["change_norms"] = change_norms(cell, state, weights)
    return out
