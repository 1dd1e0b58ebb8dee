"""Faults planted in the program under test, for the benchmark's own tests
and for calibrate.py's readings of what `correct` must refuse. The run
plants none unless its --plant-fault option names one.

  unchanged_state: the optimizer's step leaves the parameters and its
    moments as they were (a step that returns its state unchanged);
  half_batch: the train step takes the first half of its batch, the loss
    means over those rows (planted by the cell's model, models/<model>.py);
  no_exchange: the gradients are not averaged over the ranks;
  wrong_beta1: KerasAdam runs with beta1 0.9 whatever the configuration
    states (0.5 in pix2pix's): a first gradient decoded from its first
    moment with the configuration's beta1 reads 0.2 of the true one.
"""

from __future__ import annotations

FAULTS = ("unchanged_state", "half_batch", "no_exchange", "wrong_beta1")
WRONG_BETA1 = 0.9


def plant(name: str, model) -> None:
    from palette_and_histo_gan_tpu_torch.train import state, steps

    if name == "unchanged_state":
        state.KerasAdam.step = lambda self, closure=None: None
    elif name == "half_batch":
        model.plant_half_batch()
    elif name == "no_exchange":
        steps._average_gradients = lambda group, *modules: None
    elif name == "wrong_beta1":
        init = state.KerasAdam.__init__

        def wrong(self, params, lr=2e-4, betas=(0.5, 0.999), eps=1e-7):
            init(self, params, lr=lr, betas=(WRONG_BETA1, betas[1]), eps=eps)

        state.KerasAdam.__init__ = wrong
    else:
        raise ValueError(f"fault {name!r}; one of {FAULTS}")
