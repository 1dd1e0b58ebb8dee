"""Faults planted in the program under test, for the benchmark's own tests
and for calibrate.py's readings of what `correct` must refuse. The run
plants none unless its --plant-fault option names one.

  unchanged_state: the optimizer's step leaves the parameters and its
    moments as they were (a step that returns its state unchanged);
  half_batch: the train step takes the first half of its batch, the loss
    means over those rows;
  no_exchange: the gradients are not averaged over the ranks.
"""

from __future__ import annotations

FAULTS = ("unchanged_state", "half_batch", "no_exchange")


def plant(name: str) -> None:
    from palette_and_histo_gan_tpu_torch.train import state, steps

    if name == "unchanged_state":
        state.KerasAdam.step = lambda self, closure=None: None
    elif name == "half_batch":
        for attr in ("rgba_train_step", "indexed_train_step"):
            original = getattr(steps, attr)

            def halved(config, st, source, target, group=None, _step=original):
                half = source.shape[0] // 2
                return _step(config, st, source[:half], target[:half], group)

            setattr(steps, attr, halved)
    elif name == "no_exchange":
        steps._average_gradients = lambda group, *modules: None
    else:
        raise ValueError(f"fault {name!r}; one of {FAULTS}")
