"""The run's import guard: the measured program is the PyTorch port, and
neither JAX nor the JAX package may be loaded in a process of the run.
Module names are compared by their top-level part, whole: the port's name
begins with the JAX package's."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "palette_and_histo_gan_tpu")


def loaded(forbidden=FORBIDDEN) -> list[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(forbidden))


def check(when: str) -> None:
    found = loaded()
    if found:
        print(f"import guard ({when}): {', '.join(found)} loaded in the run's process",
              file=sys.stderr, flush=True)
        raise SystemExit(3)
