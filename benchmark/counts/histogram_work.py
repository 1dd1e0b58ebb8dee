"""What one call of the fused histogram forward or backward must do, from
its shapes: a frozen copy of palette_and_histo_gan_tpu_torch/ops/
histogram_kernel.py::work with its products taken once (`passes` 1: the
float32 forward's 3xTF32 is a property of one kernel, not of the work).

  products: the FLOP of the matrix products (the forward's H = (Iy Ku)^T
    Kv, the backward's m1 and da; 2 a multiply-add), at the tensor cores'
    rate for the chain's operands: bfloat16's for a bfloat16 chain, TF32's
    for a float32 one (no kernel takes float32 products faster than one
    TF32 pass; the port's forward takes three, its backward float32 FMAs);
  elementwise: the kernel-value chain and the per-pixel sums
    (ELEMENTWISE_OPS a cell), at float32's rate;
  bytes: the float32 inputs (logs and Iy) read once and the output
    written once.
"""

from __future__ import annotations

from .peaks import bound_seconds

# a cell's elementwise operations: the forward's two kernel values (5
# each) and Iy * Ku; the backward's two, the two slope weights and a
# multiply and an add for each of its three sums
ELEMENTWISE_OPS = {"fwd": 2 * 5 + 1, "bwd": 2 * 5 + 2 * 2 + 3 * 2}


def work(direction: str, batch: int, hw: int, size: int, chain: str) -> dict:
    cells = batch * 3 * size * hw  # (image, channel, bin, pixel)
    inputs = 4 * (batch * 3 * hw + batch * hw)  # logs and Iy
    if direction == "fwd":
        products = 2 * cells * size
        moved = inputs + 4 * batch * 3 * size * size
    elif direction == "bwd":
        products = 2 * 2 * cells * size
        moved = inputs + 4 * batch * 3 * size * size + 4 * batch * 4 * hw
    else:
        raise ValueError(f"direction must be 'fwd' or 'bwd', got {direction!r}")
    product_type = "bfloat16" if chain == "bfloat16" else "tf32"
    return {"products": products, "passes": 1, "product_type": product_type,
            "elementwise": ELEMENTWISE_OPS[direction] * cells, "bytes": moved}


def seconds(w: dict) -> float:
    """The work's least time on the card (counts/peaks.py::bound_seconds)."""
    return bound_seconds(w["bytes"], (w["products"], w["product_type"]),
                         (w["elementwise"], "float32"))


def step_floor_seconds(batch: int, size: int, chain: str, hw: int) -> float:
    """A histogram train step's least time: two forwards (real and fake)
    and one backward (fake) over the batch of `hw` pixels an image."""
    return (2 * seconds(work("fwd", batch, hw, size, chain))
            + seconds(work("bwd", batch, hw, size, chain)))
