"""The initial weights of both networks, made by the benchmark from the
run's seed, on the device, in one draw: every conv kernel N(0, 0.02) (the
published initializer), norm scales 1, norm offsets and biases 0. The
program gets them loaded into its modules, the reference a copy."""

from __future__ import annotations

import math

import torch

from ..reference.nets import parameter_shapes


def draw(config: dict, seed: int, device) -> dict:
    shapes = parameter_shapes(config)
    kernels = [(net, name, shape) for net, items in shapes.items()
               for name, shape, kind in items if kind == "kernel"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.empty(sum(math.prod(s) for _, _, s in kernels), device=device)
    flat.normal_(0.0, config["network"]["init_std"], generator=gen)
    out = {net: {} for net in shapes}
    offset = 0
    for net, name, shape in kernels:
        n = math.prod(shape)
        out[net][name] = flat[offset:offset + n].view(shape)
        offset += n
    for net, items in shapes.items():
        for name, shape, kind in items:
            if kind != "kernel":
                fill = 1.0 if kind == "scale" else 0.0
                out[net][name] = torch.full(shape, fill, device=device)
    return {net: {name: out[net][name] for name, _, _ in items} for net, items in shapes.items()}
