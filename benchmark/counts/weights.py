"""The initial weights of a model's networks, made by the benchmark from the
run's seed, on the device: the leaves that a model's parameter_shapes
(models/<model>.py) draws from a normal come from one draw a standard
deviation, in the leaves' order; every other leaf, parameter or buffer, is
filled with its number. The program gets them loaded into its modules, the
reference a copy."""

from __future__ import annotations

import math

import torch


def draw(shapes: dict, seed: int, device) -> dict:
    """{network: {name: tensor}} of `shapes`, {network: [(name, shape, init)
    or (name, shape, init, dtype)]}, `init` ("normal", std) or a fill."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {net: {} for net in shapes}
    normal = {}  # std: [(network, name, shape)]
    for net, items in shapes.items():
        for name, shape, init, *dtype in items:
            if isinstance(init, tuple):
                if init[0] != "normal":
                    raise ValueError(f"{net}/{name}: init {init!r}; ('normal', std) or a number")
                normal.setdefault(init[1], []).append((net, name, shape))
            else:
                out[net][name] = torch.full(shape, init, device=device,
                                            dtype=getattr(torch, dtype[0] if dtype else "float32"))
    for std, drawn in normal.items():
        flat = torch.empty(sum(math.prod(s) for _, _, s in drawn), device=device)
        flat.normal_(0.0, std, generator=gen)
        offset = 0
        for net, name, shape in drawn:
            n = math.prod(shape)
            out[net][name] = flat[offset:offset + n].view(shape)
            offset += n
    return {net: {item[0]: out[net][item[0]] for item in items} for net, items in shapes.items()}
