"""The weight bridge: a Flax parameter tree (as numpy) to the port's
`state_dict`s, for the generator and the discriminator.

The tree is what the JAX package's `create_train_state` holds (its
`g_params` / `d_params`), or what `palette_and_histo_gan_tpu/models/
convert.py` builds from the reference's canonical TF names.

Layouts:
  * Conv (flax nn.Conv, kernel (kh, kw, in, out)) -> PyTorch
    (out, in, kh, kw): a transpose.
  * ConvTranspose (flax transpose_kernel=False, kernel (kh, kw, in, out))
    -> PyTorch ConvTranspose (in, out, kh, kw) with padding 1: a spatial
    flip and a transpose. flax correlates the stride-dilated input, padded
    2 on each side, with the kernel as it is; PyTorch's transposed conv is
    the same correlation with the kernel flipped.
  * InstanceNorm scale / offset: copied.

Every tensor of the port's module must come from the tree and every leaf of
the tree must be used, or the conversion raises.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _conv(k: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)))


def _conv_transpose(k: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(k[::-1, ::-1], (2, 3, 0, 1)))


def _flatten(tree, prefix="") -> dict:
    flat = {}
    for key, value in tree.items():
        name = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            flat.update(_flatten(value, name))
        else:
            flat[name] = np.asarray(value, np.float32)
    return flat


def _generator_key_map(depth: int, up_depth: int) -> dict:
    """port state_dict key -> (flax path, layout function)."""
    m = {}
    for i in range(depth):
        m[f"down.{i}.weight"] = (f"DownBlock_{i}/Conv_0/kernel", _conv)
        if i != 0:
            m[f"down.{i}.norm.scale"] = (f"DownBlock_{i}/InstanceNorm_0/scale", None)
            m[f"down.{i}.norm.offset"] = (f"DownBlock_{i}/InstanceNorm_0/offset", None)
    for i in range(up_depth):
        m[f"up.{i}.weight"] = (f"UpBlock_{i}/ConvTranspose_0/kernel", _conv_transpose)
        m[f"up.{i}.norm.scale"] = (f"UpBlock_{i}/InstanceNorm_0/scale", None)
        m[f"up.{i}.norm.offset"] = (f"UpBlock_{i}/InstanceNorm_0/offset", None)
    m["head.weight"] = ("Conv_0/kernel", _conv)
    m["head.bias"] = ("Conv_0/bias", None)
    return m


def _discriminator_key_map() -> dict:
    return {
        "down.weight": ("DownBlock_0/Conv_0/kernel", _conv),
        "head.weight": ("Conv_0/kernel", _conv),
        "head.bias": ("Conv_0/bias", None),
    }


def _convert(tree, key_map, module: nn.Module, what: str) -> dict:
    flat = _flatten(tree)
    expected = module.state_dict()
    missing = sorted(set(expected) - set(key_map))
    if missing:
        raise ValueError(f"{what}: no Flax source for port tensors {missing[:3]}")
    out = {}
    for key, ref in expected.items():
        path, layout = key_map[key]
        if path not in flat:
            raise ValueError(f"{what}: Flax tree has no {path} (for {key})")
        arr = flat.pop(path)
        if layout is not None:
            arr = layout(arr)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(
                f"{what}: {path} maps to shape {arr.shape}, {key} is {tuple(ref.shape)}"
            )
        out[key] = torch.from_numpy(arr.copy()).to(ref.device, ref.dtype)
    if flat:
        raise ValueError(f"{what}: unused Flax leaves {sorted(flat)[:3]}")
    return out


def generator_state_dict_from_flax(tree: dict, generator: nn.Module) -> dict:
    """The Flax UnetGenerator tree as `generator`'s state_dict."""
    key_map = _generator_key_map(len(generator.down), len(generator.up))
    return _convert(tree, key_map, generator, "generator")


def discriminator_state_dict_from_flax(tree: dict, discriminator: nn.Module) -> dict:
    """The Flax PatchDiscriminator tree as `discriminator`'s state_dict."""
    return _convert(tree, _discriminator_key_map(), discriminator, "discriminator")


def load_flax_params(generator: nn.Module, discriminator: nn.Module,
                     g_tree: dict | None = None, d_tree: dict | None = None) -> None:
    """Load Flax trees into the port's networks (strict: every key)."""
    if g_tree is not None:
        generator.load_state_dict(generator_state_dict_from_flax(g_tree, generator))
    if d_tree is not None:
        discriminator.load_state_dict(
            discriminator_state_dict_from_flax(d_tree, discriminator)
        )

