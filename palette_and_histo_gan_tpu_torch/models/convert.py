"""The weight bridge: a Flax parameter tree (as numpy) to the port's
`state_dict`s, for the generator, the discriminator and the FID's
InceptionV3 (`inception_state_dict_from_flat`); and the reference's
trained keras weights to that tree.

The tree is what the JAX package's `create_train_state` holds (its
`g_params` / `d_params`), or what `keras_generator_weights_to_flax` /
`keras_discriminator_weights_to_flax` build from a keras model's
`get_weights()` list; on disk it is an `.npz` with '/'-joined keys
(`save_params_npz` / `load_params_npz`, the format the JAX package and
`python -m palette_and_histo_gan_tpu_torch.convert_weights` write alike).

Keras weights. The reference saves its trained networks as keras models;
in the environment that loads them (TF 2.9 with tensorflow_addons, which
registers InstanceNormalization), dump each one positionally:

    np.savez("generator.npz", *model.get_weights())

`get_weights()` lists the variables in construction order, fixed by the
topology: the U-Net's six downsample blocks (Conv2D kernel, then
InstanceNorm gamma and beta for all but the first), its six upsample
blocks (Conv2DTranspose kernel, gamma, beta), the head Conv2D (kernel,
bias); the PatchGAN's one downsample (Conv2D kernel) and its head (kernel,
bias). `generator_weight_spec` / `discriminator_weight_spec` name them.
A keras Conv2D kernel is (kh, kw, cin, cout), as flax's; a keras
Conv2DTranspose kernel is (kh, kw, cout, cin), and the flax ConvTranspose
kernel of the same function is transpose(k[::-1, ::-1], (0, 1, 3, 2)) (a
spatial flip and the channel axes swapped); tfa InstanceNorm's gamma and
beta are the scale and offset (eps 1e-3 on both sides).

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

import re
from typing import Sequence

import numpy as np
import torch
from torch import nn

# The reference U-Net's stage widths.
DOWN_FILTERS = (64, 128, 256, 512, 512, 512)
UP_FILTERS = (512, 512, 256, 128, 64, 32)


def _conv(k: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)))


def _conv_transpose(k: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(k[::-1, ::-1], (2, 3, 0, 1)))


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """A nested dict as {'/'-joined key: leaf}."""
    flat = {}
    for key, value in tree.items():
        name = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            flat.update(flatten_tree(value, name))
        else:
            flat[name] = value
    return flat


def save_params_npz(path: str, params: dict) -> None:
    """Save a Flax parameter tree as an .npz with '/'-joined keys."""
    np.savez(path, **flatten_tree(params))


def load_params_npz(path: str) -> dict:
    """Inverse of save_params_npz: '/'-joined .npz -> nested tree."""
    tree: dict = {}
    with np.load(path) as f:
        for key in f.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = f[key]
    return tree


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
    flat = flatten_tree(tree)
    expected = module.state_dict()
    missing = sorted(set(expected) - set(key_map))
    if missing:
        raise ValueError(f"{what}: no Flax source for port tensors {missing[:3]}")
    out = {}
    for key, ref in expected.items():
        path, layout = key_map[key]
        if path not in flat:
            raise ValueError(f"{what}: Flax tree has no {path} (for {key})")
        arr = np.asarray(flat.pop(path), np.float32)
        if layout is not None and arr.ndim == 4:
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


# ------------------------------------------------------------- keras weights


def generator_weight_spec(in_channels: int, out_channels: int) -> list:
    """Ordered (name, shape, kind) of the reference U-Net's weights, in
    `get_weights()` order, with keras kernel layouts. Kinds: "conv"
    (Conv2D / Conv2DTranspose kernel), "scale" / "offset" (InstanceNorm
    gamma / beta), "bias" (the head's)."""
    spec = []
    cin = in_channels
    for i, f in enumerate(DOWN_FILTERS):
        spec.append((f"gen/down{i}/conv", (4, 4, cin, f), "conv"))
        if i != 0:  # the first downsample has no norm
            spec.append((f"gen/down{i}/norm/scale", (f,), "scale"))
            spec.append((f"gen/down{i}/norm/offset", (f,), "offset"))
        cin = f
    # the decoder's inputs: the bottleneck, then concat(up_i, skip_i); the
    # last skip is the network's input
    skip_widths = list(reversed(DOWN_FILTERS[:-1])) + [in_channels]
    for i, f in enumerate(UP_FILTERS):
        spec.append((f"gen/up{i}/convt", (4, 4, f, cin), "conv"))  # (kh, kw, cout, cin)
        spec.append((f"gen/up{i}/norm/scale", (f,), "scale"))
        spec.append((f"gen/up{i}/norm/offset", (f,), "offset"))
        cin = f + skip_widths[i]
    spec.append(("gen/head/conv", (4, 4, cin, out_channels), "conv"))
    spec.append(("gen/head/bias", (out_channels,), "bias"))
    return spec


def discriminator_weight_spec(in_channels: int) -> list:
    """Ordered (name, shape, kind) of the PatchGAN's weights."""
    return [
        ("disc/down/conv", (4, 4, 2 * in_channels, 64), "conv"),
        ("disc/head/conv", (4, 4, 64, 1), "conv"),
        ("disc/head/bias", (1,), "bias"),
    ]


def named_from_sequence(arrays: Sequence[np.ndarray], spec, what: str) -> dict:
    """A `get_weights()`-ordered array list zipped against `spec` as
    {name: float32 array}; a wrong count, or a wrong shape naming the
    weight, raises ValueError."""
    if len(arrays) != len(spec):
        raise ValueError(
            f"{what}: expected {len(spec)} weight arrays "
            f"(reference topology), got {len(arrays)}. Was the .npz saved "
            f"with np.savez(path, *model.get_weights()) from the reference "
            f"model, and do --in-channels/--out-channels (or --variant) "
            f"match the trained variant?"
        )
    named = {}
    for arr, (name, shape, _) in zip(arrays, spec):
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(
                f"{what}: weight '{name}' has shape {tuple(arr.shape)}, "
                f"expected {tuple(shape)}. The array order or the variant's "
                f"channel counts do not match the reference topology."
            )
        named[name] = arr.astype(np.float32)
    return named


def generator_tree_from_named(named: dict) -> dict:
    """The Flax UnetGenerator tree of the canonical-named keras arrays."""
    tree = {}
    for i in range(len(DOWN_FILTERS)):
        block = {"Conv_0": {"kernel": named[f"gen/down{i}/conv"]}}
        if i != 0:
            block["InstanceNorm_0"] = {
                "scale": named[f"gen/down{i}/norm/scale"],
                "offset": named[f"gen/down{i}/norm/offset"],
            }
        tree[f"DownBlock_{i}"] = block
    for i in range(len(UP_FILTERS)):
        k_keras = named[f"gen/up{i}/convt"]
        tree[f"UpBlock_{i}"] = {
            "ConvTranspose_0": {
                "kernel": np.transpose(k_keras[::-1, ::-1], (0, 1, 3, 2)).copy()
            },
            "InstanceNorm_0": {
                "scale": named[f"gen/up{i}/norm/scale"],
                "offset": named[f"gen/up{i}/norm/offset"],
            },
        }
    tree["Conv_0"] = {"kernel": named["gen/head/conv"], "bias": named["gen/head/bias"]}
    return tree


def discriminator_tree_from_named(named: dict) -> dict:
    """The Flax PatchDiscriminator tree of the canonical-named keras arrays."""
    return {
        "DownBlock_0": {"Conv_0": {"kernel": named["disc/down/conv"]}},
        "Conv_0": {"kernel": named["disc/head/conv"], "bias": named["disc/head/bias"]},
    }


def keras_generator_weights_to_flax(arrays: Sequence[np.ndarray], in_channels: int,
                                    out_channels: int) -> dict:
    """`get_weights()`-ordered arrays -> the Flax UnetGenerator tree."""
    spec = generator_weight_spec(in_channels, out_channels)
    return generator_tree_from_named(named_from_sequence(arrays, spec, "generator"))


def keras_discriminator_weights_to_flax(arrays: Sequence[np.ndarray], in_channels: int) -> dict:
    """`get_weights()`-ordered arrays -> the Flax PatchDiscriminator tree."""
    spec = discriminator_weight_spec(in_channels)
    return discriminator_tree_from_named(named_from_sequence(arrays, spec, "discriminator"))


def load_keras_npz(path: str) -> list:
    """The arrays of an `np.savez(path, *model.get_weights())` archive, in
    their positional order (np.savez names them arr_0 .. arr_N)."""
    with np.load(path) as f:
        keys = list(f.files)
        if not all(re.fullmatch(r"arr_\d+", k) for k in keys):
            raise ValueError(
                f"{path}: expected positional keys arr_0..arr_N from "
                f"np.savez(path, *model.get_weights()); found {keys[:5]}..."
            )
        keys.sort(key=lambda k: int(k[4:]))
        return [f[k] for k in keys]


def generator_state_dict_from_keras(arrays: Sequence[np.ndarray], generator: nn.Module) -> dict:
    """`get_weights()`-ordered keras arrays as `generator`'s state_dict, by
    way of the Flax tree; the channel counts are the module's."""
    tree = keras_generator_weights_to_flax(
        arrays, generator.down[0].weight.shape[1], generator.head.weight.shape[0]
    )
    return generator_state_dict_from_flax(tree, generator)


def discriminator_state_dict_from_keras(arrays: Sequence[np.ndarray],
                                        discriminator: nn.Module) -> dict:
    """`get_weights()`-ordered keras arrays as `discriminator`'s state_dict."""
    tree = keras_discriminator_weights_to_flax(arrays, discriminator.down.weight.shape[1] // 2)
    return discriminator_state_dict_from_flax(tree, discriminator)


def _inception_key_map(num_units: int) -> dict:
    m = {}
    for k in range(num_units):
        prefix = f"params/ConvBN_{k}"
        m[f"units.{k}.weight"] = (f"{prefix}/Conv_0/kernel", _conv)
        for leaf in ("mean", "var", "beta"):
            m[f"units.{k}.{leaf}"] = (f"{prefix}/{leaf}", None)
    return m


def inception_state_dict_from_flat(flat: dict, module: nn.Module) -> dict:
    """A flat InceptionV3 weight dict ('/'-joined Flax paths such as
    params/ConvBN_{k}/Conv_0/kernel (HWIO) and params/ConvBN_{k}/{beta,
    mean,var}: the layout of the JAX module's convert_keras_model and of
    its variables flattened) as `module`'s state_dict (models/
    inception.py). Strict: a missing, extra or mis-shaped key raises
    ValueError naming it."""
    return _convert(flat, _inception_key_map(len(module.units)), module, "inception")
