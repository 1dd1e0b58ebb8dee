"""Convert the reference's trained keras network weights into the '/'-joined
Flax-keyed `.npz` that both packages load.

In the environment that loads the reference's keras models (TF 2.9 with
tensorflow_addons), dump each network's weights positionally:

    np.savez("generator.npz", *model.get_weights())

Then, on any machine with the port (numpy and torch; no JAX):

    python -m palette_and_histo_gan_tpu_torch.convert_weights \
        --generator generator.npz --discriminator discriminator.npz \
        --variant baseline --out-dir converted [--verify] [--device cuda]

writes converted/generator_flax.npz and converted/discriminator_flax.npz,
the files `python -m palette_and_histo_gan_tpu_torch.cli --init-generator`
/ `--init-discriminator` (and the JAX package's `load_params_npz`) read.
The variant sets the channel counts (indexed: 1 -> 256, the others 4 -> 4);
the arrays' count and shapes are checked against the reference topology
always. `--verify` also loads each tree into the port's networks on
`--device` (the card unless the CPU is asked for; without a CUDA device it
raises) and runs one forward.
"""

from __future__ import annotations

import argparse
import os

import torch

from .config import MODEL_VARIANTS, config_for_variant, float32_exact
from .models import convert, networks


def _verify(config, what: str, tree: dict, device: torch.device) -> None:
    """Load `tree` into the port's network on `device`; one float32 forward
    of zeros, TF32 off (`float32_exact`)."""
    if what == "generator":
        module = networks.build_generator(config, torch.float32)
        module.load_state_dict(convert.generator_state_dict_from_flax(tree, module))
        x = torch.zeros(1, 64, 64, config.generator_in_channels, device=device)
        forward = lambda m: m(x, deterministic=True)
    else:
        module = networks.build_discriminator(config, torch.float32)
        module.load_state_dict(convert.discriminator_state_dict_from_flax(tree, module))
        x = torch.zeros(1, 64, 64, config.discriminator_in_channels, device=device)
        forward = lambda m: m(x, x)
    with float32_exact(), torch.no_grad():
        out = forward(module.to(device)).float().cpu()
    print(f"verify: {what} forward on {device} ok, output {tuple(out.shape)}, "
          f"finite={bool(torch.isfinite(out).all())}, max |out| {float(out.abs().max()):.6g}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m palette_and_histo_gan_tpu_torch.convert_weights",
        description=__doc__.split("\n")[0],
    )
    ap.add_argument("--generator", help=".npz of the generator's get_weights()")
    ap.add_argument("--discriminator", help=".npz of the discriminator's get_weights()")
    ap.add_argument("--variant", default="baseline", choices=MODEL_VARIANTS,
                    help="the trained variant; sets the channel counts (indexed: 1 -> 256)")
    ap.add_argument("--out-dir", default="converted")
    ap.add_argument("--verify", action="store_true",
                    help="also load each tree into the port's networks and run one forward")
    ap.add_argument("--device", default="cuda",
                    help="device of the --verify forward (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    if not args.generator and not args.discriminator:
        ap.error("give --generator and/or --discriminator")
    device = torch.device(args.device)
    if args.verify and device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--verify on {device}: PyTorch sees no CUDA device "
                           "(pass --device cpu to verify on the CPU)")

    config = config_for_variant(args.variant)
    os.makedirs(args.out_dir, exist_ok=True)
    for what, path in (("generator", args.generator), ("discriminator", args.discriminator)):
        if not path:
            continue
        arrays = convert.load_keras_npz(path)
        if what == "generator":
            tree = convert.keras_generator_weights_to_flax(
                arrays, config.generator_in_channels, config.generator_out_channels
            )
        else:
            tree = convert.keras_discriminator_weights_to_flax(
                arrays, config.discriminator_in_channels
            )
        out = os.path.join(args.out_dir, f"{what}_flax.npz")
        convert.save_params_npz(out, tree)
        print(f"{what}: {len(arrays)} arrays, {sum(a.size for a in arrays):,} params -> {out}")
        if args.verify:
            _verify(config, what, tree, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
