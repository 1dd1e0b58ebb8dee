"""Write the `.npz` of InceptionV3 weights that the port's FID loads.

The reference computes FID with keras' pretrained InceptionV3 (notop). With
its weights file on disk, on a machine with TensorFlow:

    python -m palette_and_histo_gan_tpu_torch.convert_inception \
        --h5 inception_v3_weights_tf_dim_ordering_tf_kernels_notop.h5 \
        --out inception_weights.npz
    export PHG_INCEPTION_WEIGHTS=$PWD/inception_weights.npz

Every FID the port reports (eval/fid.py, the Trainer's evaluate_fid) then
loads those weights (models/inception.py::load_params). `--h5` must name a
file: keras' "imagenet" default would download it, which this command
refuses. TensorFlow runs on the CPU only (CUDA hidden from it); the
conversion is a copy of arrays.

The repository's FID curves (the JAX and TF records' `fid`) run on the
shared-init InceptionV3 of scripts/make_shared_inception.py, seeded random
weights; this command draws the same file, bit for bit, with numpy alone
(models/inception.py::shared_init_flat_params), and prints its digest:

    python -m palette_and_histo_gan_tpu_torch.convert_inception \
        --shared-init build/inception_shared.npz

for `compare_reference_train --fid-at ... --inception-npz`. Either mode
refuses to write over an existing file, or into the repository's
`artifacts/`.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(REPO, "artifacts")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m palette_and_histo_gan_tpu_torch.convert_inception",
        description=__doc__.split("\n")[0],
    )
    source = ap.add_mutually_exclusive_group(required=True)
    source.add_argument("--h5", help="keras InceptionV3 notop weights file (.h5 or "
                        ".weights.h5) on disk; with --out")
    source.add_argument("--shared-init", metavar="OUT",
                        help="write scripts/make_shared_inception.py's shared-init weights "
                        "to OUT, without TensorFlow")
    ap.add_argument("--out", help="output .npz of --h5")
    args = ap.parse_args(argv)
    if args.h5 is not None:
        if args.out is None:
            ap.error("--h5 needs --out")
        if not os.path.isfile(args.h5):
            ap.error(f"--h5 {args.h5!r} names no file (keras' 'imagenet' download is not used)")
        out = args.out
    else:
        if args.out is not None:
            ap.error("--shared-init names its own output; --out belongs to --h5")
        out = args.shared_init
    if os.path.exists(out):
        ap.error(f"{out!r} exists; this command writes over no file")
    artifacts = os.path.realpath(ARTIFACTS)
    if os.path.commonpath([artifacts, os.path.realpath(out)]) == artifacts:
        ap.error(f"{out!r} lies in the repository's artifacts/, which this command leaves alone")

    if args.h5 is not None:
        os.environ["CUDA_VISIBLE_DEVICES"] = "-1"
        os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
        from .models.inception import convert_keras_weights

        convert_keras_weights(args.h5, out)
    else:
        from .models import inception

        t0 = time.perf_counter()
        flat = inception.shared_init_flat_params()
        digest = inception.flat_digest(flat)
        draw = time.perf_counter() - t0
        if digest != inception.SHARED_INIT_SHA256:  # another numpy normal stream, say
            raise RuntimeError(f"shared-init weights drawn with sha256 {digest}, not the "
                               f"script's {inception.SHARED_INIT_SHA256}; nothing written")
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "xb") as f:  # np.savez on a path would append ".npz"
            np.savez(f, **flat)
        print(f"shared-init InceptionV3 drawn in {draw:.2f} s, sha256 {digest}")
    from .models.inception import WEIGHTS_ENV

    print(f"wrote {out} ({os.path.getsize(out) / 1e6:.1f} MB)")
    print(f"export {WEIGHTS_ENV}={os.path.abspath(out)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
