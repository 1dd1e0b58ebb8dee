"""Convert keras InceptionV3 weights into the `.npz` of the port's FID.

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
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m palette_and_histo_gan_tpu_torch.convert_inception",
        description=__doc__.split("\n")[0],
    )
    ap.add_argument("--h5", required=True,
                    help="keras InceptionV3 notop weights file (.h5 or .weights.h5) on disk")
    ap.add_argument("--out", required=True, help="output .npz")
    args = ap.parse_args(argv)
    if not os.path.isfile(args.h5):
        ap.error(f"--h5 {args.h5!r} names no file (keras' 'imagenet' download is not used)")

    os.environ["CUDA_VISIBLE_DEVICES"] = "-1"
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
    from .models.inception import WEIGHTS_ENV, convert_keras_weights

    convert_keras_weights(args.h5, args.out)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB)")
    print(f"export {WEIGHTS_ENV}={os.path.abspath(args.out)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
