#!/usr/bin/env python3
"""Smoke run of the PyTorch port (palette_and_histo_gan_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions; exits 1 without a CUDA device.
  2. build: compiles the fused augmentation kernel (csrc/augment.cu), the
     fused histogram kernels (csrc/histogram.cu) and the palette index
     kernel (csrc/palette.cu) with nvcc for sm_90a from this checkout, the
     three nvcc processes at once; prints ptxas' registers and spills of
     the tensor-core kernels (the histogram forwards in float32, 3xTF32,
     and bfloat16, the bfloat16 backward) and of the float32 backward, and
     counts the HGMMA (wgmma) instructions of the first three in the
     library's SASS (cuobjdump): a tensor-core kernel with none, or with
     spills, fails.
  3. augment kernel vs plain: its branch-free divisions against IEEE
     division (the normalize on every float32, the hue's reciprocal on
     1..255): no mismatch; every input format x float32/bfloat16 output
     x normalize on/off, at B=4 and B=1024, on the same draws; float32
     within 5e-4 on the 0-255 scale, bfloat16 within one bfloat16 ulp
     beyond that float32 tolerance. Times both at the main path's shapes
     with CUDA events.
  4. histogram kernels vs plain: each of K3a, K3b (forward) and K4a, K4b,
     K4c (backward) at B=4, B=64 (where the backward's blocks own 512
     pixels, between B=4's smallest and B=1024's 1,024) and B=1024 on 64x64
     images, and at B=40 on images of 8,384 pixels (three launches of the
     bfloat16 forward, a ninth block of the backward with 192 pixels),
     64 bins, in every chain its configuration allows, on the same seeded
     pixels and cotangents; within HIST_TOL of the largest |plain value|.
     The float32 chain's branch-free reciprocal against __frcp_rn on every
     positive normal float32 below 2^126, and the float32 forward's integer
     TF32 rounding (the CPU tests' too) against cvt.rna.tf32.f32 on every
     finite float32: no mismatch. The float32
     forward where it splits an image's pixels over blocks (B=4, B=40 x
     8,384) gives the same bits in two launches. Times kernel and
     plain version with CUDA events in the chain each regime runs: B=1024
     with the bfloat16 compute dtype (K3a/K4a keep their float32 chain),
     B=4 float32.
  5. parity: two full-width float32 histogram-variant steps on the card
     (kernel path) against the same steps on the CPU (plain path), from the
     same weights on the same batches, deterministic dropout and no
     augmentation draws kept (the kernel only normalizes); losses within
     rtol 1e-3. Under the default histogram ("xla"/"tri"), "pallas" and
     histogram_bwd="pallas"; the same for baseline and baseline-no-aug;
     then "pallas2" in bfloat16 (the b1024 rows' dtype) from three seeds,
     losses within BF16_PARITY_RTOL.
  6. main path: a full-width float32 histogram-variant Trainer, batch 4, on
     a seeded synthetic sprite set of 250 train / 44 test pairs;
     fit(steps=8, update_steps=4) with the L1 report, then one single step
     (make_train_step) on a uint8 batch; once under each histogram
     configuration ("xla"/"tri", "pallas", "pallas2", histogram_bwd
     "pallas"). The kernel launch counts are set to 0 before each run and
     read after; the augmentation's must be at least 8 (packed) and 1
     (uint8), the configuration's histogram forward at least 16 and its
     backward at least 8. Then baseline (K1 at least 8, K2 at least 1) and
     baseline-no-aug, whose step gathers unpacked rows and only
     normalizes (K1 and K2 exactly 0).
  7. palette index kernel K5 vs plain: on the few-colour synthetic sprite
     set of 250 + 44 pairs (data/loader.py::synthetic_indexed_arrays), its
     588 images against their pairs' joint palettes, and its first 4;
     exact int32 equality; at least one label past 255 and at least one
     truncated palette. Times both with CUDA events, plain, kernel,
     kernel, plain.
  8. indexed parity: two full-width float32 indexed steps on the card
     against the same steps on the CPU, from the same weights on the same
     index maps, deterministic dropout; the generator's argmax maps agree
     on at least 99.9% of pixels (tests/test_parity.py:162's allowance for
     near-ties), the losses within rtol 1e-3.
  9. indexed main path: the launch counts set to 0, the indexed datasets
     built on the card from the few-colour set (K5 on the sources and the
     targets of both splits: at least 4 launches), a full-width float32
     indexed Trainer, batch 4, fit(steps=8, update_steps=4) with the L1
     report, the counts read; the card-built datasets equal the CPU-built
     ones; finite losses.
  9a. dataset root (phase_dataset_root): the seeded synthetic sets (the
     few-colour one for indexed) written as PNG dataset roots
     (<root>/<train|test>/<i-direction>/<n>.png, the stdlib PNG writer),
     decoded by native/png_io equal to the arrays; the indexed splits
     built on the card from the root (K5, at least 4 launches) equal to
     the ones built from the arrays; `cli --data-root ROOT` (no
     --synthetic) for histogram and indexed, 4 steps each, in processes of
     their own that print their launches: exit 0, K1, K3b and K4b
     (histogram) or K5 (indexed) launched.
  9b. reference weights (phase_reference_weights): keras get_weights()
     archives of the full-width histogram generator and discriminator
     (seeded, the reference's init scale), converted by `python -m
     palette_and_histo_gan_tpu_torch.convert_weights --verify` in a
     subprocess (its forwards on the card), imported into a Trainer on the
     card (import_network_params): state dicts bit-equal to the CPU path's
     from the same arrays, the generator's forward within 1e-4 of the
     CPU's largest value, 4 "pallas2" b4 float32 steps with finite losses
     and K1, K3b, K4b launched (counted as in the main path).
 10. timed chunks, each after a 2-step warm-up, through Trainer.fit at
     full width: histogram float32 batch 4 (40 steps) under "xla"/"tri" and
     under "pallas2" (the CLI's default on a card), bfloat16 batch 1024 (10
     steps) under "xla"/"tri", "pallas", "pallas2" and
     histogram_bwd="pallas"; baseline and baseline-no-aug bfloat16 batch
     1024 (10 steps); indexed float32 batch
     4 (40 steps) and bfloat16 batch 1024 (10 steps); finite losses,
     ms/step (host clock), img/s, peak device memory; 10 steps
     again under torch.profiler for the device ms/step
     (utils/profiling.py::device_step_seconds); MFU, the step's FLOPs
     (utils/flops.py) x img/s over the peak of the convolutions' dtype
     (989 TFLOP/s bfloat16, 67 float32: TF32 is off). The histogram launch counts are
     set to 0 before each warm-up and read after its chunk: under
     "pallas2" the bfloat16 forward (K3b) must run twice a step, 24 times,
     under "pallas2" and histogram_bwd="pallas" the bfloat16 backward (K4b
     and K4c) once a step, 12 times, and no tensor-core kernel otherwise.
 11. FID (phase_fid), under deterministic cuDNN from here on: InceptionV3
     at input 299 (random numpy-drawn weights unless PHG_INCEPTION_WEIGHTS
     names converted ones); 22 images' activations
     on the card against the CPU in both quirk modes (1e-4 of the largest);
     the same bits whether the caller left TF32 on or off, and how far a
     TF32 forward moves them; 44 vs 44 FIDs by low-rank, float64 eigh and
     scipy and of identical sets; the forward at batch 11 against its
     bound.
 12. lifecycle (phase_lifecycle): a full-width histogram "pallas2" b4
     float32 run of 10 steps against 6 steps, a fresh Trainer restored
     from their checkpoint and 4 more, both with the FID report, bit for
     bit, the kernels' launches counted around both; its previews,
     patch-map strips, weight file and 44 image dumps written and decoded;
     an indexed run with its K5 dataset build and 8 dumps; a b1024
     bfloat16 fit with its previews, FID reports and checkpoint, timed by
     phase, and one report_fid timed.
 13. export (phase_export): the trained b4 float32 generator and
     discriminator exported at batch 16, saved, loaded and held to the
     modules (1e-6); 44 PNGs served through the program at batch 16, each
     output equal to the module's quantized output; program vs eager ms at
     batch 16 float32 and batch 1024 bfloat16.
 14. data parallel (phase_data_parallel), under deterministic cuDNN: two
     Gloo ranks sharing the card (processes of parallel/launch.py), a
     full-width histogram "pallas2" b4 float32 Trainer with
     data_parallel="on", fit(4) with the L1 report, against one process
     (losses, parameters, the L1 report, each rank's kernel launches), the
     data-parallel generate of 44 sources with dropout against generate,
     the sharded FID activations against the unsharded ones; NCCL at world
     size 1, b1024 bfloat16 "pallas2" ms/step against one device in turns,
     the gradient all_reduces' ms a step; NCCL across cards where there are
     two or more, else logged as skipped.
 14b. torchrun (phase_torchrun): `torchrun --standalone
     --nproc-per-node=<cards> -m palette_and_histo_gan_tpu_torch.cli
     --model histogram --synthetic --data-parallel on --batch-size 8`, 4
     steps, over NCCL (one card: a world of one): exit 0; only rank 0
     prints (torchrun's per-rank logs) and writes under the working
     directory (an audit hook in each rank). No torchrun fails it.
 15. run_experiment: `python -m palette_and_histo_gan_tpu_torch.run_experiment
     --model histogram --synthetic` at full width on the card, 4 steps with
     the three callbacks, exits 0.

The kernels line gives each kernel's time at the main path's largest
shape beside its bound: the largest of the bytes it must move (inputs read
once, outputs written once) over 3.35 TB/s and its operations over the
card's peak for their type (PEAK); for the histogram kernels the products
on the units the kernel takes them on (the float32 forward: three TF32
passes; the float32 backward: float32 FMAs; a bfloat16 chain: bfloat16)
and the elementwise chain at float32's (ops/histogram_kernel.py::work,
histogram_bound). K3a also gives the bound with its products as float32
FMAs (bound_f32_fma_ms), which no design on the CUDA cores can pass; K3b,
K4b and K4c the tensor-core kernels' launches in the b1024 bf16 chunks
(bf16_launches); K1, K3b, K4b and K5 their launches in the lifecycle
phase (lifecycle_launches), K1, K3b and K4b a data-parallel rank's in
part 1 of the data-parallel phase (dp_rank_launches); K1 and K2 their
launches on baseline's main path (baseline_launches); K1, K3b, K4b and
K5 theirs in the CLI's dataset-root runs (dataset_root_launches).
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import textwrap
import time

import numpy as np
import torch

SEED = 47
F32_TOL = 5e-4  # on the 0-255 scale (palette_and_histo_gan_tpu/ops/augment_pallas.py:67-68)
PARITY_RTOL = 1e-3
# the bfloat16 card step against the bfloat16 CPU step (histogram
# "pallas2", batch 4, two steps, at each of BF16_PARITY_SEEDS), relative,
# on every loss: about three times the worst the smoke read (2.45e-3,
# 3.18e-3, 2.30e-3, each the Hellinger loss at step 1; NVIDIA H100 80GB
# HBM3, 700 W)
BF16_PARITY_RTOL = 1e-2
BF16_PARITY_SEEDS = (SEED, SEED + 1, SEED + 2)
SOURCE = "palette_and_histo_gan_tpu_torch/csrc/augment.cu"
REPLACES = {
    "packed": "palette_and_histo_gan_tpu/ops/augment_pallas.py:273",
    "rgba": "palette_and_histo_gan_tpu/ops/augment_pallas.py:119",
}
HIST_SOURCE = "palette_and_histo_gan_tpu_torch/csrc/histogram.cu"
# TPU kernel -> (direction, its body, the chains its configuration runs)
HIST_KERNELS = {
    "K3a": ("fwd", "palette_and_histo_gan_tpu/ops/histogram_pallas.py:76", ("float32",)),
    "K3b": ("fwd", "palette_and_histo_gan_tpu/ops/histogram_pallas2.py:42", ("float32", "bfloat16")),
    "K4a": ("bwd", "palette_and_histo_gan_tpu/ops/histogram_pallas.py:125", ("float32",)),
    "K4b": ("bwd", "palette_and_histo_gan_tpu/ops/histogram_pallas2.py:99", ("float32", "bfloat16")),
    "K4c": ("bwd", "palette_and_histo_gan_tpu/ops/histogram_pallas3.py:63", ("float32", "bfloat16")),
}
# kernel vs plain, as a fraction of the largest |plain value|:
#  * float32: the same elementwise chain op for op. Forward: the kernel's
#    3xTF32 products summed in blocks on the tensor cores against the
#    plain version's float64 sum of the same float32 products (a float32
#    sum in cuBLAS's sequential order is itself 1.3e-5 off it at 8,384
#    pixels); backward: the sums over 64 bins run in another order;
#  * bfloat16: the products are exact in float32 on both sides. The
#    forward only sums them in float32 in another order (the tensor cores'
#    accumulation, a partial sum a warpgroup). In the backward that order
#    can put a bfloat16 rounding of m1, da or a per-pixel reduction on the
#    other side of a tie, one bfloat16 ulp (2^-8 relative) of that value;
#    it allows two such ulps of the largest row. The approximate
#    reciprocal (plain: exact) rounds to the same bfloat16
#    (tests/test_torch_histogram_bwd_bf16.py).
HIST_TOL = {
    ("fwd", "float32"): 1e-5, ("bwd", "float32"): 1e-4,
    ("fwd", "bfloat16"): 1e-4, ("bwd", "bfloat16"): 8e-3,
}
# the kernels whose bfloat16 chain runs on the tensor cores (hist_fwd_bf16,
# hist_bwd_bf16), and their launches a step: the b1024 bf16 chunks of
# their configurations must count exactly those
BF16_LAUNCHES_A_STEP = {"K3b": 2, "K4b": 1, "K4c": 1}
# (batch, pixels an image) of the kernel-vs-plain checks
HIST_CHECK_SHAPES = ((4, 4096), (64, 4096), (40, 8384), (1024, 4096))
# the histogram configurations, as config_for_variant overrides, and the
# kernels each one runs on the card
HIST_CONFIGS = {
    "xla/tri": ({}, ()),
    "pallas": ({"histogram_impl": "pallas"}, ("K3a", "K4a")),
    "pallas2": ({"histogram_impl": "pallas2"}, ("K3b", "K4b")),
    "bwd=pallas": ({"histogram_bwd": "pallas"}, ("K4c",)),
}
PAL_SOURCE = "palette_and_histo_gan_tpu_torch/csrc/palette.cu"
PAL_REPLACES = "palette_and_histo_gan_tpu/ops/palette_pallas.py:26"
ARGMAX_AGREEMENT = 0.999
# the RGBA variants without the histogram: baseline augments (K1, K2),
# baseline-no-aug only normalizes (no kernel)
BASELINE_VARIANTS = ("baseline", "baseline-no-aug")
# logs of the smoke's Trainers go under a folder .gitignore lists
TEMP_FOLDER = os.path.join("build", "chip_smoke")

# An H100 SXM's peaks (NVIDIA's data sheet, dense): memory bytes/s and
# operations/s by type. int32 on the CUDA cores: 132 SMs x 64 INT32 lanes x
# 1.98 GHz (the Hopper white paper; half the float32 lanes behind the
# float32 67 TFLOP/s). bfloat16 and tf32 are the tensor cores' rates: the
# bfloat16 chain's products are bfloat16 x bfloat16 summed in float32, the
# float32 forward's three TF32 products a pair of factors (3xTF32).
PEAK = {"bytes": 3.35e12, "float32": 67e12, "bfloat16": 989e12, "tf32": 495e12,
        "int32": 132 * 64 * 1.98e9}
# the augmentation's float32 operations a pixel and image (hue rotation,
# select, normalize; csrc/augment.cu)
AUGMENT_OPS_PER_PIXEL = 40


def bound(nbytes: float, *ops: tuple[float, str]) -> tuple[float, str]:
    """The least time the card could take for this work, in ms, and what
    sets it: bytes over the memory rate, or the slowest of the (count,
    type) operation terms over their peak (each type on its own units)."""
    t_bytes = 1e3 * nbytes / PEAK["bytes"]
    t_ops = max(1e3 * n / PEAK[op_type] for n, op_type in ops)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def histogram_bound(w: dict, product_type: str | None = None) -> tuple[float, str]:
    """bound() of a histogram kernel's work (ops/histogram_kernel.py::work):
    its products, `passes` times, at the peak of `product_type` (default:
    the units the kernel takes them on), its elementwise chain at
    float32's, its bytes."""
    product_type = product_type or w["product_type"]
    passes = w["passes"] if product_type == w["product_type"] else 1
    return bound(w["bytes"], (passes * w["products"], product_type), (w["elementwise"], "float32"))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


T_START = time.perf_counter()


def log(phase: str, msg: str) -> None:
    """One line of the smoke's log, with the seconds since it started."""
    print(f"[{phase} {time.perf_counter() - T_START:.1f}s] {msg}", flush=True)


# ---------------------------------------------------------------- kernels


def kernel_inputs(fmt: str, b: int, device, seed: int):
    """Source and target of one input format, from seeded uint8 pixels."""
    from palette_and_histo_gan_tpu_torch.train.steps import pack_rows

    rng = np.random.default_rng(seed)
    pair = [
        torch.from_numpy(rng.integers(0, 256, (b, 64, 64, 4), dtype=np.uint8)).to(device)
        for _ in range(2)
    ]
    if fmt == "packed":
        return [pack_rows(x) for x in pair]
    return pair if fmt == "u8" else [x.float() for x in pair]


def bf16_ulps(a: torch.Tensor, b: torch.Tensor, atol: float) -> float:
    """Largest |a - b| beyond `atol`, in units of the bfloat16 ulp of the
    larger of the two magnitudes (8 significant bits: ulp = 2^(e - 8) for
    |v| = m 2^e, m in [0.5, 1)). `atol` is the float32 tolerance: where
    the normalize cancels to near 0 (v / 127.5 - 1 for v near 127.5), the
    two float32 values before the round may differ by a float32 ulp of 1,
    which is many bfloat16 ulps of the tiny result."""
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(torch.finfo(torch.bfloat16).tiny)
    _, exp = torch.frexp(mag)
    ulp = torch.ldexp(torch.ones_like(mag), exp - 8)
    return float(((a - b).abs() - atol).clamp_min(0.0).div(ulp).max())


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds a call over `iters` calls, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernel_vs_plain(device) -> dict:
    """Kernel against plain version on every case; times at the main
    path's shapes. Returns per kernel entry its worst float32 error (0-255
    scale) and its times."""
    from palette_and_histo_gan_tpu_torch.ops import augment, augment_kernel

    mismatches = augment_kernel.divide_mismatches(device)
    log("kernel", f"augment's branch-free divisions vs IEEE division (v / 127.5 - 1 on every "
        f"float32, 1 / v on 1..255): {mismatches} mismatches")
    if mismatches:
        raise AssertionError(f"the augment kernel's divisions are not IEEE division's: {mismatches}")
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    worst = {"packed": 0.0, "rgba": 0.0}
    for b in (4, 1024):
        draws = augment.draw_params(gen, b, 0.8)
        for fmt in ("packed", "u8", "f32"):
            src, tgt = kernel_inputs(fmt, b, device, SEED + b)
            entry = "packed" if fmt == "packed" else "rgba"
            for out_dtype in (torch.float32, torch.bfloat16):
                for normalize_out in (False, True):
                    kw = dict(normalize_out=normalize_out, out_dtype=out_dtype)
                    got = augment_kernel.augment_cuda(src, tgt, *draws, **kw)
                    ref = augment.augment_plain(src, tgt, *draws, **kw)
                    torch.cuda.synchronize()
                    for g, r in zip(got, ref):
                        if g.shape != (b, 64, 64, 4) or g.dtype != out_dtype:
                            raise AssertionError(f"kernel output {g.dtype} {tuple(g.shape)}")
                    name = f"B={b} {fmt} -> {str(out_dtype)[6:]} normalize={normalize_out}"
                    scale = 127.5 if normalize_out else 1.0
                    err = max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref))
                    if out_dtype == torch.float32:
                        ok = err * scale <= F32_TOL
                        worst[entry] = max(worst[entry], err * scale)
                        log("kernel", f"{name}: max|kernel - plain| {err * scale:.3e} "
                            f"(0-255 scale, tol {F32_TOL})")
                    else:
                        ulps = max(bf16_ulps(g, r, F32_TOL / scale) for g, r in zip(got, ref))
                        ok = ulps <= 1.0
                        log("kernel", f"{name}: max|kernel - plain| {err:.3e}, {ulps:.3f} bf16 ulp "
                            f"beyond {F32_TOL / scale:.2e} (tol 1 ulp)")
                    if not ok:
                        raise AssertionError(f"kernel disagrees with plain version: {name}")
    torch.cuda.synchronize()

    # times at the main path's shapes: batch 1024 to bfloat16 (the bf16
    # cell) and batch 4 to float32 (the reference regime), normalize on;
    # plain, kernel, kernel, plain, each the mean of its two runs
    times = {}
    for b, out_dtype, iters in ((1024, torch.bfloat16, 50), (4, torch.float32, 200)):
        draws = augment.draw_params(gen, b, 0.8)
        for fmt, entry in (("packed", "packed"), ("u8", "rgba")):
            src, tgt = kernel_inputs(fmt, b, device, SEED)
            kw = dict(normalize_out=True, out_dtype=out_dtype)

            def kern():
                augment_kernel.augment_cuda(src, tgt, *draws, **kw)

            def plain():
                augment.augment_plain(src, tgt, *draws, **kw)

            p1, k1, k2, p2 = (cuda_ms(f, iters) for f in (plain, kern, kern, plain))
            moved = nbytes(src, tgt, *draws) + 2 * b * 64 * 64 * 4 * out_dtype.itemsize
            times[(entry, b)] = ((k1 + k2) / 2, (p1 + p2) / 2,
                                 *bound(moved, (AUGMENT_OPS_PER_PIXEL * 2 * b * 4096, "float32")))
            log(
                "kernel",
                f"time B={b} {fmt} -> {str(out_dtype)[6:]}: kernel {k1:.4f} / {k2:.4f} ms, "
                f"plain {p1:.4f} / {p2:.4f} ms",
            )
    return {"worst": worst, "times": times}


def histogram_inputs(b: int, device, seed: int, hw: int = 4096):
    """Per-pixel logs (B, 3, HW) and Iy (B, HW) of seeded uint8 pixels, and
    a seeded (B, 3, 64, 64) cotangent, all float32 on `device`."""
    from palette_and_histo_gan_tpu_torch.ops import histogram_kernel as hk

    rng = np.random.default_rng(seed)
    flat01 = torch.from_numpy(rng.integers(0, 256, (b, hw, 3), dtype=np.uint8)).to(device).float() / 255.0
    logs, iy = hk.logs_and_intensity(flat01)
    g = torch.from_numpy(rng.standard_normal((b, 3, 64, 64), dtype=np.float32) * 1e-3).to(device)
    return logs, iy, g


def histogram_call(name: str, chain: str, logs, iy, g, method="inverse-quadratic", plain=False):
    """One call of the kernel `name` (or its plain version) in `chain`."""
    from palette_and_histo_gan_tpu_torch.ops import histogram_kernel as hk

    direction = HIST_KERNELS[name][0]
    kw = dict(size=64, method=method, sigma=0.02, chain=getattr(torch, chain))
    if direction == "fwd":
        if plain:
            return hk.histogram_forward_plain(logs, iy, **kw)
        return hk.histogram_forward_cuda(logs, iy, kernel=name, **kw)
    if plain:
        return hk.histogram_backward_plain(logs, iy, g, **kw)
    return hk.histogram_backward_cuda(logs, iy, g, kernel=name, **kw)


def float32_sum_error(logs, iy) -> float:
    """How far torch.matmul in float32 (cuBLAS, summing in its own order)
    lands from the plain forward's float64 sum of the same float32
    products, as a fraction of the largest value: what a float32 sum in
    one fixed order is itself off by (ops/histogram_kernel.py::
    _forward_product), inverse-quadratic kernel."""
    from palette_and_histo_gan_tpu_torch.ops import histogram_kernel as hk
    from palette_and_histo_gan_tpu_torch.ops.histogram import CHANNEL_TRIPLES

    t = hk.domain(64, logs.device)[:, None]
    inv_s = hk.chain_scalar(1.0 / 0.02**2, torch.float32)
    worst = 0.0
    ref = hk.histogram_forward_plain(logs, iy, size=64, method="inverse-quadratic", sigma=0.02,
                                     chain=torch.float32)
    for ch, (c, p1, p2) in enumerate(CHANNEL_TRIPLES):
        ku, _ = hk._kernel_values(logs[:, c] - logs[:, p1], t, "inverse-quadratic", inv_s)
        kv, _ = hk._kernel_values(logs[:, c] - logs[:, p2], t, "inverse-quadratic", inv_s)
        plane = torch.matmul(iy[:, None, :] * ku, kv.transpose(1, 2))
        worst = max(worst, float((plane - ref[:, ch]).abs().max()))
    return worst / float(ref.abs().max())


def phase_histogram_check(device) -> dict:
    """Each histogram kernel against its plain version in every chain its
    configuration allows, at HIST_CHECK_SHAPES (and the RBF kernel at B=4),
    and the float32 chain's reciprocal against the correctly rounded one.
    Returns per kernel its worst absolute error."""
    from palette_and_histo_gan_tpu_torch.ops import histogram_kernel as hk

    mismatches = hk.reciprocal_mismatches(device)
    log("hist", f"float32 chain's reciprocal vs __frcp_rn on every positive normal float32 below "
        f"2^126: {mismatches} mismatches")
    if mismatches:
        raise AssertionError(f"the float32 chain's reciprocal is not correctly rounded: {mismatches}")
    mismatches = hk.tf32_mismatches(device)
    log("hist", f"float32 forward's TF32 rounding, (bits + 2^12) & ~(2^13 - 1), vs cvt.rna.tf32.f32 "
        f"on every finite float32: {mismatches} mismatches")
    if mismatches:
        raise AssertionError(f"the float32 forward's TF32 rounding is not cvt.rna's: {mismatches}")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    worst = {name: 0.0 for name in HIST_KERNELS}
    for b, hw in HIST_CHECK_SHAPES:
        fwd_pixels = hk.forward_block_pixels(b, hw, sms)
        log("hist", f"B={b}, {hw} pixels, {sms} SMs: a float32 forward block owns {fwd_pixels} "
            f"pixels ({-(-hw // fwd_pixels)} parts); a backward block owns "
            + ", ".join(f"{hk.backward_block_pixels(b, hw, sms, getattr(torch, chain))} pixels ({chain})"
                        for chain in ("float32", "bfloat16")))
        logs, iy, g = histogram_inputs(b, device, SEED + b, hw)
        log("hist", f"B={b} HW={hw}: a float32 sum of the forward's products in cuBLAS's order "
            f"is {float32_sum_error(logs, iy):.3e} of max|plain| off the plain version's float64 sum")
        if fwd_pixels < hw:
            first, again = (histogram_call("K3a", "float32", logs, iy, g) for _ in range(2))
            torch.cuda.synchronize()
            if not torch.equal(first, again):
                raise AssertionError(f"the split float32 forward differs between launches: B={b} HW={hw}")
            log("hist", f"K3a B={b} HW={hw}: two launches of the split forward give the same bits")
        for name, (direction, _, chains) in HIST_KERNELS.items():
            for chain in chains:
                for method in ("inverse-quadratic", "RBF") if b == 4 else ("inverse-quadratic",):
                    got = histogram_call(name, chain, logs, iy, g, method)
                    torch.cuda.synchronize()
                    ref = histogram_call(name, chain, logs, iy, g, method, plain=True)
                    torch.cuda.synchronize()
                    if got.shape != ref.shape or got.dtype != torch.float32:
                        raise AssertionError(f"{name}: kernel output {got.dtype} {tuple(got.shape)}")
                    err = float((got - ref).abs().max())
                    rel = err / float(ref.abs().max())
                    tol = HIST_TOL[(direction, chain)]
                    worst[name] = max(worst[name], err)
                    log("hist", f"{name} B={b} HW={hw} {chain} {method}: max|kernel - plain| {err:.3e}, "
                        f"{rel:.3e} of max|plain| (tol {tol:g})")
                    if not (math.isfinite(rel) and rel <= tol):
                        raise AssertionError(f"{name} disagrees with its plain version: B={b} HW={hw} {chain} {method}")
            del got, ref
        del logs, iy, g
        torch.cuda.empty_cache()
    return worst


def phase_histogram_times(device) -> dict:
    """Kernel and plain version in each regime's chain, at its batch:
    plain, kernel, kernel, plain. Returns per (kernel, batch) the mean
    kernel and plain milliseconds."""
    from palette_and_histo_gan_tpu_torch.ops import histogram_kernel as hk

    times = {}
    for b, compute, iters, plain_iters in ((1024, "bfloat16", 20, 3), (4, "float32", 200, 20)):
        logs, iy, g = histogram_inputs(b, device, SEED)
        for name, (_, _, chains) in HIST_KERNELS.items():
            chain = compute if compute in chains else "float32"

            def kern():
                histogram_call(name, chain, logs, iy, g)

            def plain():
                histogram_call(name, chain, logs, iy, g, plain=True)

            p1 = cuda_ms(plain, plain_iters)
            k1, k2 = cuda_ms(kern, iters), cuda_ms(kern, iters)
            p2 = cuda_ms(plain, plain_iters)
            # the products on the kernel's units, the elementwise chain at
            # float32's, the bytes
            w = hk.work(HIST_KERNELS[name][0], b, logs.shape[-1], chain=getattr(torch, chain))
            times[(name, b)] = ((k1 + k2) / 2, (p1 + p2) / 2, *histogram_bound(w))
            if name == "K3a":
                times[("K3a fma", b)] = histogram_bound(w, "float32")
            log("hist", f"time {name} B={b} {chain}: kernel {k1:.4f} / {k2:.4f} ms, "
                f"plain {p1:.4f} / {p2:.4f} ms")
        del logs, iy, g
        torch.cuda.empty_cache()
    return times


# ------------------------------------------------------------ train steps


def synthetic_datasets(config, device):
    """Seeded synthetic splits of config's sizes on `device`: random uint8
    sprites, or for the indexed variant the few-colour set, indexed."""
    from palette_and_histo_gan_tpu_torch.data import loader

    if config.is_indexed:
        return loader.indexed_datasets_from_arrays(
            *loader.synthetic_indexed_arrays(config, SEED), device,
            config.palette_ordering, config.seed,
        )
    return loader.datasets_from_arrays(*loader.synthetic_arrays(config, SEED), device)


def check_finite(metrics: dict, what: str) -> None:
    bad = {k: v for k, v in metrics.items() if not math.isfinite(v)}
    if bad:
        raise AssertionError(f"{what}: non-finite metrics {bad}")


def phase_parity(device, variant: str, config_overrides: dict, rtol: float = PARITY_RTOL,
                 seed: int = SEED) -> float:
    """Two steps of an RGBA variant on `device` against the same two on the
    CPU, from the same weights (float32 unless the overrides say
    otherwise), weights and batches drawn from `seed`; returns the worst
    relative loss difference, which must be within `rtol`."""
    from palette_and_histo_gan_tpu_torch import config_for_variant
    from palette_and_histo_gan_tpu_torch.train import create_train_state, make_train_step
    from palette_and_histo_gan_tpu_torch.train.steps import pack_rows

    config = config_for_variant(
        variant, deterministic_dropout=True, augment_probability=0.0,
        temp_folder=TEMP_FOLDER, **config_overrides,
    )
    ref = create_train_state(config, "cpu", seed)
    dev = create_train_state(config, device, seed)
    dev.generator.load_state_dict(ref.generator.state_dict())
    dev.discriminator.load_state_dict(ref.discriminator.state_dict())
    step = make_train_step(config)
    rng = np.random.default_rng(seed)
    worst = 0.0
    for i in range(2):
        src, tgt = (
            pack_rows(torch.from_numpy(
                rng.integers(0, 256, (config.batch_size, 64, 64, 4), dtype=np.uint8)
            ))
            for _ in range(2)
        )
        m_ref = {k: float(v) for k, v in step(ref, src, tgt).items()}
        m_dev = {k: float(v) for k, v in step(dev, src.to(device), tgt.to(device)).items()}
        check_finite(m_dev, "parity step")
        for k in m_ref:
            rel = abs(m_dev[k] - m_ref[k]) / max(abs(m_ref[k]), 1e-12)
            worst = max(worst, rel)
            log("parity", f"{variant} {config.compute_dtype} step {i} {k}: {device.type} {m_dev[k]:.7g}  "
                f"cpu {m_ref[k]:.7g}  rel {rel:.2e}")
    if worst > rtol:
        raise AssertionError(f"card and CPU {variant} {config.compute_dtype} steps differ by "
                             f"{worst:.2e} > {rtol}")
    return worst


def phase_main_path(device, variant: str, config_overrides: dict, hist_kernels=(), steps=8,
                    update_steps=4) -> dict:
    """An RGBA variant's Trainer fit and one single step on a uint8 batch;
    returns the launch counts of that run, augmentation's and histogram's.
    A variant that augments must launch K1 once a step and K2 in the
    single step; baseline-no-aug, whose step gathers unpacked rows and only
    normalizes, must launch neither."""
    from palette_and_histo_gan_tpu_torch import config_for_variant
    from palette_and_histo_gan_tpu_torch.data import batch_indices
    from palette_and_histo_gan_tpu_torch.ops import augment_kernel, histogram_kernel
    from palette_and_histo_gan_tpu_torch.train import make_train_step
    from palette_and_histo_gan_tpu_torch.train.trainer import Trainer

    config = config_for_variant(variant, temp_folder=TEMP_FOLDER, **config_overrides)
    trainer = Trainer(config, device, synthetic_datasets(config, device))
    log("main", f"{variant}: train {trainer.train_ds.n} / test {trainer.test_ds.n} pairs, batch {config.batch_size}, "
        f"{config.compute_dtype}, histogram_impl {config.histogram_impl}, histogram_bwd {config.histogram_bwd}")

    augment_kernel.reset_launches()
    histogram_kernel.reset_launches()
    trainer.fit(steps=steps, update_steps=update_steps, callbacks=["evaluate_l1"])
    # the single-step entry point on a gathered uint8 batch
    idx = batch_indices(SEED, trainer.state.step, trainer.train_ds.n, config.batch_size, device)
    single = make_train_step(config)(
        trainer.state, trainer.train_ds.sources[idx], trainer.train_ds.targets[idx]
    )
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = {**augment_kernel.launches, **histogram_kernel.launches}

    for i, row in enumerate(trainer.history):
        check_finite(row, f"step {i}")
        log(
            "main",
            f"{variant} step {i}: G total {row['generator/total_loss']:.5f}  "
            f"G hellinger {row.get('generator/histogram_loss', float('nan')):.5f}  "
            f"D total {row['discriminator/total_loss']:.5f}",
        )
    single = {k: float(v) for k, v in single.items()}
    check_finite(single, "single step")
    log("main", f"single step on uint8: G total {single['generator/total_loss']:.5f}  D total {single['discriminator/total_loss']:.5f}")
    l1_train, l1_test = trainer.report_l1()
    if not all(math.isfinite(v) and 0.0 <= v <= 2.0 for v in (l1_train, l1_test)):
        raise AssertionError(f"L1 report out of range: {l1_train}, {l1_test}")
    log("main", f"L1 train {l1_train:.5f}  test {l1_test:.5f}")
    if len(trainer.history) != steps or trainer.state.step != steps + 1:
        raise AssertionError(f"{len(trainer.history)} steps logged, state at {trainer.state.step}")
    log("main", f"kernel launches in this run: {launches}")
    if device.type != "cuda":
        return launches
    if not config.uses_augmentation:
        augmented = {k: launches[k] for k in ("packed", "rgba") if launches[k]}
        if augmented:
            raise AssertionError(f"{variant} launched the augment kernel {augmented}")
        return launches
    # each step runs the histogram twice (real and fake) and backpropagates
    # the fake's only
    need = {"packed": steps, "rgba": 1}
    for name in hist_kernels:
        need[name] = 2 * steps if HIST_KERNELS[name][0] == "fwd" else steps
    short = {k: launches[k] for k, n in need.items() if launches[k] < n}
    if short:
        raise AssertionError(f"the main path did not run the kernels {short}; needed {need}")
    return launches


def phase_palette_check(device) -> dict:
    """Kernel K5 against its plain version on the few-colour set's 588
    images (sources and targets of 250 + 44 pairs, each against its pair's
    joint palette) and on its first 4: exact. Times both at each size."""
    from palette_and_histo_gan_tpu_torch import config_for_variant
    from palette_and_histo_gan_tpu_torch.data import loader
    from palette_and_histo_gan_tpu_torch.ops import palette as palette_ops
    from palette_and_histo_gan_tpu_torch.ops import palette_kernel

    config = config_for_variant("indexed")
    ts, tt, es, et = (loader.prepare_rgba(a) for a in loader.synthetic_indexed_arrays(config, SEED))
    src, tgt = np.concatenate([ts, es]), np.concatenate([tt, et])
    truncated = sum(
        np.unique(np.concatenate([s, t]).reshape(-1, 4).view(np.uint32)).size > 256
        for s, t in zip(src, tgt)
    )
    src, tgt = torch.from_numpy(src).to(device), torch.from_numpy(tgt).to(device)
    palettes = palette_ops.joint_palettes(src, tgt, config.palette_ordering)
    images = torch.cat([src, tgt]).contiguous()
    palettes = torch.cat([palettes, palettes]).contiguous()
    out = {"times": {}, "n_images": images.shape[0]}
    for b, iters in ((images.shape[0], 50), (4, 200)):
        im, pa = images[:b].contiguous(), palettes[:b].contiguous()
        got = palette_kernel.rgba_to_indexed_cuda(im, pa)
        ref = palette_kernel.rgba_to_indexed_plain(im, pa)
        torch.cuda.synchronize()
        if got.shape != (b, 64, 64, 1) or got.dtype != torch.int32 or not torch.equal(got, ref):
            raise AssertionError(f"K5 disagrees with its plain version at {b} images")
        past_255 = int((got > 255).sum())
        log("palette", f"K5 {b} images: kernel == plain (exact), max label {int(got.max())}, "
            f"{past_255} labels past 255")
        if b == images.shape[0] and (past_255 == 0 or truncated == 0):
            raise AssertionError(f"the set lacks a quirk: {past_255} labels past 255, "
                                 f"{truncated} truncated pairs")

        def kern():
            palette_kernel.rgba_to_indexed_cuda(im, pa)

        def plain():
            palette_kernel.rgba_to_indexed_plain(im, pa)

        plain_iters = max(iters // 10, 5)
        p1 = cuda_ms(plain, plain_iters)
        k1, k2 = cuda_ms(kern, iters), cuda_ms(kern, iters)
        p2 = cuda_ms(plain, plain_iters)
        # a compare and a select-add a pixel and slot; pixels and palettes
        # read once, the maps written once
        moved = nbytes(im, pa, got)
        out["times"][b] = ((k1 + k2) / 2, (p1 + p2) / 2, *bound(moved, (2 * got.numel() * 256, "int32")))
        log("palette", f"time K5 {b} images: kernel {k1:.4f} / {k2:.4f} ms, "
            f"plain {p1:.4f} / {p2:.4f} ms")
    log("palette", f"{truncated} of {src.shape[0]} pairs have more than 256 colours (truncated)")
    return out


def phase_indexed_parity(device) -> float:
    """Two full-width float32 indexed steps on `device` against the same two
    on the CPU, from the same weights, on few-colour index maps; returns the
    worst relative loss difference."""
    from palette_and_histo_gan_tpu_torch import config_for_variant
    from palette_and_histo_gan_tpu_torch.data import loader
    from palette_and_histo_gan_tpu_torch.train import create_train_state, make_train_step

    config = config_for_variant("indexed", deterministic_dropout=True, temp_folder=TEMP_FOLDER)
    ref = create_train_state(config, "cpu", SEED)
    dev = create_train_state(config, device, SEED)
    dev.generator.load_state_dict(ref.generator.state_dict())
    dev.discriminator.load_state_dict(ref.discriminator.state_dict())
    small = config_for_variant("indexed", dataset_sizes=(10,))
    train, _ = loader.indexed_datasets_from_arrays(
        *loader.synthetic_indexed_arrays(small, SEED), "cpu", small.palette_ordering, SEED
    )
    with torch.no_grad():
        src = train.sources[:4]
        want = ref.generator(src.float(), deterministic=True, logits=True).argmax(-1)
        got = dev.generator(src.to(device).float(), deterministic=True, logits=True).argmax(-1)
    agree = float((got.cpu() == want).float().mean())
    log("parity", f"indexed argmax maps: card and CPU agree on {agree:.6f} of pixels "
        f"(tol {ARGMAX_AGREEMENT})")
    if agree < ARGMAX_AGREEMENT:
        raise AssertionError(f"argmax maps agree on {agree} < {ARGMAX_AGREEMENT}")
    step = make_train_step(config)
    worst = 0.0
    for i in range(2):
        src, tgt = train.sources[4 * i:4 * i + 4], train.targets[4 * i:4 * i + 4]
        m_ref = {k: float(v) for k, v in step(ref, src, tgt).items()}
        m_dev = {k: float(v) for k, v in step(dev, src.to(device), tgt.to(device)).items()}
        check_finite(m_dev, "indexed parity step")
        for k in m_ref:
            rel = abs(m_dev[k] - m_ref[k]) / max(abs(m_ref[k]), 1e-12)
            worst = max(worst, rel)
            log("parity", f"indexed step {i} {k}: {device.type} {m_dev[k]:.7g}  cpu {m_ref[k]:.7g}  "
                f"rel {rel:.2e}")
    if worst > PARITY_RTOL:
        raise AssertionError(f"card and CPU indexed steps differ by {worst:.2e} > {PARITY_RTOL}")
    return worst


def phase_indexed_main_path(device, steps=8, update_steps=4) -> dict:
    """The indexed dataset build on the card (K5) and the Trainer's fit;
    returns the launch counts of that run."""
    from palette_and_histo_gan_tpu_torch import config_for_variant
    from palette_and_histo_gan_tpu_torch.data import loader
    from palette_and_histo_gan_tpu_torch.ops import augment_kernel, histogram_kernel, palette_kernel
    from palette_and_histo_gan_tpu_torch.train.trainer import Trainer

    config = config_for_variant("indexed", batch_size=4, temp_folder=TEMP_FOLDER)
    arrays = loader.synthetic_indexed_arrays(config, SEED)
    for counter in (augment_kernel, histogram_kernel, palette_kernel):
        counter.reset_launches()
    datasets = loader.indexed_datasets_from_arrays(
        *arrays, device, config.palette_ordering, config.seed
    )
    trainer = Trainer(config, device, datasets)
    log("main", f"indexed: train {trainer.train_ds.n} / test {trainer.test_ds.n} pairs, batch "
        f"{config.batch_size}, {config.compute_dtype}, palette ordering {config.palette_ordering}")
    trainer.fit(steps=steps, update_steps=update_steps, callbacks=["evaluate_l1"])
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(palette_kernel.launches)

    for i, row in enumerate(trainer.history):
        check_finite(row, f"indexed step {i}")
        log("main", f"indexed step {i}: G total {row['generator/total_loss']:.5f}  "
            f"G segmentation {row['generator/segmentation_loss']:.5f}  "
            f"D total {row['discriminator/total_loss']:.5f}")
    if len(trainer.history) != steps or trainer.state.step != steps:
        raise AssertionError(f"{len(trainer.history)} steps logged, state at {trainer.state.step}")
    l1_train, l1_test = trainer.report_l1()
    if not all(math.isfinite(v) and 0.0 <= v <= 255.0 for v in (l1_train, l1_test)):
        raise AssertionError(f"indexed L1 report out of range: {l1_train}, {l1_test}")
    log("main", f"indexed L1 (0-255 RGBA scale) train {l1_train:.5f}  test {l1_test:.5f}")
    cpu = loader.indexed_datasets_from_arrays(*arrays, "cpu", config.palette_ordering, config.seed)
    for split, ours, ref in zip(("train", "test"), datasets, cpu):
        for name in ("sources", "targets", "palettes"):
            if not torch.equal(getattr(ours, name).cpu(), getattr(ref, name)):
                raise AssertionError(f"card-built {split} {name} differ from the CPU-built ones")
    log("main", "indexed datasets built on the card equal the CPU-built ones")
    log("main", f"kernel launches in this run: {launches}")
    if device.type == "cuda" and launches["K5"] < 4:
        raise AssertionError(f"the indexed main path launched K5 {launches['K5']} times; needed 4")
    return launches


# steps of a timed chunk's profiled run (the profiler's host cost grows
# with the kernels it records)
PROFILED_STEPS = 10
REF_FORWARD_REL = 1e-4  # card vs CPU generator forward, of the largest |CPU value|
REF_STEPS = 4


def keras_arrays(spec, rng) -> list:
    """A keras `get_weights()` list for a weight spec, drawn at the
    reference's init scale: kernels and biases N(0, 0.02), norm scales
    N(1, 0.02), offsets N(0, 0.02)."""
    return [rng.normal(1.0 if kind == "scale" else 0.0, 0.02, shape).astype(np.float32)
            for _, shape, kind in spec]


def phase_reference_weights(device) -> dict:
    """The reference's trained-weight path at full width: keras
    `get_weights()` archives of the histogram generator (4 -> 4) and
    discriminator, `python -m palette_and_histo_gan_tpu_torch.
    convert_weights --verify` on them as a subprocess (its forward on the
    card), the converted files into a Trainer on the card through
    import_network_params: its state dicts bit-equal to the CPU path's
    from the same arrays, its generator's forward within REF_FORWARD_REL
    of the largest value of the CPU forward, then REF_STEPS steps of
    "pallas2" at batch 4 float32 with finite losses and K1, K3b and K4b
    launched. Returns the launches, the forward's error and the seconds."""
    from palette_and_histo_gan_tpu_torch import config_for_variant
    from palette_and_histo_gan_tpu_torch.models import convert, networks
    from palette_and_histo_gan_tpu_torch.ops import augment_kernel, histogram_kernel
    from palette_and_histo_gan_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    folder = os.path.join(TEMP_FOLDER, "reference_weights")
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(SEED)
    arrays = {"generator": keras_arrays(convert.generator_weight_spec(4, 4), rng),
              "discriminator": keras_arrays(convert.discriminator_weight_spec(4), rng)}
    keras_files = {}
    for which, a in arrays.items():
        keras_files[which] = os.path.join(folder, f"{which}_keras.npz")
        np.savez(keras_files[which], *a)
    out_dir = os.path.join(folder, "converted")
    t_convert = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "palette_and_histo_gan_tpu_torch.convert_weights",
         "--generator", keras_files["generator"], "--discriminator", keras_files["discriminator"],
         "--variant", "histogram", "--out-dir", out_dir, "--verify"],
        capture_output=True, text=True, timeout=600,
    )
    convert_s = time.perf_counter() - t_convert
    for line in proc.stdout.splitlines():
        log("reference", line)
    if proc.returncode != 0 or proc.stdout.count("forward on cuda") != 2:
        raise AssertionError(f"convert_weights exited {proc.returncode}: {proc.stderr[-3000:]}")

    config = config_for_variant("histogram", batch_size=4, temp_folder=TEMP_FOLDER,
                                **HIST_CONFIGS["pallas2"][0])
    trainer = Trainer(config, device, synthetic_datasets(config, device))
    trainer.import_network_params(os.path.join(out_dir, "generator_flax.npz"),
                                  os.path.join(out_dir, "discriminator_flax.npz"))
    gen_cpu = networks.build_generator(config, torch.float32)
    disc_cpu = networks.build_discriminator(config, torch.float32)
    for which, module, want in (
        ("generator", trainer.state.generator,
         convert.generator_state_dict_from_keras(arrays["generator"], gen_cpu)),
        ("discriminator", trainer.state.discriminator,
         convert.discriminator_state_dict_from_keras(arrays["discriminator"], disc_cpu)),
    ):
        got = module.state_dict()
        bad = sorted(got.keys() ^ want.keys()) or [
            k for k in want if not torch.equal(got[k].cpu(), want[k])]
        if bad:
            raise AssertionError(f"imported {which} differs from the CPU path's at {bad[:3]}")
        if which == "generator":
            gen_cpu.load_state_dict(want)
    log("reference", "imported state dicts equal the CPU path's from the same arrays, bit for bit")
    src = torch.from_numpy(rng.uniform(-1.0, 1.0, (4, 64, 64, 4)).astype(np.float32))
    with torch.no_grad():
        want = gen_cpu(src, deterministic=True)
        got = trainer.state.generator(src.to(device), deterministic=True).cpu()
    forward_rel = float((got - want).abs().max()) / float(want.abs().max())
    log("reference", f"generator forward, card vs CPU: {forward_rel:.2e} of the largest "
        f"|value| {float(want.abs().max()):.5f} (tol {REF_FORWARD_REL})")
    if not forward_rel <= REF_FORWARD_REL:
        raise AssertionError(f"card forward {forward_rel:.2e} off the CPU's > {REF_FORWARD_REL}")

    augment_kernel.reset_launches()
    histogram_kernel.reset_launches()
    trainer.fit(steps=REF_STEPS, update_steps=REF_STEPS)
    torch.cuda.synchronize()
    launches = {**augment_kernel.launches, **histogram_kernel.launches}
    for i, row in enumerate(trainer.history):
        check_finite(row, f"reference-weight step {i}")
        log("reference", f"step {i}: G total {row['generator/total_loss']:.5f}  "
            f"G hellinger {row['generator/histogram_loss']:.5f}  "
            f"D total {row['discriminator/total_loss']:.5f}")
    need = {"packed": REF_STEPS, "K3b": 2 * REF_STEPS, "K4b": REF_STEPS}
    short = {k: launches[k] for k, n in need.items() if launches[k] < n}
    if device.type == "cuda" and short:
        raise AssertionError(f"the reference-weight fit did not run the kernels {short}; "
                             f"needed {need}")
    seconds = time.perf_counter() - t0
    log("reference", f"kernel launches {launches}; converter subprocess {convert_s:.1f} s, "
        f"phase {seconds:.1f} s")
    return {"launches": launches, "forward_rel": forward_rel, "convert_s": convert_s,
            "seconds": seconds}


def phase_timed_chunk(device, variant: str, compute_dtype: str, config_overrides: dict,
                      steps: int, bf16_kernels=()) -> dict:
    """One chunk of `steps` steps through Trainer.fit after a 2-step
    warm-up; returns ms/step, img/s, the peak device memory and the
    tensor-core histogram kernels' launches in warm-up and chunk, which
    must be BF16_LAUNCHES_A_STEP's for each kernel named in `bf16_kernels`
    and 0 for the others. Then PROFILED_STEPS steps of the train chunk
    under torch.profiler (utils/profiling.py::device_step_seconds): the
    step's device time; and the step's FLOPs
    (utils/flops.py) over the host clock's img/s as a share of the
    convolutions' dtype's peak (MFU)."""
    from palette_and_histo_gan_tpu_torch import config_for_variant
    from palette_and_histo_gan_tpu_torch.ops import histogram_kernel
    from palette_and_histo_gan_tpu_torch.train.trainer import Trainer
    from palette_and_histo_gan_tpu_torch.utils import flops, profiling

    config = config_for_variant(
        variant, compute_dtype=compute_dtype, temp_folder=TEMP_FOLDER, **config_overrides
    )
    trainer = Trainer(config, device, synthetic_datasets(config, device))
    histogram_kernel.reset_launches()
    trainer.fit(steps=2, update_steps=2)  # warm-up: cuDNN plans, allocator
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = trainer.phase_seconds["train_chunk"]
    trainer.fit(steps=steps, update_steps=steps)
    seconds = trainer.phase_seconds["train_chunk"] - before
    for row in trainer.history:
        check_finite(row, f"{compute_dtype} chunk")
    last = trainer.history[-1]
    out = {
        "ms_per_step": 1e3 * seconds / steps,
        "img_per_s": config.batch_size * steps / seconds,
        "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else float("nan"),
        "bf16_launches": dict(histogram_kernel.bf16_launches),
    }
    need = {k: BF16_LAUNCHES_A_STEP[k] * (2 + steps) if k in bf16_kernels else 0
            for k in out["bf16_launches"]}
    if device.type == "cuda" and out["bf16_launches"] != need:
        raise AssertionError(f"the {compute_dtype} chunk launched the tensor-core histogram kernels "
                             f"{out['bf16_launches']} times; needed {need}")
    dataset = (trainer.train_ds.sources, trainer.train_ds.targets)
    out["device_ms_per_step"] = 1e3 * profiling.device_step_seconds(
        lambda n: trainer.train_chunk(trainer.state, dataset, n), PROFILED_STEPS)
    out["flops_per_image"] = flops.train_step_flops_per_image(config)
    # TF32 is off under set_f32_parity_mode: float32 convolutions run at
    # float32's peak, bfloat16 ones at the tensor cores' dense bfloat16 peak
    peak = PEAK["bfloat16" if compute_dtype == "bfloat16" else "float32"]
    out["mfu"] = out["flops_per_image"] * out["img_per_s"] / peak
    log(
        "timed",
        f"{variant} {compute_dtype} batch {config.batch_size}, {steps} steps in {seconds:.4f} s: "
        f"{out['ms_per_step']:.3f} ms/step (host), {out['device_ms_per_step']:.3f} ms/step "
        f"(device), {out['img_per_s']:.1f} img/s, {out['flops_per_image'] / 1e9:.4f} GFLOP/img, "
        f"MFU {100 * out['mfu']:.2f}% of {peak / 1e12:.0f} TFLOP/s, peak {out['peak_gib']:.2f} GiB; "
        f"last step G total "
        f"{last['generator/total_loss']:.5f} D total {last['discriminator/total_loss']:.5f}; "
        f"tensor-core histogram kernel launches {out['bf16_launches']}",
    )
    return out


# -------------------------------------------------------------- lifecycle


def glob_png(folder: str, pattern: str) -> list[str]:
    import glob

    return sorted(glob.glob(os.path.join(folder, pattern)))


def decode_written(paths, shape: tuple, what: str) -> None:
    """Decode each PNG through the port's native decoder at `shape` (H, W):
    opaque RGB, or the run fails."""
    from palette_and_histo_gan_tpu_torch.native import png_io

    if not paths:
        raise AssertionError(f"no {what} written")
    for path in paths:
        img = png_io.decode_png_rgba(path, *shape)
        if img is None or (img[..., 3] != 255).any():
            raise AssertionError(f"{what} {path} does not decode as a {shape} RGB PNG")


def state_mismatches(a, b) -> list[str]:
    """Keys of two TrainState.state_dict()s whose values are not bit-equal."""
    from palette_and_histo_gan_tpu_torch.models.convert import flatten_tree

    fa, fb = flatten_tree(a.state_dict()), flatten_tree(b.state_dict())
    if fa.keys() != fb.keys():
        return sorted(fa.keys() ^ fb.keys())
    return [k for k, v in fa.items()
            if not (torch.equal(v.cpu(), fb[k].cpu()) if isinstance(v, torch.Tensor) else v == fb[k])]


def lifecycle_trainer(device, temp_folder: str, variant: str = "histogram",
                      fid_evaluator=None, **overrides):
    from palette_and_histo_gan_tpu_torch import config_for_variant
    from palette_and_histo_gan_tpu_torch.train.trainer import Trainer

    config = config_for_variant(variant, temp_folder=temp_folder, **overrides)
    return Trainer(config, device, synthetic_datasets(config, device), fid_evaluator)


def phase_lifecycle(device, card: str, fid_evaluator) -> tuple[dict, object, object]:
    """The Trainer's lifecycle at full width on the card, under float32
    parity and deterministic cuDNN:
      1. histogram "pallas2", batch 4, float32, augmentation on (K1,
         hist_fwd_f32 and hist_bwd_f32 as K3b / K4b): (a) fit(10,
         update_steps=2) with the L1 and FID reports and the patch maps;
         (b) fit(6), a fresh Trainer restored from step 6, fit(4,
         starting_step=6), both with the FID report. (b) equals (a) bit
         for bit (the FID draws from none of the state's generators); both
         ran the
         kernels; one checkpoint, of step 10; every preview grid and
         patch-map strip written and decodes; the generator's weight
         file loads back equal in a fresh Trainer; the test split's 44
         image dumps decode;
      2. indexed, batch 4, float32: the datasets built by K5, fit(2) with
         the patch maps, 8 image dumps through the palette decode;
      3. histogram "pallas2" at batch 1024 bfloat16: after a 2-step
         warm-up, fit(20, update_steps=10) with its previews, FID reports
         and one checkpoint; phase_seconds, the checkpoint's bytes and the
         time AsyncSaver.save held the loop; then one report_fid, timed.
    The FID reports share `fid_evaluator`. Returns each run's launch
    counts and the timings, the trained b4 float32 Trainer of (a) and the
    b1024 bfloat16 one."""
    import shutil

    from palette_and_histo_gan_tpu_torch import set_deterministic_mode
    from palette_and_histo_gan_tpu_torch.data import loader
    from palette_and_histo_gan_tpu_torch.ops import augment_kernel, histogram_kernel, palette_kernel
    from palette_and_histo_gan_tpu_torch.train import checkpoint as ckpt
    from palette_and_histo_gan_tpu_torch.utils import visualization as viz

    set_deterministic_mode()
    root = os.path.join(TEMP_FOLDER, "lifecycle")
    shutil.rmtree(root, ignore_errors=True)
    counters = (augment_kernel, histogram_kernel, palette_kernel)
    hist = dict(batch_size=4, histogram_impl="pallas2")
    tile = 64 * viz.SCALE + viz.GUTTER
    grid_shape = (viz.GUTTER + 6 * tile, viz.GUTTER + 3 * tile)
    strip_shape = (viz.GUTTER + tile, viz.GUTTER + 5 * tile)
    dump_shape = (viz.GUTTER + tile, viz.GUTTER + 3 * tile)

    def counted(run) -> dict:
        for c in counters:
            c.reset_launches()
        out = run()
        torch.cuda.synchronize()
        return out, {**augment_kernel.launches, **histogram_kernel.launches,
                     **palette_kernel.launches}

    def uninterrupted():
        t = lifecycle_trainer(device, os.path.join(root, "a"), fid_evaluator=fid_evaluator, **hist)
        t.fit(10, update_steps=2,
              callbacks=["evaluate_l1", "evaluate_fid", "show_discriminator_output"])
        return t

    def resumed():
        first = lifecycle_trainer(device, os.path.join(root, "b"), fid_evaluator=fid_evaluator,
                                  **hist)
        first.fit(6, update_steps=2, callbacks=["evaluate_fid"])
        t = lifecycle_trainer(device, os.path.join(root, "b"), fid_evaluator=fid_evaluator, **hist)
        start = t.restore_latest_checkpoint()
        if start != 6:
            raise AssertionError(f"restored step {start}, expected 6")
        t.fit(4, update_steps=2, callbacks=["evaluate_fid"], starting_step=6)
        return t

    a, launches_a = counted(uninterrupted)
    b, launches_b = counted(resumed)
    for label, launches, steps in (("uninterrupted", launches_a, 10), ("resumed", launches_b, 10)):
        need = {"packed": steps, "K3b": 2 * steps, "K4b": steps}
        log("lifecycle", f"{label} run's kernel launches: {launches}")
        if device.type == "cuda" and any(launches[k] != n for k, n in need.items()):
            raise AssertionError(f"the {label} run launched {launches}; needed {need}")
    for i, row in enumerate(a.history):
        check_finite(row, f"lifecycle step {i}")
    bad = state_mismatches(a.state, b.state)
    log("lifecycle", f"resumed at step 6 against uninterrupted, 10 steps: {len(bad)} keys of the "
        f"train state differ {bad[:5]}; last G total {a.history[-1]['generator/total_loss']!r} / "
        f"{b.history[-1]['generator/total_loss']!r}")
    if bad or b.history != a.history[6:]:
        raise AssertionError(f"the resumed run is not the uninterrupted one bit for bit: {bad[:10]}")
    for t in (a, b):
        if t.manager.steps() != [10] or len(os.listdir(t.manager.directory)) != 1:
            raise AssertionError(f"checkpoints {os.listdir(t.manager.directory)}, expected step 10 alone")
    ckpt_bytes_f32 = os.path.getsize(a.manager.path(10))
    log_dir = os.path.join(root, "a", "logs", a.config.architecture_name, a.config.model,
                           a.now_string)
    grids = sorted(glob_png(log_dir, "step_*.png"))
    if [os.path.basename(p) for p in grids] != [f"step_{s:06d}.png" for s in range(0, 11, 2)]:
        raise AssertionError(f"preview grids {grids}")
    decode_written(grids, grid_shape, "preview grid")
    strips = glob_png(log_dir, "discriminated_*_step_*_*.png")
    if len(strips) != 6 * 4:
        raise AssertionError(f"{len(strips)} patch-map strips, expected 24")
    decode_written(strips, strip_shape, "patch-map strip")
    a.save_generator()
    fresh = lifecycle_trainer(device, os.path.join(root, "c"), **hist)
    fresh.load_generator()
    if not ckpt.params_equal(fresh.state.generator, a.state.generator):
        raise AssertionError("the generator's weight file does not load back equal")
    dumps = glob_png(a.generate_images_from_dataset("test"), "*.png")
    if len(dumps) != 44:
        raise AssertionError(f"{len(dumps)} image dumps, expected 44")
    decode_written(dumps, dump_shape, "image dump")
    log("lifecycle", f"evaluate_fid in the b4 f32 runs: {a.phase_seconds['evaluate_fid']:.3f} s "
        f"(6 reports), {b.phase_seconds['evaluate_fid']:.3f} s (resumed half, 3 reports)")
    log("lifecycle", f"histogram pallas2 b4 f32: resumed == uninterrupted bit for bit; one "
        f"checkpoint (step 10, {ckpt_bytes_f32} bytes); {len(grids)} grids, {len(strips)} strips, "
        f"generator weights round-trip, {len(dumps)} dumps decode")

    def indexed():
        from palette_and_histo_gan_tpu_torch import config_for_variant
        from palette_and_histo_gan_tpu_torch.train.trainer import Trainer

        config = config_for_variant("indexed", temp_folder=os.path.join(root, "i"), batch_size=4)
        datasets = loader.indexed_datasets_from_arrays(
            *loader.synthetic_indexed_arrays(config, SEED), device, config.palette_ordering,
            config.seed,
        )
        t = Trainer(config, device, datasets)
        t.fit(2, update_steps=2, callbacks=["show_discriminator_output"])
        return t, t.generate_images_from_dataset("test", 8)

    (idx, dump_dir), launches_i = counted(indexed)
    log("lifecycle", f"indexed run's kernel launches: {launches_i}")
    if device.type == "cuda" and launches_i["K5"] != 4:
        raise AssertionError(f"the indexed lifecycle run launched K5 {launches_i['K5']} times; needed 4")
    idx_dir = os.path.join(root, "i", "logs", idx.config.architecture_name, idx.config.model,
                           idx.now_string)
    decode_written(glob_png(idx_dir, "step_*.png"), grid_shape, "indexed preview grid")
    decode_written(glob_png(idx_dir, "discriminated_*.png"), strip_shape, "indexed patch-map strip")
    idx_dumps = glob_png(dump_dir, "*.png")
    if len(idx_dumps) != 8:
        raise AssertionError(f"{len(idx_dumps)} indexed image dumps, expected 8")
    decode_written(idx_dumps, dump_shape, "indexed image dump")
    log("lifecycle", "indexed b4 f32: grids, strips and 8 dumps decode through the palettes")

    t = lifecycle_trainer(device, os.path.join(root, "t"), fid_evaluator=fid_evaluator,
                          compute_dtype="bfloat16", batch_size=1024, histogram_impl="pallas2")
    t.fit(2, update_steps=2)  # warm-up: cuDNN plans, allocator
    t.phase_seconds.clear()
    held, save = [], t.saver.save

    def timed_save(state):
        t0 = time.perf_counter()
        save(state)
        held.append(time.perf_counter() - t0)

    t.saver.save = timed_save
    t.fit(20, update_steps=10, callbacks=["evaluate_fid"])
    ckpt_bytes = os.path.getsize(t.manager.path(t.state.step))
    ps = dict(t.phase_seconds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fids = t.report_fid()
    torch.cuda.synchronize()
    report_fid_s = time.perf_counter() - t0
    if not all(math.isfinite(v) for v in fids):
        raise AssertionError(f"b1024 bf16 FID {fids}")
    out = {
        "launches": launches_a, "resumed_launches": launches_b, "indexed_launches": launches_i,
        "train_chunk_ms_per_step": 1e3 * ps["train_chunk"] / 20,
        "preview_ms": 1e3 * ps["preview"] / 3, "checkpoint_s": ps["checkpoint"],
        "save_held_ms": 1e3 * held[0], "ckpt_bytes": ckpt_bytes, "ckpt_bytes_f32": ckpt_bytes_f32,
        "evaluate_fid_s": ps["evaluate_fid"] / 3, "report_fid_s": report_fid_s,
    }
    log("lifecycle", f"{card}: histogram pallas2 b1024 bf16 fit(20, update_steps=10): "
        f"phase_seconds {json.dumps({k: round(v, 6) for k, v in ps.items()})}; train_chunk "
        f"{out['train_chunk_ms_per_step']:.3f} ms/step, a preview {out['preview_ms']:.2f} ms, "
        f"checkpoint {ckpt_bytes} bytes (b4 f32: {ckpt_bytes_f32}), AsyncSaver.save held the loop "
        f"{out['save_held_ms']:.2f} ms, checkpoint phase {ps['checkpoint']:.4f} s (save + final flush); "
        f"evaluate_fid {ps['evaluate_fid']:.4f} s for 3 reports; one more report_fid "
        f"(2 splits x 2 sets x 44 images) {report_fid_s:.4f} s: FID {fids[0]!r} / {fids[1]!r} "
        "(train/test)")
    return out, a, t


# ------------------------------------------------------------------- FID


FID_BATCH = 11  # FidEvaluator's default, the reference's batch
FID_ACT_REL = 1e-4  # card vs CPU activations, of the largest |activation|
FID_EIGH_REL = 1e-4  # low-rank vs float64 eigh
FID_SAME_REL = 1e-3  # identical sets, of FID(a, b)


def fid_sprites(n: int, seed: int) -> np.ndarray:
    """n seeded synthetic sprites, (n, 64, 64, 4) uint8."""
    return np.random.default_rng(seed).integers(0, 256, (n, 64, 64, 4), dtype=np.uint8)


def phase_fid(device, card: str) -> tuple[dict, object]:
    """The FID at full width (input 299), with the weights PHG_INCEPTION_WEIGHTS
    names or, unset, random numpy-drawn ones:
      (a) 22 images' activations on the card against the same evaluator on
          the CPU, quirks on ([-1, 1] sprites) and off ([0, 255]);
      (b) the card's activations equal whether the caller left TF32 on or
          off (the evaluator pins it off); how far a TF32 forward moves them;
      (c) 44 vs 44 card activations, quirks off: FID by low-rank, float64
          eigh and scipy, and of identical sets;
      (d) the Inception forward at batch 11 against its bound, the 94
          convolutions' operations at float32's peak.
    Returns the timings and the card's evaluator (quirks on), which the
    lifecycle's Trainers share."""
    from palette_and_histo_gan_tpu_torch import set_deterministic_mode
    from palette_and_histo_gan_tpu_torch.config import float32_exact
    from palette_and_histo_gan_tpu_torch.eval import fid
    from palette_and_histo_gan_tpu_torch.models import inception

    set_deterministic_mode()  # one cuDNN algorithm whatever the caller's TF32 flags
    t0 = time.perf_counter()
    card_ev = fid.FidEvaluator(FID_BATCH, device=device)
    cpu_ev = fid.FidEvaluator(FID_BATCH, device="cpu")
    log("fid", f"evaluators built in {time.perf_counter() - t0:.2f} s (the same weights on both "
        "devices)")
    out = {}
    sprites = fid_sprites(44, SEED)
    modes = {True: sprites[:22].astype(np.float32) / 127.5 - 1.0,
             False: sprites[:22].astype(np.float32)}
    for quirks, x in modes.items():
        card_ev.reference_quirks = cpu_ev.reference_quirks = quirks
        got, want = card_ev.activations(x).cpu(), cpu_ev.activations(x)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        log("fid", f"(a) quirks {quirks}: card vs CPU activations max abs {err:.3e} "
            f"({err / scale:.3e} of max |act| {scale:.4f}; tol {FID_ACT_REL})")
        if not err <= FID_ACT_REL * scale:
            raise AssertionError(f"FID activations, quirks {quirks}: card vs CPU {err} > "
                                 f"{FID_ACT_REL} x {scale}")
    card_ev.reference_quirks = False

    x = torch.from_numpy(modes[False]).to(device)
    caller = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    runs = {}
    for tf32 in (True, False):
        torch.backends.cudnn.allow_tf32 = tf32
        torch.set_float32_matmul_precision("high" if tf32 else "highest")
        runs[tf32] = card_ev.activations(x)
        if torch.backends.cudnn.allow_tf32 != tf32:
            raise AssertionError("the evaluator did not restore the caller's cuDNN TF32 flag")
    torch.backends.cudnn.allow_tf32 = True
    with torch.inference_mode():
        pre = fid.preprocess_input(fid.scale_images_nn(x[:FID_BATCH], card_ev.input_size, False))
        tf32_acts = card_ev.model(pre)
    torch.backends.cudnn.allow_tf32, _ = caller
    torch.set_float32_matmul_precision(caller[1])
    if not torch.equal(runs[True], runs[False]):
        raise AssertionError("FID activations depend on the caller's TF32 setting")
    moved = float((tf32_acts - runs[False][:FID_BATCH]).abs().max())
    scale = float(runs[False].abs().max())
    log("fid", f"(b) activations bit-equal with the caller's TF32 on and off; a TF32 forward "
        f"would move them by up to {moved:.3e} ({moved / scale:.3e} of max |act|)")

    a = fid_sprites(44, SEED + 1).astype(np.float32)
    b = np.clip(a + np.random.default_rng(SEED + 2).normal(0, 60, a.shape), 0, 255)
    acts_a, acts_b = card_ev.activations(a), card_ev.activations(b.astype(np.float32))
    lowrank = float(fid.frechet_distance_lowrank(acts_a, acts_b))
    mu1, s1 = fid.activation_statistics(acts_a)
    mu2, s2 = fid.activation_statistics(acts_b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eigh = float(fid.frechet_distance(mu1, s1, mu2, s2))
    eigh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scipy_value = fid.frechet_distance_scipy(mu1, s1, mu2, s2)
    scipy_s = time.perf_counter() - t0
    same = float(fid.frechet_distance_lowrank(acts_a, acts_a))
    out.update(fid_lowrank=lowrank, fid_eigh=eigh, fid_scipy=scipy_value, fid_same=same,
               eigh_s=eigh_s, scipy_s=scipy_s)
    log("fid", f"(c) 44 vs 44, quirks off: low-rank {lowrank!r}, float64 eigh {eigh!r} "
        f"({eigh_s:.3f} s), scipy {scipy_value!r} ({scipy_s:.1f} s on the host); low-rank vs "
        f"eigh {abs(lowrank - eigh) / abs(eigh):.3e} relative, vs scipy "
        f"{abs(lowrank - scipy_value) / abs(scipy_value):.3e}; identical sets {same!r}")
    if not abs(lowrank - eigh) <= FID_EIGH_REL * abs(eigh):
        raise AssertionError(f"FID low-rank {lowrank} vs float64 eigh {eigh}")
    if not abs(lowrank - scipy_value) <= 1e-2 * abs(scipy_value) + 1e-2:
        raise AssertionError(f"FID low-rank {lowrank} vs scipy {scipy_value}")
    if not abs(same) < FID_SAME_REL * abs(lowrank) + 1e-3:
        raise AssertionError(f"FID of identical sets {same}")

    with float32_exact(), torch.inference_mode():
        out["forward_ms"] = cuda_ms(lambda: card_ev.model(pre), 20)
    flops = inception.conv_flops(card_ev.model, card_ev.input_size)
    out["bound_ms"] = 1e3 * FID_BATCH * flops / PEAK["float32"]
    out["img_per_s"] = 1e3 * FID_BATCH / out["forward_ms"]
    log("fid", f"(d) {card}: Inception forward at batch {FID_BATCH}, 299x299, float32 (TF32 off): "
        f"{out['forward_ms']:.3f} ms ({out['img_per_s']:.1f} img/s); bound {out['bound_ms']:.3f} ms "
        f"({flops / 1e9:.3f} GFLOP an image in the 94 convolutions at 67 TFLOP/s), "
        f"{100 * out['bound_ms'] / out['forward_ms']:.1f}% of it")
    card_ev.reference_quirks = True
    return out, card_ev


# ---------------------------------------------------------------- export


def phase_export(device, card: str, trained, bf16) -> dict:
    """Programs of the lifecycle's trained b4 float32 state at batch 16:
    the generator's and the discriminator's, saved and loaded back, against
    the modules (dropout off) within 1e-6 and equal over two calls; 44
    synthetic test PNGs served through the generator's program at batch 16
    (3 batches, the last padded), each output PNG equal to the module's
    quantized output; the programs' ms a batch against the eager modules',
    batch 16 float32 and batch 1024 bfloat16 (`bf16`'s generator)."""
    import shutil

    from palette_and_histo_gan_tpu_torch import serve
    from palette_and_histo_gan_tpu_torch.models import export
    from palette_and_histo_gan_tpu_torch.native import png_io
    from palette_and_histo_gan_tpu_torch.utils import visualization as viz

    root = os.path.join(TEMP_FOLDER, "export")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    config, g, d = trained.config, trained.state.generator, trained.state.discriminator
    t0 = time.perf_counter()
    paths = {}
    for which, program in (("generator", export.export_generator(config, g, 16)),
                           ("discriminator", export.export_discriminator(config, d, 16))):
        paths[which] = os.path.join(root, f"{which}.pt2")
        torch.export.save(program, paths[which])
    export_s = time.perf_counter() - t0
    pg, pd = (export.load_exported(paths[w]) for w in ("generator", "discriminator"))
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.uniform(-1, 1, (16, 64, 64, 4)).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.uniform(-1, 1, (16, 64, 64, 4)).astype(np.float32)).to(device)
    with torch.inference_mode():
        checks = {"generator": (pg(x), pg(x), g(x, None, deterministic=True)),
                  "discriminator": (pd(y, x), pd(y, x), d(y, x))}
    errs = {}
    for which, (got, again, want) in checks.items():
        errs[which] = float((got - want).abs().max())
        if not torch.equal(got, again) or not errs[which] <= 1e-6:
            raise AssertionError(f"exported {which}: {errs[which]} from the module, or two calls "
                                 "differ")
    log("export", f"generator and discriminator exported at batch 16 in {export_s:.2f} s; "
        f"loaded programs vs modules max abs {errs} (tol 1e-6); two calls equal")

    src_dir, out_dir = os.path.join(root, "in"), os.path.join(root, "out")
    os.makedirs(src_dir)
    pixels = trained.test_ds.sources.cpu().numpy()
    for i, img in enumerate(pixels):
        viz._write_png(img, os.path.join(src_dir, f"{i:02d}.png"))
    t0 = time.perf_counter()
    served = serve.do_serve(serve.build_parser().parse_args(
        ["serve", "--program", paths["generator"], "--input-dir", src_dir, "--output-dir", out_dir]))
    serve_s = time.perf_counter() - t0
    source = pixels.astype(np.float32) / 127.5 - 1.0
    want = []
    with torch.inference_mode():
        for chunk, n_real in serve.padded_batches(source, 16):
            fake = g(torch.from_numpy(chunk).to(device), None, deterministic=True)
            want.append(fake.float().cpu().numpy()[:n_real])
    want = ((np.concatenate(want) + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
    names = sorted(os.listdir(out_dir))
    if served != 44 or len(names) != 44:
        raise AssertionError(f"served {names}")
    for i, name in enumerate(names):
        path = os.path.join(out_dir, name)
        img = png_io.decode_png_rgba(path, 64, 64)
        if png_io.png_header(path)[2] != 6 or img is None or not np.array_equal(img, want[i]):
            raise AssertionError(f"served {path} is not the module's quantized output")
    log("export", f"served {len(names)} PNGs at batch 16 (3 batches, the last padded) in "
        f"{serve_s:.2f} s: each an RGBA PNG equal to the module's quantized output")

    out = {}
    with torch.inference_mode():
        out["f32_b16"] = (cuda_ms(lambda: pg(x), 50), cuda_ms(lambda: g(x, None, deterministic=True), 50))
        xb = torch.from_numpy(np.random.default_rng(SEED + 1).uniform(
            -1, 1, (1024, 64, 64, 4)).astype(np.float32)).to(device)
        gb = bf16.state.generator
        pb = export.export_generator(bf16.config, gb, 1024).module()
        err = float((pb(xb) - gb(xb, None, deterministic=True)).abs().max())
        out["bf16_b1024"] = (cuda_ms(lambda: pb(xb), 10),
                             cuda_ms(lambda: gb(xb, None, deterministic=True), 10))
    log("export", f"{card}: ms a batch, exported program / eager module: batch 16 float32 "
        f"{out['f32_b16'][0]:.3f} / {out['f32_b16'][1]:.3f}; batch 1024 bfloat16 "
        f"{out['bf16_b1024'][0]:.3f} / {out['bf16_b1024'][1]:.3f} (program vs module max abs "
        f"{err:.3e})")
    return out


def phase_run_experiment(device) -> float:
    """python -m palette_and_histo_gan_tpu_torch.run_experiment at full
    width on the card, synthetic sprites, 4 steps with the three callbacks;
    it must exit 0. Returns its wall seconds."""
    root = os.path.abspath(os.path.join(TEMP_FOLDER, "experiment"))
    os.makedirs(root, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "palette_and_histo_gan_tpu_torch.run_experiment", "--model",
         "histogram", "--synthetic", "--device", str(device), "--steps", "4",
         "--update-steps", "2"],
        cwd=root, env=env, capture_output=True, text=True, timeout=600,
    )
    seconds = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    fids = [line for line in lines if line.startswith("FID: ")]
    log("run_experiment", f"exit {proc.returncode} in {seconds:.1f} s; {fids}; "
        f"last line {lines[-1] if lines else None!r}")
    if proc.returncode != 0 or len(fids) != 3:
        raise AssertionError(f"run_experiment failed: {proc.stderr[-3000:]}")
    return seconds


# ------------------------------------------------- dataset root, torchrun

# the CLI in a process of its own, its kernels' launches printed after it
CLI_WITH_LAUNCHES = textwrap.dedent(
    """
    import json, sys
    from palette_and_histo_gan_tpu_torch import cli
    from palette_and_histo_gan_tpu_torch.ops import augment_kernel, histogram_kernel, palette_kernel
    code = cli.main(sys.argv[1:])
    print(json.dumps({**augment_kernel.launches, **histogram_kernel.launches,
                      **palette_kernel.launches}))
    sys.exit(code)
    """
)


def write_dataset_root(root: str, config, arrays) -> None:
    """(train_sources, train_targets, test_sources, test_targets) as PNGs
    of config's source and target directions in the dataset's layout,
    <root>/<train|test>/<i-direction>/<n>.png, by the port's stdlib PNG
    writer (the card's machine has no PIL)."""
    from palette_and_histo_gan_tpu_torch.config import DIRECTION_FOLDERS
    from palette_and_histo_gan_tpu_torch.utils.visualization import _write_png

    directions = (config.source_direction, config.target_direction)
    for split, pair in (("train", arrays[:2]), ("test", arrays[2:])):
        for direction, images in zip(directions, pair):
            folder = os.path.join(root, split, DIRECTION_FOLDERS[direction])
            os.makedirs(folder)
            for i, img in enumerate(images):
                _write_png(img, os.path.join(folder, f"{i}.png"))


def phase_dataset_root(device) -> dict:
    """The Trainer's default data path on the card: the seeded synthetic
    sets (random sprites; the few-colour set for indexed) written as PNG
    dataset roots, decoded by native/png_io (g++ and zlib) equal to the
    arrays; for indexed, the splits built on the card from the root (K5)
    equal to the ones built from the arrays; then `cli --data-root ROOT`
    (no --synthetic) for histogram and indexed, 4 steps each, in a process
    of its own on the card: it exits 0, and launches K1, K3b and K4b
    (histogram, "pallas2", the CLI's default on a card) or K5 (indexed)."""
    from palette_and_histo_gan_tpu_torch import config_for_variant
    from palette_and_histo_gan_tpu_torch.data import loader
    from palette_and_histo_gan_tpu_torch.native import png_io
    from palette_and_histo_gan_tpu_torch.ops import palette_kernel

    base = os.path.abspath(os.path.join(TEMP_FOLDER, "dataset_root"))
    shutil.rmtree(base, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    need = {"histogram": {"packed": 4, "K3b": 8, "K4b": 4}, "indexed": {"K5": 4}}
    out = {}
    for variant in ("histogram", "indexed"):
        config = config_for_variant(variant, temp_folder=TEMP_FOLDER)
        make = loader.synthetic_indexed_arrays if config.is_indexed else loader.synthetic_arrays
        arrays = make(config, SEED)
        root = os.path.join(base, variant, "dataset")
        t0 = time.perf_counter()
        write_dataset_root(root, config, arrays)
        config = config.replace(data_root=root)
        decoded = loader.load_split_pairs(config)
        if png_io.build_error():
            raise AssertionError(f"the native PNG decoder did not build: {png_io.build_error()}")
        for name, ours, want in zip(("train sources", "train targets", "test sources",
                                     "test targets"), decoded, arrays):
            if not np.array_equal(ours, want):
                raise AssertionError(f"{variant}: the decoded {name} differ from the arrays")
        log("dataset_root", f"{variant}: {sum(len(a) for a in arrays)} PNGs written and decoded "
            f"equal to the arrays in {time.perf_counter() - t0:.1f} s")
        if config.is_indexed:
            palette_kernel.reset_launches()
            built = loader.make_indexed_datasets(config, device)
            if device.type == "cuda":
                torch.cuda.synchronize()
            k5 = palette_kernel.launches["K5"]
            want = loader.indexed_datasets_from_arrays(*arrays, device, config.palette_ordering,
                                                       config.seed)
            for split, ours, theirs in zip(("train", "test"), built, want):
                for field, a, b in zip(ours._fields, ours, theirs):
                    if not torch.equal(a, b):
                        raise AssertionError(f"indexed {split} {field} from the dataset root "
                                             "differ from the ones built from the arrays")
            if device.type == "cuda" and k5 < 4:
                raise AssertionError(f"the indexed dataset build launched K5 {k5} times")
            log("dataset_root", f"indexed splits built on the card from the root (K5 {k5} "
                "launches) equal to the ones built from the arrays")

        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", CLI_WITH_LAUNCHES, "--model", variant, "--data-root", root,
             "--device", str(device), "--steps", "4", "--update-steps", "2"],
            cwd=os.path.join(base, variant), env=env, capture_output=True, text=True,
            timeout=600,
        )
        seconds = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0:
            raise AssertionError(f"cli --data-root ({variant}) exited {proc.returncode}: "
                                 f"{proc.stderr[-3000:]}")
        launches = json.loads(lines[-1])
        short = {k: launches[k] for k, n in need[variant].items() if launches[k] < n}
        log("dataset_root", f"cli --model {variant} --data-root: exit 0 in {seconds:.1f} s; "
            f"launches {launches}; {lines[-2]!r}")
        if device.type == "cuda" and short:
            raise AssertionError(f"cli --data-root ({variant}) did not run the kernels {short}; "
                                 f"needed {need[variant]}")
        out[variant] = {"launches": launches, "seconds": seconds}
    return out


# installed in each torchrun rank (PYTHONPATH): records the paths under the
# working directory that the rank opens for writing, creates, renames or
# removes, and writes them to $PHG_AUDIT_DIR/rank<RANK>.json at exit
AUDIT_SITECUSTOMIZE = textwrap.dedent(
    """
    import atexit, json, os, sys

    _rank = os.environ.get("RANK")
    _root = os.path.realpath(os.getcwd())
    _writes = []
    _WRITE = os.O_WRONLY | os.O_RDWR | os.O_CREAT | os.O_APPEND | os.O_TRUNC

    def _audit(event, args):
        if event == "open":
            path, flags = args[0], args[2]
            if not isinstance(path, (str, bytes)) or not flags & _WRITE:
                return
        elif event in ("os.mkdir", "os.rename", "os.remove"):
            path = args[0]
        else:
            return
        path = os.path.realpath(os.fsdecode(path))
        if path.startswith(_root + os.sep):
            _writes.append([event, path])

    def _report():
        with open(os.path.join(os.environ["PHG_AUDIT_DIR"], f"rank{_rank}.json"), "w") as f:
            json.dump(_writes, f)

    if _rank is not None:
        sys.addaudithook(_audit)
        atexit.register(_report)
    """
)


def phase_torchrun(device) -> dict:
    """`torchrun --standalone --nproc-per-node=N -m
    palette_and_histo_gan_tpu_torch.cli --model histogram --synthetic
    --data-parallel on --batch-size 8 --steps 4 --update-steps 2` over
    NCCL, N the machine's cards (one card: a world of one; on the CPU two
    ranks over Gloo): it exits 0, only rank 0 prints (torchrun's per-rank
    logs) and writes under the working directory (an audit hook in each
    rank). A machine without torchrun fails the phase."""
    world = torch.cuda.device_count() if device.type == "cuda" else 2
    backend = "nccl" if device.type == "cuda" else "gloo"
    torchrun = shutil.which("torchrun") or os.path.join(os.path.dirname(sys.executable), "torchrun")
    if not os.path.isfile(torchrun):
        raise AssertionError("torchrun is not on PATH nor beside the interpreter")
    base = os.path.abspath(os.path.join(TEMP_FOLDER, "torchrun"))
    shutil.rmtree(base, ignore_errors=True)
    run, audit, logs, site = (os.path.join(base, d) for d in ("run", "audit", "logs", "site"))
    for d in (run, audit, site):
        os.makedirs(d)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write(AUDIT_SITECUSTOMIZE)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([site, repo]), PHG_AUDIT_DIR=audit)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [torchrun, "--standalone", f"--nproc-per-node={world}", "--log-dir", logs,
         "--redirects", "1", "-m", "palette_and_histo_gan_tpu_torch.cli", "--device",
         device.type, "--model", "histogram", "--synthetic", "--data-parallel", "on", "--batch-size", "8",
         "--steps", "4", "--update-steps", "2"],
        cwd=run, env=env, capture_output=True, text=True, timeout=600,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"torchrun exited {proc.returncode}: {proc.stderr[-3000:]}")
    import glob

    stdout = {}
    for path in glob.glob(os.path.join(logs, "**", "stdout.log"), recursive=True):
        with open(path) as f:
            stdout[int(os.path.basename(os.path.dirname(path)))] = f.read()
    writes = {}
    for rank in range(world):
        with open(os.path.join(audit, f"rank{rank}.json")) as f:
            writes[rank] = json.load(f)
    start = [line for line in stdout.get(0, "").splitlines() if line.startswith("Starting training")]
    log("torchrun", f"{world} rank(s) over {backend}: exit 0 in {seconds:.1f} s; rank 0: {start}; "
        f"rank 0 wrote {len(writes[0])} paths; ranks above 0 printed "
        f"{sum(len(stdout.get(r, '')) for r in range(1, world))} characters and wrote "
        f"{sum(len(writes[r]) for r in range(1, world))} paths")
    if sorted(stdout) != list(range(world)):
        raise AssertionError(f"torchrun logged ranks {sorted(stdout)}, expected {world}")
    if len(start) != 1 or f"data parallel, {backend} x {world} ranks" not in start[0]:
        raise AssertionError(f"rank 0 did not print the start-up line over {backend}: {start}")
    if not any("training-checkpoints" in p for _, p in writes[0]):
        raise AssertionError("rank 0 wrote no checkpoint (or the audit hook saw no write)")
    loud = {r: stdout[r][-500:] for r in range(1, world) if stdout[r]}
    wrote = {r: writes[r][:5] for r in range(1, world) if writes[r]}
    if loud or wrote:
        raise AssertionError(f"ranks above 0 printed {loud} or wrote {wrote}")
    return {"world": world, "seconds": seconds}


# ---------------------------------------------------------- data parallel

DP_RANKS = 2  # the Gloo ranks that share the card in part 1
DP_LOSS_TOL = dict(rtol=1e-4, atol=1e-6)  # tests/test_torch_parallel.py's
# the parameters after one step: elementwise within the CPU tests' rtol
# 2e-3 / atol 1e-4, and each tensor's change within DP_DELTA_REL of the
# one process's change in Frobenius norm (tests/test_torch_train_step.py
# holds the port to JAX so). After 4 steps they are reported, not gated:
# Adam's m / (sqrt(v) + eps) turns last-bit differences of gradients near 0
# into differences of up to a step (lr 2e-4) and the GAN's next steps
# carry them on; the same one-process fit under other cuDNN algorithms
# (the control beside it) lands further off than the ranks do (on an
# H100 80GB HBM3 at 700 W: changes 5.4e-2 off and 37,937 elements outside,
# against the ranks' 1.0e-2 and 281)
DP_PARAM_TOL = dict(rtol=2e-3, atol=1e-4)
DP_DELTA_REL = 1e-3
# the data-parallel generate's [-1, 1] fakes against generate's: the
# convolutions of 22 rows and of 44 sum in other orders; a row given
# another row's dropout masks is off by tenths
DP_GENERATE_ATOL = 1e-5
DP_STEPS = 4


def dp_histories_close(histories: list, want: list, what: str) -> None:
    for rank, history in enumerate(histories):
        if len(history) != len(want):
            raise AssertionError(f"{what}: rank {rank} logged {len(history)} steps, not {len(want)}")
        for i, (ours, ref) in enumerate(zip(history, want)):
            for k in ref:
                if not math.isclose(ours[k], ref[k], rel_tol=DP_LOSS_TOL["rtol"],
                                    abs_tol=DP_LOSS_TOL["atol"]):
                    raise AssertionError(f"{what}: rank {rank} step {i} {k} {ours[k]!r}, "
                                         f"one process {ref[k]!r}")


def host_params(state) -> dict:
    return {w: {k: v.detach().cpu() for k, v in getattr(state, w).state_dict().items()}
            for w in ("generator", "discriminator")}


def param_deviation(ours: dict, want: dict, initial: dict) -> dict:
    """How far the networks `ours` are from `want`, both trained from
    `initial` (host_params' dicts): the worst tensor's ||ours - want|| over
    ||want - initial|| (delta_rel), the largest elementwise difference, and
    the elements outside DP_PARAM_TOL."""
    out = {"delta_rel": 0.0, "max_abs": 0.0, "outside": 0, "elements": 0}
    for which, tensors in want.items():
        for k, v in tensors.items():
            diff = (ours[which][k] - v).abs()
            out["max_abs"] = max(out["max_abs"], float(diff.max()))
            out["outside"] += int((diff > DP_PARAM_TOL["atol"] + DP_PARAM_TOL["rtol"] * v.abs()).sum())
            out["elements"] += v.numel()
            change = float(torch.linalg.vector_norm(v - initial[which][k]))
            if change > 0:
                out["delta_rel"] = max(out["delta_rel"],
                                       float(torch.linalg.vector_norm(diff)) / change)
    return out


def ranks_bit_equal(fits: list, what: str) -> None:
    for which in ("generator", "discriminator"):
        for k, v in fits[0]["state"][which].items():
            if not all(torch.equal(f["state"][which][k], v) for f in fits[1:]):
                raise AssertionError(f"{what}: the ranks' {which}.{k} differ")


def phase_data_parallel(device, card: str, fid_evaluator) -> dict:
    """Data parallelism on the card, under deterministic cuDNN and float32
    parity:
      1. two Gloo ranks on the one card (parallel/launch.py, each rank a
         process): a full-width histogram "pallas2" b4 float32 Trainer with
         data_parallel="on", fit(1) and fit(4) with the L1 report, against
         the same fits in one process (losses DP_LOSS_TOL; parameters after
         one step DP_PARAM_TOL and DP_DELTA_REL, after four reported beside
         the one-process fit under cudnn.benchmark; the ranks' parameters
         bit-equal; the L1 report; each rank's kernel launches equal to the
         one process's); the data-parallel generate
         of 44 sources, dropout on, against generate (DP_GENERATE_ATOL),
         with a control that must miss it: rank 1 drawing only its own
         rows' masks (CUDA's draws of 22 and 44 rows agreed on their first
         22 at these shapes, so the check holds the data-parallel generate
         equal to generate and does not test that draws of other shapes
         differ); the sharded
         FID activations (batch 11 rounded up to 12) against the unsharded
         ones (FID_ACT_REL of the largest); no rank imports jax;
      2. NCCL at world size 1 in this process, the production backend:
         histogram "pallas2" b1024 bfloat16, a 10-step chunk after a 2-step
         warm-up, data parallel against one device in turns (one, DP, DP,
         one), and the two gradient all_reduces of a step timed alone
         with CUDA events;
      3. NCCL across min(4, count) cards where there are two or more: part
         1's equality check and part 2's timing with img/s a card; on one
         card the part is skipped, which is the hardware's limit."""
    import shutil

    from palette_and_histo_gan_tpu_torch import config_for_variant, set_deterministic_mode
    from palette_and_histo_gan_tpu_torch.ops import augment_kernel, histogram_kernel, palette_kernel
    from palette_and_histo_gan_tpu_torch.ops.image import normalize
    from palette_and_histo_gan_tpu_torch.parallel import distributed
    from palette_and_histo_gan_tpu_torch.parallel.launch import launch
    from palette_and_histo_gan_tpu_torch.train.state import create_train_state
    from palette_and_histo_gan_tpu_torch.train.steps import generate
    from palette_and_histo_gan_tpu_torch.train.trainer import Trainer

    set_deterministic_mode()
    root = os.path.join(TEMP_FOLDER, "data_parallel")
    shutil.rmtree(root, ignore_errors=True)
    out = {}
    fit_config = dict(model="histogram", histogram_impl="pallas2", batch_size=4)

    # the one-process runs on the card, the 4-step one's launches counted,
    # and the control: the 4 steps under cudnn.benchmark (other algorithms)
    def one_process(steps: int, folder: str, benchmark: bool = False):
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = not benchmark, benchmark
        cfg = config_for_variant("histogram", histogram_impl="pallas2", batch_size=4,
                                 temp_folder=os.path.join(root, folder))
        t = Trainer(cfg, device, synthetic_datasets(cfg, device))
        t.fit(steps, update_steps=steps, callbacks=["evaluate_l1"])
        set_deterministic_mode()
        return t

    counters = (augment_kernel, histogram_kernel, palette_kernel)
    for c in counters:
        c.reset_launches()
    ref = one_process(DP_STEPS, "one")
    torch.cuda.synchronize()
    ref_launches = {k: v for c in counters for k, v in c.launches.items()}
    ref_cfg, ref_l1 = ref.config, ref.report_l1()
    ref_one = host_params(one_process(1, "one-step").state)
    control = param_deviation(host_params(one_process(DP_STEPS, "benchmark", True).state),
                              host_params(ref.state),
                              initial := host_params(create_train_state(ref_cfg, device,
                                                                        ref_cfg.seed)))

    sources = normalize(ref.test_ds.sources.float())
    gen_state = create_train_state(ref_cfg, device, 0)
    drop = torch.Generator(device=device)
    drop.manual_seed(SEED)
    want = generate(ref_cfg, gen_state.generator, sources, drop)
    # the control, which the gate must see: rank 1 drawing the masks of its
    # own 22 rows from the state every rank holds, which gives it rank 0's
    drop.manual_seed(SEED)
    naive = generate(ref_cfg, gen_state.generator, sources[22:], drop)
    naive_err = float((naive - want[22:]).abs().max())
    if not naive_err > DP_GENERATE_ATOL:
        raise AssertionError(f"rank 1 drawing its own rows' masks is {naive_err} off generate, "
                             f"within DP_GENERATE_ATOL {DP_GENERATE_ATOL}: the gate cannot see it")
    images = torch.from_numpy(fid_sprites(44, SEED + 9))
    want_acts = fid_evaluator.activations(images).cpu()

    def scenarios(folder: str) -> list:
        return [
            ("fit", dict(config=dict(fit_config, temp_folder=os.path.join(folder, "rank{rank}")),
                         steps=DP_STEPS, update_steps=DP_STEPS, data_seed=SEED,
                         callbacks=("evaluate_l1",))),
            ("fit", dict(config=dict(fit_config, temp_folder=os.path.join(folder, "step")),
                         steps=1, update_steps=1, data_seed=SEED)),
            ("generate", dict(config=fit_config, sources=[sources.cpu()], dropout_seed=SEED)),
            ("fid", dict(images=images, input_size=fid_evaluator.input_size,
                         reference_quirks=fid_evaluator.reference_quirks)),
        ]

    def check_world(results: list, what: str) -> dict:
        for rank, rank_results in enumerate(results):
            for r in rank_results:
                if "error" in r or r["jax_loaded"]:
                    raise AssertionError(f"{what}: rank {rank}: {r.get('error', 'imported jax')}")
        fits, steps1, gens, fids = ([r[i] for r in results] for i in range(4))
        dp_histories_close([f["history"] for f in fits], ref.history, what)
        ranks_bit_equal(fits, what)
        ranks_bit_equal(steps1, what)
        step1 = param_deviation(steps1[0]["state"], ref_one, initial)
        if step1["outside"] or not step1["delta_rel"] <= DP_DELTA_REL:
            raise AssertionError(f"{what}: after one step the parameters are {step1} off")
        params = param_deviation(fits[0]["state"], host_params(ref.state), initial)
        for f in fits:
            if not all(math.isclose(a, b, rel_tol=DP_LOSS_TOL["rtol"], abs_tol=DP_LOSS_TOL["atol"])
                       for a, b in zip(f["l1"], ref_l1)):
                raise AssertionError(f"{what}: L1 report {f['l1']}, one process {ref_l1}")
            if f["launches"] != ref_launches:
                raise AssertionError(f"{what}: a rank launched {f['launches']}, one process "
                                     f"{ref_launches}")
        if [f["writes"] for f in fits] != [True] + [False] * (len(fits) - 1):
            raise AssertionError(f"{what}: writing ranks {[f['writes'] for f in fits]}")
        gen_err = max(float((g["outputs"][0] - want.cpu()).abs().max()) for g in gens)
        if not gen_err <= DP_GENERATE_ATOL:
            raise AssertionError(f"{what}: the data-parallel generate is {gen_err} off generate")
        scale = float(want_acts.abs().max())
        fid_err = max(float((f["activations"] - want_acts).abs().max()) for f in fids)
        if not (all(f["batch_size"] == 12 for f in fids) and fid_err <= FID_ACT_REL * scale):
            raise AssertionError(f"{what}: sharded FID activations {fid_err} off (scale {scale})")
        log("data_parallel", f"{what}: {len(fits)} ranks == one process over {DP_STEPS} steps "
            f"(last G total {fits[0]['history'][-1]['generator/total_loss']!r} / "
            f"{ref.history[-1]['generator/total_loss']!r}; parameters after one step: each "
            f"tensor's change within {step1['delta_rel']:.3e} of the one process's (gate "
            f"{DP_DELTA_REL}), elementwise at most {step1['max_abs']:.3e} apart, "
            f"{step1['outside']} of {step1['elements']:,} outside rtol 2e-3 / atol 1e-4; after "
            f"{DP_STEPS} steps {params['delta_rel']:.3e}, {params['max_abs']:.3e}, "
            f"{params['outside']} outside, against the one process under cudnn.benchmark "
            f"{control['delta_rel']:.3e}, {control['max_abs']:.3e}, {control['outside']} outside; "
            f"ranks bit-equal; L1 {fits[0]['l1']} / {list(ref_l1)}); each rank's launches "
            f"{fits[0]['launches']} == one process's; generate of 44 with dropout {gen_err:.3e} "
            f"off generate (rank 1 drawing its own 22 rows' masks: {naive_err:.3e}); sharded FID "
            f"activations {fid_err:.3e} off (largest {scale:.3e})")
        return {"launches": fits[0]["launches"], "params_step1": step1, "params": params,
                "control": control, "generate_err": gen_err,
                "naive_generate_err": naive_err, "fid_err": fid_err}

    t0 = time.perf_counter()
    results = launch(DP_RANKS, scenarios(os.path.join(root, "gloo")), device=str(device),
                     backend="gloo", timeout=600)
    out["gloo_s"] = time.perf_counter() - t0
    out["gloo"] = check_world(results, f"part 1, {DP_RANKS} Gloo ranks on {device}")
    if os.path.exists(os.path.join(root, "gloo", "rank1")):
        raise AssertionError("rank 1 wrote files")

    # part 2: NCCL at world size 1, timed against one device in this process
    timed_cfg = dict(compute_dtype="bfloat16", batch_size=1024, histogram_impl="pallas2")
    distributed.initialize(backend="nccl", device=device)
    try:
        trainers = {}
        for mode in ("off", "on"):
            cfg = config_for_variant("histogram", data_parallel=mode,
                                     temp_folder=os.path.join(root, f"nccl-{mode}"), **timed_cfg)
            trainers[mode] = Trainer(cfg, device, synthetic_datasets(cfg, device))
            trainers[mode].fit(2, update_steps=2)  # warm-up: cuDNN plans, allocator
        dp = trainers["on"]
        if dp.group is None or dp.group.world_size != 1 or \
                torch.distributed.get_backend() != "nccl":
            raise AssertionError("part 2 did not train over NCCL at world size 1")
        times = {"off": [], "on": []}
        for mode in ("off", "on", "on", "off"):
            t = trainers[mode]
            before = t.phase_seconds["train_chunk"]
            t.fit(10, update_steps=10)
            times[mode].append(1e3 * (t.phase_seconds["train_chunk"] - before) / 10)
            check_finite(t.history[-1], f"NCCL part, data_parallel={mode}")
        grads = [[p.grad for p in m.parameters() if p.grad is not None]
                 for m in (dp.state.generator, dp.state.discriminator)]
        numel = [sum(g.numel() for g in gs) for gs in grads]
        allreduce_ms = cuda_ms(lambda: [dp.group.all_reduce_mean_(gs) for gs in grads], 20)
    finally:
        distributed.shutdown()
    out["nccl1"] = {"single_ms": times["off"], "dp_ms": times["on"], "allreduce_ms": allreduce_ms,
                    "grad_numel": numel}
    log("data_parallel", f"part 2, {card}: NCCL at world size 1, histogram pallas2 b1024 bf16, "
        f"ms/step (10-step chunks in turns) one device {times['off'][0]:.3f}, DP "
        f"{times['on'][0]:.3f}, DP {times['on'][1]:.3f}, one device {times['off'][1]:.3f}; the "
        f"step's two gradient all_reduces ({numel[0]:,} + {numel[1]:,} float32) "
        f"{allreduce_ms:.4f} ms")

    count = torch.cuda.device_count()
    if count < 2:
        log("data_parallel", f"part 3 skipped: {count} card; NCCL across cards needs two or more")
        return out
    world = min(4, count)
    timing = ("fit", dict(config=dict(model="histogram", temp_folder=os.path.join(
        root, "nccl-cards-timed", "rank{rank}"), **timed_cfg), steps=10, update_steps=10,
        data_seed=SEED, warmup_steps=2))
    t0 = time.perf_counter()
    results = launch(world, scenarios(os.path.join(root, "nccl-cards")) + [timing],
                     device="cuda", backend="nccl", timeout=900)
    out["cards_s"] = time.perf_counter() - t0
    out["cards"] = check_world([r[:4] for r in results], f"part 3, NCCL over {world} cards")
    if any("error" in r[4] for r in results):
        raise AssertionError(f"part 3's timed fit: {[r[4].get('error') for r in results]}")
    ms = 1e3 * results[0][4]["phase_seconds"]["train_chunk"] / 10
    out["cards"].update(world=world, ms_per_step=ms,
                        img_per_s_card=timed_cfg["batch_size"] / world / (ms / 1e3))
    log("data_parallel", f"part 3, {card}: NCCL over {world} cards, histogram pallas2 b1024 "
        f"bf16 (global), {ms:.3f} ms/step, {out['cards']['img_per_s_card']:.1f} img/s a card")
    return out


# ------------------------------------------------------------------- main


LIBRARIES = (("phg_augment", "augment.cu"), ("phg_histogram", "histogram.cu"),
             ("phg_palette", "palette.cu"))


def build_kernels() -> None:
    """The three libraries, with their nvcc processes at once."""
    from concurrent.futures import ThreadPoolExecutor

    from palette_and_histo_gan_tpu_torch.kernels import build
    from palette_and_histo_gan_tpu_torch.ops import augment_kernel, histogram_kernel, palette_kernel

    t0 = time.perf_counter()
    loaders = (augment_kernel.library, histogram_kernel.library, palette_kernel.library)
    with ThreadPoolExecutor(len(loaders)) as pool:
        for job in [pool.submit(f) for f in loaders]:
            job.result()
    for name, source in LIBRARIES:
        log("build", f"{source} -> sm_90a: nvcc {build.build_seconds.get(name, 0.0):.2f} s "
            "(0 when already built)")
    log("build", f"all built and loaded in {time.perf_counter() - t0:.2f} s")


# the histogram kernels on the tensor cores
TENSOR_CORE_KERNELS = ("hist_fwd_f32", "hist_fwd_bf16", "hist_bwd_bf16")


def tensor_core_report() -> dict:
    """For each instantiation of the tensor-core kernels (hist_fwd_f32,
    hist_fwd_bf16 and hist_bwd_bf16, a method each) and of the float32 backward
    (hist_bwd_f32): ptxas' registers and spill bytes from the build, and
    its count of HGMMA (wgmma) instructions in the built library's SASS
    (cuobjdump). Fails if a tensor-core kernel has none, or spills."""
    import re

    from palette_and_histo_gan_tpu_torch.kernels import build
    from palette_and_histo_gan_tpu_torch.ops import histogram_kernel

    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", histogram_kernel.library()._name],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    hgmma, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
        elif name and "HGMMA" in line:
            hgmma[name] = hgmma.get(name, 0) + 1
    ptxas = {}
    for block in build.build_reports.get("phg_histogram", "").split("Compiling entry function '")[1:]:
        fn = block.split("'")[0]
        regs = re.search(r"Used (\d+) registers", block)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        ptxas[fn] = (int(regs.group(1)) if regs else None,
                     tuple(int(v) for v in spills.groups()) if spills else None)
    out = {}
    for fn in sorted(set(ptxas) | set(hgmma)):
        kernel = next((k for k in TENSOR_CORE_KERNELS + ("hist_bwd_f32",) if k in fn), None)
        if kernel is None:
            continue
        method = "RBF" if "ILi1E" in fn else "inverse-quadratic"
        regs, spills = ptxas.get(fn, (None, None))
        out[(kernel, method)] = {"hgmma": hgmma.get(fn, 0), "registers": regs, "spill_bytes": spills}
        log("build", f"{kernel}<{method}>: {hgmma.get(fn, 0)} HGMMA in the SASS; ptxas: "
            f"{regs} registers, spill stores/loads {spills} bytes (None: built before this process)")
    tensor_core = {k: r for k, r in out.items() if k[0] != "hist_bwd_f32"}
    if len(out) != 8 or not all(r["hgmma"] for r in tensor_core.values()):
        raise AssertionError(f"a tensor-core histogram kernel lacks tensor-core instructions: {out}")
    if any(r["spill_bytes"] not in (None, (0, 0)) for r in tensor_core.values()):
        raise AssertionError(f"a tensor-core histogram kernel spills registers: {out}")
    return out


def scope_cost_us(n: int = 10000) -> float:
    """Host microseconds of one enter and exit of config.py::float32_exact,
    the scope a float32 Trainer enters around each chunk, fit and report."""
    from palette_and_histo_gan_tpu_torch.config import float32_exact

    t0 = time.perf_counter()
    for _ in range(n):
        with float32_exact():
            pass
    return 1e6 * (time.perf_counter() - t0) / n


def timed_row(r: dict) -> str:
    return (f"{r['ms_per_step']:.3f} / {r['device_ms_per_step']:.3f} / {r['img_per_s']:.1f} / "
            f"{100 * r['mfu']:.2f}%")


def kernel_entry(name, source, replaces, launches, max_abs_err, times) -> dict:
    """One entry of the kernels line; `times` is (kernel ms, plain ms,
    bound ms, what bounds it). No single PyTorch call computes any of these
    functions, so library_ms is null."""
    ms, plain_ms, bound_ms, bound_by = times
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA device; this smoke runs only on a GPU",
              file=sys.stderr)
        return 1
    from palette_and_histo_gan_tpu_torch import set_f32_parity_mode

    device = torch.device("cuda", 0)
    card = card_line()
    log("device", f"{card}; {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    build_kernels()
    tensor_core_report()
    kern = phase_kernel_vs_plain(device)
    set_f32_parity_mode()
    hist = {"worst": phase_histogram_check(device), "times": phase_histogram_times(device)}

    for label in ("xla/tri", "pallas", "bwd=pallas"):
        worst = phase_parity(device, "histogram", dict(batch_size=4, **HIST_CONFIGS[label][0]))
        log("parity", f"{label}: worst relative loss difference {worst:.2e} (tol {PARITY_RTOL})")
    baseline_parity = {variant: phase_parity(device, variant, dict(batch_size=4))
                       for variant in BASELINE_VARIANTS}
    log("parity", f"baseline variants: worst relative loss differences {baseline_parity} "
        f"(tol {PARITY_RTOL})")
    bf16_parity = [
        phase_parity(device, "histogram", dict(batch_size=4, compute_dtype="bfloat16",
                                               **HIST_CONFIGS["pallas2"][0]),
                     BF16_PARITY_RTOL, seed)
        for seed in BF16_PARITY_SEEDS
    ]
    log("parity", f"pallas2 bfloat16, seeds {BF16_PARITY_SEEDS}: worst relative loss "
        f"differences {', '.join(f'{w:.2e}' for w in bf16_parity)} (tol {BF16_PARITY_RTOL})")

    launches = {}
    for label, (overrides, names) in HIST_CONFIGS.items():
        counts = phase_main_path(device, "histogram", dict(batch_size=4, **overrides), names)
        if label == "xla/tri":
            launches.update(packed=counts["packed"], rgba=counts["rgba"])
        launches.update({name: counts[name] for name in names})
    baseline_launches = {variant: phase_main_path(device, variant, dict(batch_size=4))
                         for variant in BASELINE_VARIANTS}

    pal = phase_palette_check(device)
    worst = phase_indexed_parity(device)
    log("parity", f"indexed: worst relative loss difference {worst:.2e} (tol {PARITY_RTOL})")
    launches.update(phase_indexed_main_path(device))
    dataset_root = phase_dataset_root(device)
    reference = phase_reference_weights(device)

    f32 = phase_timed_chunk(device, "histogram", "float32", dict(batch_size=4), steps=40)
    f32_pallas2 = phase_timed_chunk(device, "histogram", "float32",
                                    dict(batch_size=4, **HIST_CONFIGS["pallas2"][0]), steps=40)
    bf16 = {
        label: phase_timed_chunk(device, "histogram", "bfloat16",
                                 dict(batch_size=1024, **overrides), steps=10,
                                 bf16_kernels=[n for n in names if n in BF16_LAUNCHES_A_STEP])
        for label, (overrides, names) in HIST_CONFIGS.items()
    }
    baseline_bf16 = {variant: phase_timed_chunk(device, variant, "bfloat16",
                                                dict(batch_size=1024), steps=10)
                     for variant in BASELINE_VARIANTS}
    idx_f32 = phase_timed_chunk(device, "indexed", "float32", dict(batch_size=4), steps=40)
    idx_bf16 = phase_timed_chunk(device, "indexed", "bfloat16", dict(batch_size=1024), steps=10)
    fid_out, fid_evaluator = phase_fid(device, card)
    life, trained, bf16_trainer = phase_lifecycle(device, card, fid_evaluator)
    exp = phase_export(device, card, trained, bf16_trainer)
    dp = phase_data_parallel(device, card, fid_evaluator)
    torchrun = phase_torchrun(device)
    experiment_s = phase_run_experiment(device)
    scope_us = scope_cost_us()
    if "jax" in sys.modules:
        raise AssertionError("the port loaded jax")

    kernels = [
        kernel_entry(f"augment_{entry}", SOURCE, REPLACES[entry], launches[entry],
                     kern["worst"][entry], kern["times"][(entry, 1024)])
        for entry in ("packed", "rgba")
    ]
    kernels += [
        kernel_entry(name, HIST_SOURCE, replaces, launches[name], hist["worst"][name],
                     hist["times"][(name, 1024)])
        for name, (_, replaces, _) in HIST_KERNELS.items()
    ]
    # the tensor-core kernels run in the b1024 bf16 chunks
    for entry in kernels:
        if entry["name"] in BF16_LAUNCHES_A_STEP:
            entry["bf16_launches"] = sum(r["bf16_launches"][entry["name"]] for r in bf16.values())
    kernels.append(kernel_entry("K5", PAL_SOURCE, PAL_REPLACES, launches["K5"], 0,
                                pal["times"][pal["n_images"]]))
    # the launches of the lifecycle phase's uninterrupted histogram run and
    # of its indexed run
    for entry in kernels:
        name = {"augment_packed": "packed"}.get(entry["name"], entry["name"])
        counts = life["indexed_launches"] if name == "K5" else life["launches"]
        if counts.get(name):
            entry["lifecycle_launches"] = counts[name]
    # a data-parallel rank's launches in the Gloo part of the DP phase
    for entry in kernels:
        name = {"augment_packed": "packed"}.get(entry["name"], entry["name"])
        if dp["gloo"]["launches"].get(name):
            entry["dp_rank_launches"] = dp["gloo"]["launches"][name]
    # the augment kernels' launches in the baseline main path (baseline-no-aug
    # launched none: phase_main_path holds it to that)
    for entry in kernels:
        name = {"augment_packed": "packed", "augment_rgba": "rgba"}.get(entry["name"])
        if name:
            entry["baseline_launches"] = baseline_launches["baseline"][name]
    # the launches of the CLI's dataset-root runs
    for entry in kernels:
        name = {"augment_packed": "packed"}.get(entry["name"], entry["name"])
        counts = dataset_root["indexed" if name == "K5" else "histogram"]["launches"]
        if counts.get(name):
            entry["dataset_root_launches"] = counts[name]
    # the launches of the reference-weight phase's 4-step fit
    for entry in kernels:
        name = {"augment_packed": "packed"}.get(entry["name"], entry["name"])
        if name in ("packed", "K3b", "K4b"):
            entry["reference_weights_launches"] = reference["launches"][name]
    # K3a beside the bound of its products as float32 FMAs
    k3a = next(e for e in kernels if e["name"] == "K3a")
    k3a["bound_f32_fma_ms"] = hist["times"][("K3a fma", 1024)][0]
    log("summary", f"{card}: b4 kernel/plain ms "
        + ", ".join(f"{e} {kern['times'][(e, 4)][0]:.4f}/{kern['times'][(e, 4)][1]:.4f}" for e in ("packed", "rgba"))
        + ", " + ", ".join(f"{n} {hist['times'][(n, 4)][0]:.4f}/{hist['times'][(n, 4)][1]:.4f}" for n in HIST_KERNELS)
        + f", K5 {pal['times'][4][0]:.4f}/{pal['times'][4][1]:.4f}"
        + f"; K3a b1024 {k3a['ms']:.4f} ms: {100 * k3a['bound_ms'] / k3a['ms']:.1f}% of its 3xTF32 bound "
        + f"{k3a['bound_ms']:.4f} ms, {100 * k3a['bound_f32_fma_ms'] / k3a['ms']:.1f}% of the float32-FMA "
        + f"bound {k3a['bound_f32_fma_ms']:.4f} ms"
        + f"; steps (host ms / device ms / img/s / MFU): histogram f32 b4 {timed_row(f32)} "
        + f"(pallas2 {timed_row(f32_pallas2)}); bf16 b1024 "
        + ", ".join(f"{label} {timed_row(r)} {r['peak_gib']:.2f} GiB" for label, r in bf16.items())
        + "; bf16 b1024 " + ", ".join(f"{v} {timed_row(r)} {r['peak_gib']:.2f} GiB"
                                      for v, r in baseline_bf16.items())
        + f"; baseline parity (f32 b4, card vs CPU) "
        + ", ".join(f"{v} {w:.2e}" for v, w in baseline_parity.items())
        + f"; indexed f32 b4 {timed_row(idx_f32)}, bf16 b1024 {timed_row(idx_bf16)} "
        + f"{idx_bf16['peak_gib']:.2f} GiB"
        + f"; bf16 parity (pallas2 b4, card vs CPU) {'/'.join(f'{w:.2e}' for w in bf16_parity)}"
        + f"; reference weights: converter {reference['convert_s']:.1f} s, card forward "
        + f"{reference['forward_rel']:.2e} of max, phase {reference['seconds']:.1f} s"
        + f"; lifecycle b1024 bf16 {life['train_chunk_ms_per_step']:.3f} ms/step, preview "
        + f"{life['preview_ms']:.2f} ms, save held {life['save_held_ms']:.2f} ms, checkpoint "
        + f"{life['ckpt_bytes']} bytes (b4 f32 {life['ckpt_bytes_f32']})"
        + f"; FID: Inception b{FID_BATCH} {fid_out['forward_ms']:.3f} ms ({fid_out['img_per_s']:.1f} img/s, "
        + f"bound {fid_out['bound_ms']:.3f} ms), report_fid {life['report_fid_s']:.4f} s, evaluate_fid "
        + f"{life['evaluate_fid_s']:.4f} s a report (b1024 bf16 fit), low-rank {fid_out['fid_lowrank']:.6f} / "
        + f"eigh {fid_out['fid_eigh']:.6f} / scipy {fid_out['fid_scipy']:.6f}"
        + f"; export ms program/eager b16 f32 {exp['f32_b16'][0]:.3f}/{exp['f32_b16'][1]:.3f}, b1024 bf16 "
        + f"{exp['bf16_b1024'][0]:.3f}/{exp['bf16_b1024'][1]:.3f}"
        + f"; data parallel: {DP_RANKS} Gloo ranks on the card == one process ({dp['gloo_s']:.1f} s), "
        + f"generate {dp['gloo']['generate_err']:.2e} off; NCCL world 1 b1024 bf16 pallas2 "
        + f"{'/'.join(f'{v:.3f}' for v in dp['nccl1']['dp_ms'])} ms/step vs one device "
        + f"{'/'.join(f'{v:.3f}' for v in dp['nccl1']['single_ms'])}, gradient all_reduces "
        + f"{dp['nccl1']['allreduce_ms']:.4f} ms a step"
        + (f"; NCCL over {dp['cards']['world']} cards {dp['cards']['ms_per_step']:.3f} ms/step "
           f"{dp['cards']['img_per_s_card']:.1f} img/s a card" if "cards" in dp else "")
        + f"; cli --data-root histogram {dataset_root['histogram']['seconds']:.1f} s, indexed "
        + f"{dataset_root['indexed']['seconds']:.1f} s; torchrun x {torchrun['world']} "
        + f"{torchrun['seconds']:.1f} s"
        + f"; run_experiment {experiment_s:.1f} s"
        + f"; float32_exact {scope_us:.2f} us a scope (host)"
        + f"; smoke {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
