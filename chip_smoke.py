#!/usr/bin/env python3
"""Smoke run of the PyTorch port (palette_and_histo_gan_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions; exits 1 without a CUDA device.
  2. build: compiles the fused augmentation kernel (csrc/augment.cu), the
     fused histogram kernels (csrc/histogram.cu), the palette index
     kernel (csrc/palette.cu), the InstanceNorm moments kernel
     (csrc/moments.cu) and the indexed losses' pair (csrc/indexed_loss.cu)
     with nvcc for sm_90a from this checkout, the five nvcc processes at
     once; prints ptxas' registers and spills of
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
  7a. InstanceNorm moments (phase_in_stats): kernel K6 against its plain
     version, within MOMENTS_RTOL (1e-5) of each output's largest |plain
     value|, at the A/B's four bfloat16 B=1024 decoder shapes, float32 B=4
     at the generator's InstanceNorm shapes and B=5 (no multiple of 8) in
     both dtypes, each contiguous (NCHW) and channels_last (NHWC), the
     outputs' memory filled with NaN first and two launches bit-equal;
     its launches equal to the calls made. Then its main path, the A/B of
     bench_in_stats.py (the networks' two reductions, the ones contraction
     on cuBLAS, K6) at the four shapes in both layouts, with K6's launches
     counted around it; K6 and its plain version timed at the largest
     NCHW shape; the networks' statistics and K6 at b1024 bfloat16 at each
     InstanceNorm input of the generator, in the layout the card's
     networks hold it.
  7b. indexed losses (phase_indexed_loss): the kernel pair CCE-fwd /
     CCE-bwd (csrc/indexed_loss.cu, which replaces no TPU kernel) against
     its plain version at B = 1024 and 4, float32 and bfloat16 logits in
     the generator's view of NCHW memory (its head's output on the card),
     labels past 255 and negative, rows
     past each clip bound, under the step's upstream gradients and a
     nonzero L1 one: each loss within CCE_TOL of its plain value, the
     gradient within CCE_TOL of the largest plain entry; two launches of
     each bit-equal; a row whose lse - z_t sits on each clip bound (the
     bound moved onto it) passes its gradient, a float32 step outside cuts
     it; launches equal to calls; the full-width generator's float32 and
     bfloat16 logits taken as they are, channels-last logits refused.
     Times both kernels against their bytes bound and the plain forward +
     backward at each shape.
  7c. decoder layouts (phase_decoder_layouts): each of the generator's
     six UpBlocks at B=1024 float32, dropout on where the block has it,
     forward and backward to its input and parameters, in the NCHW
     formulation (cuDNN's transposed convolution on contiguous input, a
     contiguous dropout mask) and as the port's UpBlock (NHWC, a forward
     convolution) on the NHWC-strided input the skip concatenation hands
     it (the 1x1 bottleneck with NCHW strides): CUDA events, parent, port,
     port, parent; the transposed convolution's TFLOP/s; the device kernels
     of one forward and backward of each; the outputs within DECODER_TOL
     of each other.
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
 10a. the measurement tools, each phase's seconds printed. sweep
     (phase_sweep): the port's sweep.py in one process under `torchrun
     --nproc-per-node=1`, its launches printed after it: the four variants
     at b4 float32 and b1024 bfloat16 (SWEEP_STEPS timed steps after as
     many of warm-up), then a histogram b1024 bfloat16 row data parallel
     over NCCL at world size 1 (and one over every card where there are
     more); every row error-free, finite, on the device clock, with K1
     once a step for baseline and histogram, K3b twice and K4b once for
     histogram, nothing for the others; the histogram b1024 bfloat16
     device ms/step within 5% of the timed chunk's. infer (phase_infer):
     bench_infer.py for baseline-no-aug and indexed at batches 64 and
     1024, bfloat16, dropout on and off; finite checksums; at b1024 the
     chunk's checksum equal to direct generate calls over the same batches
     and draws (INFER_REL). components (phase_components):
     profile_components.py under "pallas2" at b1024 bfloat16 and b4
     float32; augment launches K1 once a call, hist_fwd_bwd K3b twice and
     K4b once; every time finite and positive. roofline
     (phase_roofline): roofline.py for histogram "pallas2", baseline-no-aug
     and indexed at b1024 bfloat16; the groups sum to the profiled steps'
     device time within 1%, unattributed at most 5%, no group under 0.95
     of its floor.
 10b. the regime's entry points, on one seeded synthetic dataset root
     (ref_regime.py's few-colour 250 / 44 pairs, PNGs) and each in this
     process through its main. shared_inception
     (phase_shared_inception): `convert_inception --shared-init F` writes
     scripts/make_shared_inception.py's shared-init InceptionV3 without
     TensorFlow, timed; F's digest the pinned one; 22 sprites'
     activations at input 299 from F on the card within 1e-4 of the CPU's
     largest, both quirk modes, and their spread across images above
     SHARED_SPREAD_REL. reference regime (phase_reference_regime):
     compare_reference_train at full width, 126 steps (two epochs) with an
     eval every 63, for baseline-no-aug, histogram and indexed, each
     against the repository's JAX build record of its variant (another
     step count: not compared), the RGBA variants with their FID at steps
     63 and 126 on F; finite curves, eval L1s and FIDs, the low-rank FID
     within REGIME_FID_REL of the scipy one, the record's
     keys a superset of that JAX record's, the first two steps' losses
     within PARITY_RTOL of the same two steps on the CPU from the same
     root, histogram launching K3b twice and K4b once a step, indexed K5
     four times in its dataset build. measure_baseline
     (phase_measure_baseline): the four variants for one epoch (63 steps)
     with the Trainer's previews, L1 reports and checkpoints and the FID
     reports (random InceptionV3 weights); finite L1s and FIDs, 63 steps,
     the keys of baseline_results.json's entries, `train_chunk` among the
     phases, each variant's launches (K1 once a step for baseline and
     histogram, K3b twice and K4b once for histogram, K5 four times for
     indexed, none for baseline-no-aug). measure_baseline_dp
     (phase_measure_baseline_dp): `torchrun --standalone
     --nproc-per-node=<cards> -m palette_and_histo_gan_tpu_torch.
     measure_baseline --epochs 1 --variants baseline-no-aug histogram`
     over NCCL (one card: a world of one) with per-rank logs and the audit
     hook: only rank 0 prints and writes, and it wrote the record;
     `world_size` the cards; each rank's launches K1 63, K3b 126, K4b 63;
     L1s and FIDs finite and within BASELINE_DP_REL of measure_baseline's
     record. bench (phase_bench): the port's
     bench.py at b1024 bfloat16, 60 steps, its line printed; its img/s
     within 5% of the histogram "pallas2" b1024 bfloat16 timed chunk's
     device clock (the same program). Each phase's seconds printed. Then
     the host cost of the step's spans (range_cost_us).
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
K5 theirs in the CLI's dataset-root runs (dataset_root_launches); K1,
K3b and K4b theirs in the sweep's process (sweep_launches); the
kernels that the regime's entry points launch, their launches in
compare_reference_train's three runs (regime_launches), in
measure_baseline's four fits (measure_baseline_launches), in rank 0 of
measure_baseline under torchrun (measure_baseline_dp_rank_launches) and in
bench's run (bench_launches). K6, at
MOMENTS_ENTRY_ROW, its launches those of the A/B, gives the A/B's forms A
and B at that row (ab_ms), every A/B row (ab_rows) and the generator's
InstanceNorm inputs at b1024 with form A's and K6's times
(instance_norm_step), and its device time beside its plain version's at the
A/B's smallest NCHW row (small_device_ms). CCE, the indexed losses' pair,
replaces no TPU kernel (`replaces` null): its ms are CCE-fwd + CCE-bwd at
the float32 b1024 step's logits (NCHW memory), beside their bytes bound and the plain
forward + backward, with every checked shape's times (times); its launches
are the indexed main path's (one of each a step), the phase's checks under
check_launches.
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

from palette_and_histo_gan_tpu_torch.utils.profiling import card_line
from palette_and_histo_gan_tpu_torch.utils.roofline import (AUGMENT_OPS_PER_PIXEL, PEAK, bound,
                                                         histogram_bound)

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
# the augment kernel entries and the TPU kernels they replace (each
# kernel's source and TPU body: palette_and_histo_gan_tpu_torch/kernels/table.py)
AUGMENT_KERNELS = {"packed": "K1", "rgba": "K2"}
# TPU kernel -> (direction, the chains its configuration runs)
HIST_KERNELS = {
    "K3a": ("fwd", ("float32",)),
    "K3b": ("fwd", ("float32", "bfloat16")),
    "K4a": ("bwd", ("float32",)),
    "K4b": ("bwd", ("float32", "bfloat16")),
    "K4c": ("bwd", ("float32", "bfloat16")),
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
ARGMAX_AGREEMENT = 0.999
# the RGBA variants without the histogram: baseline augments (K1, K2),
# baseline-no-aug only normalizes (no kernel)
BASELINE_VARIANTS = ("baseline", "baseline-no-aug")
# logs of the smoke's Trainers go under a folder .gitignore lists
TEMP_FOLDER = os.path.join("build", "chip_smoke")

# PEAK, bound, histogram_bound and AUGMENT_OPS_PER_PIXEL: utils/roofline.py;
# card_line: utils/profiling.py


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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
        for name, (direction, chains) in HIST_KERNELS.items():
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


# HistoGAN's histogram shape: paper256's minibatch, 150x150 pixels (the
# resize of train/histogan.py), not a multiple of the kernels' 64-pixel tile
HISTOGAN_HIST_SHAPE = (64, 150 * 150)


def phase_histogram_padded(device, shape=HISTOGAN_HIST_SHAPE, iters: int = 20) -> dict:
    """K3b and K4b in a float32 chain through FusedHistogram at a pixel
    count that is not a multiple of 64 (the pad path: Iy = 0 on the pad
    pixels, their backward rows dropped) against the plain versions on the
    unpadded pixels, forward and backward, then timed (kernel launches at
    the padded shape, CUDA events; plain, kernel, kernel, plain). The
    4,096-pixel launches are untouched (no pad). Returns the errors and
    times."""
    from palette_and_histo_gan_tpu_torch.ops import histogram_kernel as hk

    b, hw = shape
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    padded = hw + (-hw % hk.PIXEL_TILE)
    fwd_pixels = hk.forward_block_pixels(b, padded, sms)
    log("histpad", f"B={b} HW={hw} padded to {padded}: a float32 forward block owns {fwd_pixels} "
        f"pixels ({-(-padded // fwd_pixels)} parts, the last {padded - (-(-padded // fwd_pixels) - 1) * fwd_pixels}); "
        f"a backward block owns {hk.backward_block_pixels(b, padded, sms, torch.float32)}")
    rng = np.random.default_rng(SEED)
    flat01 = torch.from_numpy(rng.integers(0, 256, (b, hw, 3), dtype=np.uint8)).to(device).float() / 255.0
    g = torch.from_numpy(rng.standard_normal((b, 3, 64, 64), dtype=np.float32) * 1e-3).to(device)
    kw = dict(size=64, method="inverse-quadratic", sigma=0.02, chain=torch.float32)
    before = dict(hk.launches)
    x = flat01.clone().requires_grad_(True)
    got = hk.FusedHistogram.apply(x, 64, "inverse-quadratic", 0.02, torch.float32, ("K3b", "K4b"))
    got.backward(g)
    torch.cuda.synchronize()
    launched = {k: hk.launches[k] - before[k] for k in ("K3b", "K4b")}
    if launched != {"K3b": 1, "K4b": 1}:
        raise AssertionError(f"the padded histogram launched {launched}, not K3b and K4b once each")
    logs, iy = hk.logs_and_intensity(flat01)
    ref = hk.histogram_forward_plain(logs, iy, **kw)
    rows = hk.histogram_backward_plain(logs, iy, g, **kw)
    ref_grad = hk.finish(rows, flat01, iy)
    torch.cuda.synchronize()
    out = {}
    for name, a, r, tol in (("K3b", got, ref, HIST_TOL[("fwd", "float32")]),
                            ("K4b", x.grad, ref_grad, HIST_TOL[("bwd", "float32")])):
        err = float((a - r).abs().max())
        rel = err / float(r.abs().max())
        log("histpad", f"{name} B={b} HW={hw} float32, padded: max|kernel - plain| {err:.3e}, "
            f"{rel:.3e} of max|plain| (tol {tol:g})")
        if not (math.isfinite(rel) and rel <= tol):
            raise AssertionError(f"{name} at {hw} pixels disagrees with its plain version")
        out[name] = {"max_abs_err": err, "rel": rel}
    plogs, piy = hk.pad_pixels(logs, iy)
    calls = {
        "K3b": (lambda: hk.histogram_forward_cuda(plogs, piy, kernel="K3b", **kw),
                lambda: hk.histogram_forward_plain(logs, iy, **kw)),
        "K4b": (lambda: hk.histogram_backward_cuda(plogs, piy, g, kernel="K4b", **kw),
                lambda: hk.histogram_backward_plain(logs, iy, g, **kw)),
    }
    for name, (kernel, plain) in calls.items():
        plain_ms = [cuda_ms(plain, 2)]
        kernel_ms = [cuda_ms(kernel, iters), cuda_ms(kernel, iters)]
        plain_ms.append(cuda_ms(plain, 2))
        direction = "fwd" if name == "K3b" else "bwd"
        # the kernels table's basis: the products on the kernel's units, the
        # elementwise chain at float32's, the bytes (histogram_bound)
        bound_ms, by = histogram_bound(hk.work(direction, b, hw, chain=torch.float32))
        out[name].update(kernel_ms=sum(kernel_ms) / 2, plain_ms=sum(plain_ms) / 2,
                         bound_ms=bound_ms, bound_by=by)
        log("histpad", f"{name} B={b} HW={hw} float32: kernel {kernel_ms[0]:.4f}, {kernel_ms[1]:.4f} ms, "
            f"plain {plain_ms[0]:.3f}, {plain_ms[1]:.3f} ms; bound {bound_ms:.4f} ms ({by}), "
            f"{100 * bound_ms / out[name]['kernel_ms']:.1f}% of it")
    return out


def phase_histogram_times(device) -> dict:
    """Kernel and plain version in each regime's chain, at its batch:
    plain, kernel, kernel, plain. Returns per (kernel, batch) the mean
    kernel and plain milliseconds."""
    from palette_and_histo_gan_tpu_torch.ops import histogram_kernel as hk

    times = {}
    for b, compute, iters, plain_iters in ((1024, "bfloat16", 20, 3), (4, "float32", 200, 20)):
        logs, iy, g = histogram_inputs(b, device, SEED)
        for name, (_, chains) in HIST_KERNELS.items():
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


# K6 against its plain version, per output, as a fraction of its largest
# |plain value| (HIST_TOL's float32 forward): both upcast to float32 and
# square there; the plain version sums each row in float64 and rounds once,
# the kernel sums in float32 in its own fixed order
MOMENTS_RTOL = 1e-5
# the A/B row whose K6 time the kernels line gives: the largest decoder
# shape, as the networks' contiguous tensors hold it
MOMENTS_ENTRY_ROW = ((1024, 32, 64, 64), "nchw")
MOMENTS_STEP_BATCH = 1024  # the throughput regime's batch


def moments_cases(device, gen_shapes):
    """(what, tensor) of each K6 check: the A/B's bfloat16 shapes in both
    layouts, float32 B=4 at the generator's InstanceNorm shapes and B=5
    (no multiple of 8) in both dtypes, in both layouts, seeded."""
    from palette_and_histo_gan_tpu_torch import bench_in_stats as ab

    shapes = [(shape, "bfloat16") for shape in ab.SHAPES]
    shapes += [((4, *shape[1:]), "float32") for shape in gen_shapes]
    shapes += [((5, *shape[1:]), dtype) for shape in ab.SHAPES for dtype in ("bfloat16", "float32")]
    gen = torch.Generator(device=device).manual_seed(SEED)
    for shape, dtype in shapes:
        x = torch.randn(shape, generator=gen, device=device).to(getattr(torch, dtype))
        for layout, fmt in (("nchw", torch.contiguous_format), ("nhwc", torch.channels_last)):
            yield f"{dtype} {shape} {layout}", x.contiguous(memory_format=fmt)


def phase_in_stats(device) -> dict:
    """K6 against its plain version on every case of moments_cases (its
    outputs' memory filled with NaN first, so a row the kernel skips shows;
    two launches bit-equal); the launches counted and equal to the calls
    made. Then the A/B of the InstanceNorm statistics
    (bench_in_stats.py), its launches counted around it: the main path of
    K6. Then K6 and its plain version timed at MOMENTS_ENTRY_ROW, and form A
    (the networks' statistics) and K6 at b1024 bfloat16 at each of the
    generator's InstanceNorm inputs, in the layout the card's networks
    hold them."""
    from palette_and_histo_gan_tpu_torch import bench_in_stats as ab
    from palette_and_histo_gan_tpu_torch.ops import moments as mo

    inputs = ab.instance_norm_inputs(2, torch.bfloat16, device)
    log("in_stats", "the bfloat16 generator's InstanceNorm inputs on the card: "
        + ", ".join(f"{shape[1:]} {layout}" for shape, layout in inputs))
    mo.reset_launches()
    calls, worst = 0, 0.0
    for what, x in moments_cases(device, [shape for shape, _ in inputs]):
        b, c = x.shape[:2]
        # NaN in the blocks the kernel's two (b, c) outputs will reuse once freed
        poison = [torch.full((b, c), float("nan"), device=device) for _ in range(2)]
        del poison
        got, again = mo.moments_cuda(x), mo.moments_cuda(x)
        calls += 2
        want = mo.moments_plain(x)
        torch.cuda.synchronize()
        for name, g, a, w in zip(("mean", "mean2"), got, again, want):
            err = float((g - w).abs().max())
            if not (g.shape == (b, c) and g.dtype == torch.float32 and bool(torch.isfinite(g).all())
                    and err <= MOMENTS_RTOL * float(w.abs().max())):
                raise AssertionError(f"K6 {what} {name}: max abs err {err:.3e} against "
                                     f"{MOMENTS_RTOL} x {float(w.abs().max()):.4f}")
            if not torch.equal(g, a):
                raise AssertionError(f"K6 {what} {name}: two launches differ")
            worst = max(worst, err)
    if mo.launches["K6"] != calls:
        raise AssertionError(f"K6 launched {mo.launches['K6']} times for {calls} calls")
    log("in_stats", f"K6 == plain within {MOMENTS_RTOL} of the largest value on {calls // 2} "
        f"cases (worst abs err {worst:.3e}), two launches bit-equal, every row written")

    mo.reset_launches()
    rows = [ab.ab_row(shape, layout, device) for shape in ab.SHAPES for layout in ab.LAYOUTS]
    launches = mo.launches["K6"]
    if launches != sum(r["C_calls"] for r in rows) or launches == 0:
        raise AssertionError(f"the A/B launched K6 {launches} times for "
                             f"{sum(r['C_calls'] for r in rows)} calls of its form C")
    for r in rows:
        log("in_stats", f"A/B {tuple(r['shape'])} {r['layout']}: floor {r['floor_ms']:.4f} ms; "
            f"marginal A {r['A_ms']:.4f} / B {r['B_ms']:.4f} / K6 {r['C_ms']:.4f} ms; events "
            f"A {r['A_event_ms']:.4f} / B {r['B_event_ms']:.4f} / K6 {r['C_event_ms']:.4f} ms "
            f"({100 * r['floor_ms'] / r['C_event_ms']:.1f}% of the floor); device A "
            f"{r['A_device_ms']:.4f} / B {r['B_device_ms']:.4f} / K6 {r['C_device_ms']:.4f} ms "
            f"({100 * r['floor_ms'] / r['C_device_ms']:.1f}%); A vs K6 {r['A_vs_C']:.2e} "
            f"(mean2), B vs K6 {r['B_vs_C']:.2e}; B output {r['B_output']}; pool {r['pool']}")

    shape, layout = MOMENTS_ENTRY_ROW
    pool = ab.make_pool(shape, layout, device)
    p1 = ab.event_ms(mo.moments_plain, pool, 10)
    k1, k2 = ab.event_ms(mo.moments_cuda, pool), ab.event_ms(mo.moments_cuda, pool)
    p2 = ab.event_ms(mo.moments_plain, pool, 10)
    row = next(r for r in rows if tuple(r["shape"]) == shape and r["layout"] == layout)
    # the bytes (input read once, two float32 outputs written once) and an
    # add and a multiply-add an element in float32
    times = ((k1 + k2) / 2, (p1 + p2) / 2,
             *bound(row["bytes"], (3 * math.prod(shape), "float32")))
    log("in_stats", f"K6 {shape} {layout}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms")
    del pool
    # the small row, the A/B's (1024, 256, 8, 8) NCHW: K6's device time there
    # (the A/B's; by CUDA events the wrapper's host time hides the kernel)
    # beside its plain version's device time on the same pool
    small = next(r for r in rows if tuple(r["shape"]) == ab.SHAPES[0] and r["layout"] == "nchw")
    pool = ab.make_pool(ab.SHAPES[0], "nchw", device)
    small_device = {"shape": list(ab.SHAPES[0]), "layout": "nchw", "ms": small["C_device_ms"],
                    "plain_ms": ab.device_ms(mo.moments_plain, pool, 10)}
    log("in_stats", f"K6 {ab.SHAPES[0]} nchw by device time: kernel {small_device['ms']:.4f} ms, "
        f"plain {small_device['plain_ms']:.4f} ms")
    del pool

    # the networks' statistics (form A) and K6 at b1024 at each InstanceNorm
    # input of the generator, in the card's layout: what K6 under
    # InstanceNorm could save a step at most
    step = []
    for (_, *chw), layout in inputs:
        shape = (MOMENTS_STEP_BATCH, *chw)
        pool = ab.make_pool(shape, "nhwc" if layout == "nhwc" else "nchw", device)
        step.append({"shape": list(shape), "layout": layout,
                     "A_ms": ab.event_ms(ab.stats_torch, pool), "K6_ms": ab.event_ms(mo.moments_cuda, pool),
                     "A_device_ms": ab.device_ms(ab.stats_torch, pool),
                     "K6_device_ms": ab.device_ms(mo.moments_cuda, pool)})
        del pool
    total = {key: sum(r[key] for r in step) for key in ("A_ms", "K6_ms", "A_device_ms", "K6_device_ms")}
    log("in_stats", f"b{MOMENTS_STEP_BATCH} bf16 step: {len(step)} InstanceNorm statistics; form A "
        f"{total['A_ms']:.4f} ms (events) / {total['A_device_ms']:.4f} ms (device), K6 {total['K6_ms']:.4f} / "
        f"{total['K6_device_ms']:.4f} ms in all: K6 under InstanceNorm saves at most "
        f"{total['A_device_ms'] - total['K6_device_ms']:.4f} ms of device time a step")
    torch.cuda.empty_cache()
    return {"worst": worst, "launches": launches, "rows": rows, "step": step,
            "times": times, "small_device_ms": small_device,
            "ab_ms": {"A": row["A_event_ms"], "B": row["B_event_ms"]}}


# the indexed losses' kernel pair against its plain version: each loss
# relative to its plain value, the gradient as a fraction of the plain
# gradient's largest |entry|. float32: the same float32 arithmetic a row
# (lse, z_t, the clip, p_t), the means summed in double (plain: float32 in
# PyTorch's order), the gradient as k (p_j - d_jt) (plain: two autograd
# terms added). bfloat16 logits: against the plain version on their float32
# upcast (the same values; the plain bfloat16 gradient rounds each autograd
# term to bfloat16 and adds them there); the kernel rounds its gradient once,
# within half a bfloat16 ulp of each entry, checked at 2^-8 of the largest
CCE_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-5, 2.0**-8)}
CCE_BATCHES = (1024, 4)
# (g_seg, g_l1): the step's upstream gradients (lambda_segmentation 0.01,
# lambda_l1 0) and a nonzero L1 gradient, which the step never sends
CCE_GRADS = ((0.01, 0.0), (0.5, -1.75))


def cce_inputs(b: int, dtype, device, seed: int):
    """Labels and logits of a b1024-like batch: the logits (B, 64, 64, 256),
    the generator's view of NCHW memory (the card's head output), N(0, 3) with one row in 61 whose label's logit
    sits 40 above the rest (p_t past 1 - 1e-7: the clip's lower bound binds)
    and one in 67 whose sits 40 below (past its upper bound); one label in
    97 past 255 and one in 101 negative."""
    gen = torch.Generator(device=device).manual_seed(seed)
    logits = torch.randn((b, 256, 64, 64), generator=gen, device=device) * 3.0
    logits = logits.to(dtype).permute(0, 2, 3, 1)
    labels = torch.randint(0, 256, (b, 64, 64), generator=gen, device=device, dtype=torch.int32)
    flat = labels.view(-1)
    n = flat.numel()
    image, pixel = (lambda r: r // 4096, lambda r: r % 4096)
    for step, shift in ((61, 40.0), (67, -40.0)):
        r = torch.arange(0, n, step, device=device)
        rows = logits[image(r), pixel(r) // 64, pixel(r) % 64]
        logits[image(r), pixel(r) // 64, pixel(r) % 64, flat[r].long()] = (
            rows.float().max(-1).values + shift).to(dtype)
    flat[torch.arange(0, n, 97, device=device)] = 256 + (n % 97)
    flat[torch.arange(50, n, 101, device=device)] = -1
    return labels, logits


def cce_plain(labels, logits, g_seg, g_l1):
    """The plain version's (seg, l1) and the gradient of g_seg seg + g_l1 l1."""
    from palette_and_histo_gan_tpu_torch.ops import indexed_loss as il

    x = logits.detach().requires_grad_(True)
    seg, l1 = il.indexed_losses_plain(labels, x)
    (grad,) = torch.autograd.grad(g_seg * seg + g_l1 * l1, x)
    return seg.detach(), l1.detach(), grad


def phase_indexed_loss(device) -> dict:
    """The indexed losses' kernel pair (CCE-fwd, CCE-bwd) against its plain
    version at B = 1024 and 4, float32 and bfloat16, in the generator's view
    of NCHW memory, under the step's upstream gradients and a nonzero L1 one
    (CCE_TOL); two launches of each bit-equal; a row at each clip bound
    passing its gradient and one a float32 step outside cut; launches equal
    to calls; the full-width generator's logits on the card taken as they
    are, channels-last logits refused. Times both kernels and the plain
    forward and backward at each shape."""
    from palette_and_histo_gan_tpu_torch import config_for_variant
    from palette_and_histo_gan_tpu_torch.kernels import build
    from palette_and_histo_gan_tpu_torch.ops import indexed_loss as il
    from palette_and_histo_gan_tpu_torch.train import create_train_state

    for line in build.build_reports.get("phg_indexed_loss", "").splitlines():
        if "Compiling entry function" in line or "registers" in line or "spill" in line:
            log("indexed_loss", "ptxas: " + line.strip())
    il.reset_launches()
    fwd_calls = bwd_calls = 0
    worst, times = {}, {}
    for b in CCE_BATCHES:
        for dtype in (torch.float32, torch.bfloat16):
            labels, logits = cce_inputs(b, dtype, device, SEED + b)
            what = f"B={b} {str(dtype)[6:]}"
            seg, l1, stats = il.forward_cuda(labels, logits)
            seg2, l12, stats2 = il.forward_cuda(labels, logits)
            fwd_calls += 2
            if not (torch.equal(seg, seg2) and torch.equal(l1, l12) and torch.equal(stats, stats2)):
                raise AssertionError(f"CCE-fwd {what}: two launches differ")
            value_tol, grad_tol = CCE_TOL[dtype]
            upcast = logits.float()
            for g_seg, g_l1 in CCE_GRADS:
                gs = torch.tensor(g_seg, device=device)
                gl = torch.tensor(g_l1, device=device)
                grad = il.backward_cuda(labels, logits, stats, gs, gl)
                again = il.backward_cuda(labels, logits, stats, gs, gl)
                bwd_calls += 2
                if not torch.equal(grad, again):
                    raise AssertionError(f"CCE-bwd {what}: two launches differ")
                if grad.dtype != dtype or grad.stride() != logits.stride():
                    raise AssertionError(f"CCE-bwd {what}: gradient {grad.dtype} {grad.stride()}")
                pseg, pl1, pgrad = cce_plain(labels, upcast, g_seg, g_l1)
                errs = {"seg": abs(float(seg) - float(pseg)) / abs(float(pseg)),
                        "l1": abs(float(l1) - float(pl1)) / abs(float(pl1)),
                        "grad": float((grad.float() - pgrad).abs().max()) / float(pgrad.abs().max())}
                del pgrad, grad, again
                log("indexed_loss", f"{what} g=({g_seg}, {g_l1}): seg {float(seg):.7f} (plain "
                    f"{float(pseg):.7f}), l1 {float(l1):.7f} (plain {float(pl1):.7f}); relative "
                    "errors " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
                if not (errs["seg"] <= value_tol and errs["l1"] <= value_tol
                        and errs["grad"] <= grad_tol):
                    raise AssertionError(f"CCE {what} g=({g_seg}, {g_l1}): {errs} against "
                                         f"{value_tol} / {grad_tol}")
                for k, v in errs.items():
                    worst[k] = max(worst.get(k, 0.0), v)
            del upcast
            if b == CCE_BATCHES[0] and dtype == torch.float32:
                bwd_calls += cce_bound_rows(labels, logits, stats)
            times.update(cce_times(labels, logits, what))
            del labels, logits, stats, stats2
            torch.cuda.empty_cache()
    if il.launches != {"CCE-fwd": fwd_calls, "CCE-bwd": bwd_calls}:
        raise AssertionError(f"launches {il.launches} for {fwd_calls} / {bwd_calls} calls")
    log("indexed_loss", f"kernels == plain within {CCE_TOL[torch.float32]} (float32) and "
        f"{CCE_TOL[torch.bfloat16]} (bfloat16) of (each loss, the largest gradient entry); "
        f"worst {worst}; relaunches bit-equal; launches == calls ({il.launches})")

    # the full-width generator's logits on the card, as the step hands them over
    for dtype in ("float32", "bfloat16"):
        config = config_for_variant("indexed", compute_dtype=dtype)
        state = create_train_state(config, device, SEED)
        with torch.no_grad():
            source = torch.randint(0, 256, (4, 64, 64, 1), device=device).float()
            logits = state.generator(source, deterministic=True, logits=True)
        labels = source[..., 0].int()
        shape = il.check(labels, logits)
        log("indexed_loss", f"the {dtype} generator's logits {tuple(logits.shape)} strides "
            f"{logits.stride()}: the kernels take them as (images, pixels, image stride, class "
            f"stride) {shape}")
        channels_last = logits.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last).permute(0, 2, 3, 1)
        try:
            il.forward_cuda(labels, channels_last)
        except ValueError as refusal:
            log("indexed_loss", f"channels-last logits (strides {channels_last.stride()}) refused: "
                f"{refusal}")
        else:
            raise AssertionError(f"channels-last logits {channels_last.stride()} were taken")
        del state, logits, channels_last
    torch.cuda.empty_cache()
    return {"worst": worst, "times": times, "launches": dict(il.launches)}


def cce_bound_rows(labels, logits, stats) -> int:
    """A row whose lse - z_t, as the kernel computes it, sits on the lower,
    then the upper clip bound (the bound moved onto it) passes its gradient;
    a float32 step outside cuts it. Returns the backward launches made."""
    from palette_and_histo_gan_tpu_torch.ops import indexed_loss as il
    from palette_and_histo_gan_tpu_torch.train import losses

    row, calls = 3, 0
    d = (stats[row, 0] - stats[row, 1]).cpu().numpy()
    one, zero = torch.tensor(1.0, device=logits.device), torch.tensor(0.0, device=logits.device)
    saved = losses.NEG_LOG_MIN, losses.NEG_LOG_MAX
    try:
        for name, away in (("NEG_LOG_MIN", np.inf), ("NEG_LOG_MAX", -np.inf)):
            found = []
            for at in (d, np.nextafter(d, np.float32(away))):
                setattr(losses, name, float(at))
                grad = il.backward_cuda(labels, logits, stats, one, zero)
                calls += 1
                found.append(float(grad[0, 0, row].abs().max()))
                del grad
            if not (found[0] > 0.0 and found[1] == 0.0):
                raise AssertionError(f"{name} moved onto row {row}'s lse - z_t = "
                                     f"{float(d)!r}: its gradient's largest |entry| {found[0]} at "
                                     f"the bound, {found[1]} a step outside")
            log("indexed_loss", f"{name} at row {row}'s lse - z_t ({float(d)!r}): "
                f"gradient passed ({found[0]:.3e}); a float32 step outside: cut")
            losses.NEG_LOG_MIN, losses.NEG_LOG_MAX = saved
    finally:
        losses.NEG_LOG_MIN, losses.NEG_LOG_MAX = saved
    return calls


def cce_times(labels, logits, what: str) -> dict:
    """Device ms (CUDA events) of CCE-fwd, CCE-bwd and the plain version's
    forward + backward under the step's upstream gradients, each beside the
    kernels' bytes bound: the logits read once forward, read once and their
    gradient written once backward, the int32 labels read once a pass (the
    benchmark's indexed_loss_roofline counts the same bytes)."""
    from palette_and_histo_gan_tpu_torch.ops import indexed_loss as il

    counted = dict(il.launches)
    g_seg, g_l1 = (torch.tensor(g, device=logits.device) for g in CCE_GRADS[0])
    _, _, stats = il.forward_cuda(labels, logits)
    iters = 20 if labels.shape[0] >= 1024 else 200
    fwd = cuda_ms(lambda: il.forward_cuda(labels, logits), iters)
    bwd = cuda_ms(lambda: il.backward_cuda(labels, logits, stats, g_seg, g_l1), iters)
    plain = cuda_ms(lambda: cce_plain(labels, logits, *CCE_GRADS[0]), max(iters // 4, 5))
    fwd2 = cuda_ms(lambda: il.forward_cuda(labels, logits), iters)
    bwd2 = cuda_ms(lambda: il.backward_cuda(labels, logits, stats, g_seg, g_l1), iters)
    rows, item = labels.numel(), logits.element_size()
    fwd_bound = bound(rows * 256 * item + rows * 4, (rows * 256, "float32"))
    bwd_bound = bound(2 * rows * 256 * item + rows * 4, (2 * rows * 256, "float32"))
    pair = (fwd + fwd2 + bwd + bwd2) / 2
    log("indexed_loss", f"time {what}: CCE-fwd {fwd:.4f} / {fwd2:.4f} ms (bound {fwd_bound[0]:.4f}, "
        f"{fwd_bound[1]}), CCE-bwd {bwd:.4f} / {bwd2:.4f} ms (bound {bwd_bound[0]:.4f}, "
        f"{bwd_bound[1]}); pair {pair:.4f} ms, {100 * (fwd_bound[0] + bwd_bound[0]) / pair:.1f}% of "
        f"its bound; plain forward + backward {plain:.4f} ms")
    # the launches of the timing (and of cuda_ms's warm-ups) are not the checks'
    il.launches.update(counted)
    return {what: {"fwd_ms": (fwd + fwd2) / 2, "bwd_ms": (bwd + bwd2) / 2, "plain_ms": plain,
                   "fwd_bound_ms": fwd_bound[0], "bwd_bound_ms": bwd_bound[0]}}


DECODER_TOL = 1e-4  # relative to the largest |NCHW output|: float32, TF32 off, other sums


def nchw_up_block(block, x, drop):
    """UpBlock.forward as the decoder ran it before it was laid out NHWC:
    the transposed convolution on contiguous NCHW input, the norm, a
    contiguous dropout mask, ReLU."""
    import torch.nn.functional as F

    from palette_and_histo_gan_tpu_torch.models.networks import DROPOUT_RATE

    x = block.norm(F.conv_transpose2d(x, block.weight, stride=2, padding=1))
    if block.apply_dropout:
        keep = drop.keep_mask(x.shape, x.device)
        x = torch.where(keep, x / (1.0 - DROPOUT_RATE), torch.zeros_like(x))
    return F.relu(x)


def up_block_run(block, forward, x, iters: int) -> dict:
    """forward(x, dropout draw) and its backward to x and the block's
    parameters, as the step runs them (gradients set to None before each
    call, a fixed cotangent laid out like the output), with a seeded draw:
    mean forward and backward ms by CUDA events over `iters` calls after a
    warm-up, the device kernels of one call by torch.profiler, and the last
    output."""
    from palette_and_histo_gan_tpu_torch.models.networks import DropoutDraw
    from palette_and_histo_gan_tpu_torch.utils.profiling import device_events, device_us

    x = x.detach().requires_grad_(True)
    inputs = [x, *block.parameters()]
    cotangent = []

    def call(events=()):
        for t in inputs:
            t.grad = None
        drop = DropoutDraw(torch.Generator(device=x.device).manual_seed(SEED))
        if events:
            events[0].record()
        out = forward(x, drop)
        if events:
            events[1].record()
        if not cotangent:
            gen = torch.Generator(device=x.device).manual_seed(SEED + 1)
            drawn = torch.randn(out.shape, generator=gen, device=x.device)
            cotangent.append(torch.empty_like(out).copy_(drawn))
        out.backward(cotangent[0], inputs=inputs)
        if events:
            events[2].record()
        return out

    for _ in range(3):
        call()
    timed = [[torch.cuda.Event(enable_timing=True) for _ in range(3)] for _ in range(iters)]
    for events in timed:
        out = call(events)
    torch.cuda.synchronize()
    fwd = sum(e[0].elapsed_time(e[1]) for e in timed) / iters
    bwd = sum(e[1].elapsed_time(e[2]) for e in timed) / iters
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        call()
        torch.cuda.synchronize()
    kernels = sorted(((device_us(e), e.key) for e in device_events(prof)), reverse=True)
    return {"fwd_ms": fwd, "bwd_ms": bwd, "kernels": kernels, "out": out.detach()}


def phase_decoder_layouts(device, batch: int = 1024, iters: int = 10) -> list:
    """The generator's six UpBlocks at full width, float32 (TF32 off),
    dropout where the block has it, each fed as its decoder feeds it:
    "parent", the NCHW formulation (nchw_up_block: cuDNN's transposed
    convolution) on contiguous input; "port", the port's UpBlock (NHWC, a
    forward convolution) on the NHWC-strided input the skip concatenation
    hands it (the 1x1 bottleneck keeps its NCHW strides, which the block
    re-lays). Per block: forward and backward ms (CUDA events; parent,
    port, port, parent), the transposed convolution's TFLOP/s at its
    counted products, the device kernels of one forward and backward, and
    the two outputs within DECODER_TOL of each other."""
    from palette_and_histo_gan_tpu_torch.config import config_for_variant
    from palette_and_histo_gan_tpu_torch.models import networks as tnet

    generator = tnet.build_generator(config_for_variant("histogram"), torch.float32)
    tnet.init_parameters(generator, torch.Generator().manual_seed(SEED))
    rows = []
    for i, block in enumerate(generator.up):
        block.to(device)
        cin, cout = block.weight.shape[:2]
        side = 2 ** i
        x = torch.randn((batch, cin, side, side), generator=torch.Generator(device=device).manual_seed(SEED + i),
                        device=device)
        nhwc = x if side == 1 else x.contiguous(memory_format=torch.channels_last)
        runs = {"parent": [], "port": []}
        for layout in ("parent", "port", "port", "parent"):
            if layout == "parent":
                runs[layout].append(up_block_run(block, lambda v, d: nchw_up_block(block, v, d), x, iters))
            else:
                runs[layout].append(up_block_run(block, block, nhwc, iters))
        want, got = runs["parent"][0]["out"], runs["port"][0]["out"]
        rel = float((got - want).abs().max()) / float(want.abs().max())
        flop = 2 * batch * side * side * cin * cout * 16
        row = {"block": i, "input": [batch, cin, side, side], "gflop_fwd": flop / 1e9, "rel_err": rel}
        for layout, pair in runs.items():
            fwd = sum(r["fwd_ms"] for r in pair) / 2
            bwd = sum(r["bwd_ms"] for r in pair) / 2
            row[layout] = {"fwd_ms": [r["fwd_ms"] for r in pair], "bwd_ms": [r["bwd_ms"] for r in pair],
                           "fwd_tflops": flop / fwd / 1e9,
                           "kernels": [[name, round(us, 1)] for us, name in pair[0]["kernels"]]}
            log("decoder", f"up{i} {tuple(row['input'])} {layout}: fwd {fwd:.3f} ms "
                f"({flop / fwd / 1e9:.1f} TFLOP/s), bwd {bwd:.3f} ms")
            for us, name in pair[0]["kernels"][:6]:
                log("decoder", f"    {us:9.1f} us  {name[:110]}")
        log("decoder", f"up{i}: max|port - parent| {rel:.2e} of max|parent| (tol {DECODER_TOL:g})")
        if not (math.isfinite(rel) and rel <= DECODER_TOL):
            raise AssertionError(f"up{i}: the port's block disagrees with the NCHW formulation")
        rows.append(row)
        del x, nhwc, runs, want, got
        block.to("cpu")
        torch.cuda.empty_cache()
    return rows


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
    """The indexed dataset build on the card (K5) and the Trainer's fit, one
    CCE-fwd and one CCE-bwd a step; returns the launch counts of that run."""
    from palette_and_histo_gan_tpu_torch import config_for_variant
    from palette_and_histo_gan_tpu_torch.data import loader
    from palette_and_histo_gan_tpu_torch.ops import (augment_kernel, histogram_kernel, indexed_loss,
                                                     palette_kernel)
    from palette_and_histo_gan_tpu_torch.train.trainer import Trainer

    config = config_for_variant("indexed", batch_size=4, temp_folder=TEMP_FOLDER)
    arrays = loader.synthetic_indexed_arrays(config, SEED)
    for counter in (augment_kernel, histogram_kernel, palette_kernel, indexed_loss):
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
    launches = {**palette_kernel.launches, **indexed_loss.launches}

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
    cce = {key: launches[key] for key in indexed_loss.launches}
    if device.type == "cuda" and cce != {"CCE-fwd": steps, "CCE-bwd": steps}:
        raise AssertionError(f"the indexed main path launched {cce} in {steps} steps; needed one "
                             "of each a step")
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
    from palette_and_histo_gan_tpu_torch.ref_regime import write_dataset_root

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
# removes, and writes them to $PHG_AUDIT_DIR/rank<RANK>.json at exit, with
# the kernels' launches in the rank where the port's sweep module (which
# counts them) was loaded
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
        sweep = sys.modules.get("palette_and_histo_gan_tpu_torch.sweep")
        launches = sweep.read_launches() if sweep is not None else None
        with open(os.path.join(os.environ["PHG_AUDIT_DIR"], f"rank{_rank}.json"), "w") as f:
            json.dump({"writes": _writes, "launches": launches}, f)

    if _rank is not None:
        sys.addaudithook(_audit)
        atexit.register(_report)
    """
)


def torchrun_audited(name: str, world: int, argv: list) -> dict:
    """`torchrun --standalone --nproc-per-node=<world> <argv>` in a fresh
    working directory under TEMP_FOLDER/<name>, with per-rank logs and the
    audit hook in each rank; fails unless it exits 0. Returns the working
    directory, the seconds, and by rank what it printed, the paths it wrote
    and its launches (None where the port's sweep module was not loaded)."""
    import glob

    torchrun = shutil.which("torchrun") or os.path.join(os.path.dirname(sys.executable), "torchrun")
    if not os.path.isfile(torchrun):
        raise AssertionError("torchrun is not on PATH nor beside the interpreter")
    base = os.path.abspath(os.path.join(TEMP_FOLDER, name))
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
         "--redirects", "1", *argv], cwd=run, env=env, capture_output=True, text=True, timeout=600,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{name}: torchrun exited {proc.returncode}: {proc.stderr[-3000:]}")
    stdout = {}
    for path in glob.glob(os.path.join(logs, "**", "stdout.log"), recursive=True):
        with open(path) as f:
            stdout[int(os.path.basename(os.path.dirname(path)))] = f.read()
    if sorted(stdout) != list(range(world)):
        raise AssertionError(f"{name}: torchrun logged ranks {sorted(stdout)}, expected {world}")
    writes, launches = {}, {}
    for rank in range(world):
        with open(os.path.join(audit, f"rank{rank}.json")) as f:
            report = json.load(f)
        writes[rank], launches[rank] = report["writes"], report["launches"]
    loud = {r: stdout[r][-500:] for r in range(1, world) if stdout[r]}
    wrote = {r: writes[r][:5] for r in range(1, world) if writes[r]}
    if loud or wrote:
        raise AssertionError(f"{name}: ranks above 0 printed {loud} or wrote {wrote}")
    return {"run": run, "seconds": seconds, "stdout": stdout, "writes": writes,
            "launches": launches}


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
    ran = torchrun_audited("torchrun", world, [
        "-m", "palette_and_histo_gan_tpu_torch.cli", "--device", device.type, "--model",
        "histogram", "--synthetic", "--data-parallel", "on", "--batch-size", "8", "--steps", "4",
        "--update-steps", "2"])
    writes = ran["writes"]
    start = [line for line in ran["stdout"][0].splitlines() if line.startswith("Starting training")]
    log("torchrun", f"{world} rank(s) over {backend}: exit 0 in {ran['seconds']:.1f} s; rank 0: "
        f"{start}; rank 0 wrote {len(writes[0])} paths; ranks above 0 printed nothing and wrote "
        "nothing")
    if len(start) != 1 or f"data parallel, {backend} x {world} ranks" not in start[0]:
        raise AssertionError(f"rank 0 did not print the start-up line over {backend}: {start}")
    if not any("training-checkpoints" in p for _, p in writes[0]):
        raise AssertionError("rank 0 wrote no checkpoint (or the audit hook saw no write)")
    return {"world": world, "seconds": ran["seconds"]}


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


# ------------------------------------------------------ measurement tools

SWEEP_STEPS = 10
# (dtype, batch) of the sweep's rows: the reference regime and throughput
SWEEP_REGIMES = (("float32", 4), ("bfloat16", 1024))
SWEEP_VARIANTS = ("baseline-no-aug", "baseline", "indexed", "histogram")
# K1, K3b and K4b a step on the sweep's rows ("pallas2", the CLI's default
# on a card); the others none
SWEEP_LAUNCHES_A_STEP = {"baseline-no-aug": {}, "baseline": {"K1": 1.0}, "indexed": {},
                         "histogram": {"K1": 1.0, "K3b": 2.0, "K4b": 1.0}}
SWEEP_VS_TIMED = 0.05  # the sweep's device ms/step against phase_timed_chunk's
# the sweep in a process of its own (under torchrun), one sweep.main call a
# JSON argv of argv[1], its kernels' launches printed after it
SWEEP_WITH_LAUNCHES = textwrap.dedent(
    """
    import json, sys
    from palette_and_histo_gan_tpu_torch import sweep
    from palette_and_histo_gan_tpu_torch.ops import augment_kernel, histogram_kernel
    for argv in json.loads(sys.argv[1]):
        code = sweep.main(argv)
    print(json.dumps({**augment_kernel.launches, **histogram_kernel.launches}))
    sys.exit(code)
    """
)


def sweep_rows(stdout: str) -> list[dict]:
    return [json.loads(line) for line in stdout.splitlines()
            if line.startswith("{") and '"variant"' in line]


def check_sweep_row(row: dict, what: str) -> None:
    """Error-free, finite, on the device clock, with its variant's launches."""
    if "error" in row:
        raise AssertionError(f"sweep {what}: an error row {row}")
    numbers = [row[k] for k in ("step_seconds", "device_step_seconds", "host_step_seconds",
                                "images_per_sec", "mfu")]
    if row["clock"] != "device" or not all(math.isfinite(v) and v > 0 for v in numbers):
        raise AssertionError(f"sweep {what}: not a finite device-clock row {row}")
    need = SWEEP_LAUNCHES_A_STEP[row["variant"]]
    if row["launches_per_step"] != need:
        raise AssertionError(f"sweep {what}: launches a step {row['launches_per_step']}, "
                             f"needed {need}")


def run_sweep(device, world: int, argvs: list, out_dir: str) -> tuple[list, dict, float]:
    """SWEEP_WITH_LAUNCHES under `torchrun --nproc-per-node=world`: (rank
    0's rows, its launches, seconds)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(out_dir, exist_ok=True)
    program = os.path.join(out_dir, "sweep_rows.py")
    with open(program, "w") as f:
        f.write(SWEEP_WITH_LAUNCHES)
    torchrun = shutil.which("torchrun") or os.path.join(os.path.dirname(sys.executable), "torchrun")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [torchrun, "--standalone", f"--nproc-per-node={world}", program, json.dumps(argvs)],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo), capture_output=True, text=True,
        timeout=900,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the sweep (torchrun x {world}) exited {proc.returncode}: "
                             f"{proc.stdout[-1500:]} {proc.stderr[-3000:]}")
    launches = json.loads(proc.stdout.strip().splitlines()[-1])
    return sweep_rows(proc.stdout), launches, seconds


def log_sweep_row(row: dict, what: str) -> None:
    log("sweep", f"{what}: {1e3 * row['step_seconds']:.3f} device ms/step, "
        f"{1e3 * row['host_step_seconds']:.3f} host, {row['images_per_sec']:.1f} img/s "
        f"({row['images_per_sec_per_chip']:.1f} a card), MFU {100 * row['mfu']:.2f}%, peak "
        f"{row['peak_device_memory_bytes'] / 2**30:.2f} GiB, launches a step "
        f"{row['launches_per_step']}, wall s {row['wall_seconds']}")


def phase_sweep(device, timed_ms: float) -> dict:
    """python -m ...sweep's main in one process under `torchrun
    --nproc-per-node=1`, its kernels' launches printed after it: the four
    variants at b4 float32 and b1024 bfloat16 one process each
    (--data-parallel off), SWEEP_STEPS timed steps each, then one histogram
    b1024 bfloat16 row over NCCL at world size 1 (--data-parallel on); one
    more such row over every card where there are more. Gates: every row
    error-free, finite, on the device clock, with its variant's launches a
    step (SWEEP_LAUNCHES_A_STEP); the histogram b1024 bfloat16 device
    ms/step within SWEEP_VS_TIMED of `timed_ms`, phase_timed_chunk's
    reading of the same program."""
    out_dir = os.path.join(TEMP_FOLDER, "sweep")
    common = ["--device", device.type, "--steps", str(SWEEP_STEPS)]
    argvs = [common + ["--dtype", dtype, "--batches", str(batch), "--data-parallel", "off",
                       "--out", os.path.join(out_dir, f"sweep_{dtype}_b{batch}.json")]
             for dtype, batch in SWEEP_REGIMES]
    dp = common + ["--variants", "histogram", "--batches", "1024", "--dtype", "bfloat16",
                   "--data-parallel", "on"]
    rows, launches, seconds = run_sweep(
        device, 1, argvs + [dp + ["--out", os.path.join(out_dir, "sweep_nccl_1.json")]], out_dir)
    if len(rows) != len(SWEEP_REGIMES) * len(SWEEP_VARIANTS) + 1:
        raise AssertionError(f"the sweep printed {len(rows)} rows")
    *rows, nccl = rows
    for row in rows:
        what = f"{row['variant']} {row['dtype']} b{row['batch']}"
        check_sweep_row(row, what)
        log_sweep_row(row, what)
    check_sweep_row(nccl, "NCCL x 1")
    if nccl["n_devices"] != 1:
        raise AssertionError(f"the NCCL row ran on {nccl['n_devices']} ranks")
    log_sweep_row(nccl, "torchrun x 1 over NCCL, histogram bfloat16 b1024 (global)")
    log("sweep", f"{len(rows) + 1} rows in {seconds:.1f} s (one process under torchrun); its "
        f"launches {launches}")
    hist = next(r for r in rows if r["variant"] == "histogram" and r["batch"] == 1024)
    off = abs(1e3 * hist["step_seconds"] - timed_ms) / timed_ms
    log("sweep", f"histogram b1024 bf16: sweep {1e3 * hist['step_seconds']:.3f} device ms/step, "
        f"timed chunk {timed_ms:.3f}: {100 * off:.2f}% apart (gate {100 * SWEEP_VS_TIMED:.0f}%)")
    if off > SWEEP_VS_TIMED:
        raise AssertionError(f"the sweep's histogram b1024 bf16 step is {100 * off:.2f}% from "
                             "the timed chunk's")
    out = {"rows": rows, "nccl_1": nccl, "launches": launches, "seconds": seconds,
           "vs_timed": off}
    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    if cards > 1:
        (row,), _, seconds = run_sweep(
            device, cards, [dp + ["--out", os.path.join(out_dir, f"sweep_nccl_{cards}.json")]],
            out_dir)
        check_sweep_row(row, f"NCCL x {cards}")
        if row["n_devices"] != cards:
            raise AssertionError(f"torchrun x {cards}: the row ran on {row['n_devices']} ranks")
        log_sweep_row(row, f"torchrun x {cards} over NCCL, histogram bfloat16 b1024 (global)")
        out["cards"] = row
    else:
        log("sweep", "one card: no row across cards")
    return out


INFER_STEPS = 8
INFER_VARIANTS = ("baseline-no-aug", "indexed")
INFER_BATCHES = (64, 1024)
# the chunk's checksum against the direct calls' sums: the same kernels on
# the same inputs with the same draws give the same float32 sum a batch;
# the chunk adds the INFER_STEPS sums in float32 on the device, the check
# in float64 on the host, which differ by at most INFER_STEPS float32
# roundings of the running sum (INFER_STEPS x 2^-24 = 4.8e-7 of the sum of
# the sums' magnitudes); this allows 20 times that
INFER_REL = 1e-5


def direct_checksum(config, generator, pool, steps: int) -> tuple:
    """(sum, sum of magnitudes) of the per-batch float32 sums of direct
    train/steps.py::generate calls, dropout drawn from a fresh dropout
    generator, as the chunk's."""
    from palette_and_histo_gan_tpu_torch import bench_infer
    from palette_and_histo_gan_tpu_torch.train.steps import generate

    drop = bench_infer.dropout_generator(pool.device)
    total = magnitude = 0.0
    for i in range(steps):
        s = float(generate(config, generator, bench_infer.batch_at(config, pool, i), drop)
                  .float().sum())
        total += s
        magnitude += abs(s)
    return total, magnitude


def phase_infer(device) -> dict:
    """bench_infer.run for baseline-no-aug and indexed at batches 64 and
    1024, bfloat16, dropout on and --deterministic; every checksum finite;
    at the largest batch the dropout chunk's checksum against direct
    generate calls over the same batches with the same dropout draws,
    within INFER_REL."""
    from palette_and_histo_gan_tpu_torch import bench_infer

    rows = []
    for variant in INFER_VARIANTS:
        for batch in INFER_BATCHES:
            for deterministic in (False, True):
                row = bench_infer.run(variant, batch, INFER_STEPS, "bfloat16", deterministic,
                                      device)
                if not all(math.isfinite(row[k]) for k in ("checksum", "ms_per_batch", "mfu")):
                    raise AssertionError(f"bench_infer: a row that is not finite {row}")
                rows.append(row)
                log("infer", f"{variant} b{batch} dropout {row['dropout'].split()[0]}: "
                    f"{row['ms_per_batch']:.3f} device ms a batch, {row['host_ms_per_batch']:.3f} "
                    f"host, {row['images_per_sec']:.1f} img/s, MFU {100 * row['mfu']:.2f}%, "
                    f"checksum {row['checksum']:.6e}")
        batch = max(INFER_BATCHES)
        config, generator, pool = bench_infer.setup(variant, batch, "bfloat16", device)
        chunk = bench_infer.make_infer_chunk(config, generator, pool)
        got = float(chunk(bench_infer.dropout_generator(device), INFER_STEPS))
        want, magnitude = direct_checksum(config, generator, pool, INFER_STEPS)
        log("infer", f"{variant} b{batch} with dropout: chunk {got:.8e}, direct generate "
            f"{want:.8e}, {abs(got - want) / magnitude:.2e} of the sums' magnitudes "
            f"(tol {INFER_REL})")
        if not abs(got - want) <= INFER_REL * magnitude:
            raise AssertionError(f"the serving chunk's checksum {got} is not the direct "
                                 f"calls' {want}")
    return {"rows": rows}


# launches a call of the components that run a kernel ("pallas2")
COMPONENT_LAUNCHES = {"augment": {"K1": 1.0}, "hist_fwd_bwd": {"K3b": 2.0, "K4b": 1.0}}


def phase_components(device) -> dict:
    """profile_components.run under histogram "pallas2" at b1024 bfloat16
    and b4 float32: augment launches K1 once a call, hist_fwd_bwd K3b twice
    and K4b once; every time finite and positive."""
    from palette_and_histo_gan_tpu_torch import profile_components

    out = {}
    for dtype, batch in (("bfloat16", 1024), ("float32", 4)):
        res = profile_components.run(batch, dtype, device)
        for name, row in res["components"].items():
            times = (row["device_ms"], row["host_marginal_ms"])
            if not all(math.isfinite(t) and t > 0 for t in times):
                raise AssertionError(f"components {dtype} b{batch} {name}: times {times}")
            need = COMPONENT_LAUNCHES.get(name)
            if need is not None and row["launches_per_call"] != need:
                raise AssertionError(f"components {name}: launches a call "
                                     f"{row['launches_per_call']}, needed {need}")
        if not (math.isfinite(res["step_device_ms"]) and res["step_device_ms"] > 0):
            raise AssertionError(f"components: the step's device time {res['step_device_ms']}")
        log("components", f"{dtype} b{batch} (device ms / host marginal ms a call): "
            + ", ".join(f"{n} {r['device_ms']:.3f}/{r['host_marginal_ms']:.3f}"
                        for n, r in res["components"].items())
            + f"; the step {res['step_device_ms']:.3f} device ms (for scale)")
        out[(dtype, batch)] = res
    return out


ROOFLINE_STEPS = 3
# histogram under the CLI's default on a card, "pallas2"
ROOFLINE_VARIANTS = ("histogram", "baseline-no-aug", "indexed")
ROOFLINE_SUM_REL = 0.01  # the groups' sum against the profiled steps' device time
ROOFLINE_UNATTRIBUTED = 0.05
ROOFLINE_MIN_RATIO = 0.95  # a measured time under its own floor: a count is wrong


def phase_roofline(device) -> dict:
    """roofline.run for histogram "pallas2", baseline-no-aug and indexed at
    b1024 bfloat16, ROOFLINE_STEPS profiled steps each: the groups' device
    times sum to the steps' within ROOFLINE_SUM_REL, unattributed at most
    ROOFLINE_UNATTRIBUTED of it, and every group with a floor at least
    ROOFLINE_MIN_RATIO of it. Writes each table under build/chip_smoke/."""
    from palette_and_histo_gan_tpu_torch import roofline
    from palette_and_histo_gan_tpu_torch.utils.profiling import write_build_json

    out = {}
    for variant in ROOFLINE_VARIANTS:
        res = roofline.run(variant, 1024, "bfloat16", ROOFLINE_STEPS, device)
        write_build_json(os.path.join(TEMP_FOLDER, f"roofline_{variant}.json"), res)
        for line in roofline.format_table(res).splitlines():
            log("roofline", f"{variant}: {line}")
        log("roofline", f"{variant}: unattributed rows (ms a step) {res['unattributed_rows_ms']}; "
            f"launches a step {res['launches_per_step']}")
        total, groups = res["step_device_ms"], res["groups_ms"]
        if abs(groups - total) > ROOFLINE_SUM_REL * total:
            raise AssertionError(f"roofline {variant}: groups {groups:.3f} ms against the "
                                 f"step's {total:.3f} ms")
        if res["unattributed_share"] > ROOFLINE_UNATTRIBUTED:
            raise AssertionError(f"roofline {variant}: {100 * res['unattributed_share']:.2f}% "
                                 "unattributed")
        low = [r for r in res["rows"] if r["ratio"] is not None and r["ratio"] < ROOFLINE_MIN_RATIO]
        if low:
            raise AssertionError(f"roofline {variant}: groups under their floor {low}")
        out[variant] = res
    return out


def range_cost_us(n: int = 10000) -> dict:
    """Host microseconds of one enter and exit of a span
    (utils/tracing.py::span) off (no profiler, not enabled), on (enabled: a
    record and two CUDA events) and inside a profile without the record (a
    record_function range), and the spans one b4 float32
    histogram "pallas2" step enters (counted by wrapping tracing.span over
    a one-step chunk)."""
    from palette_and_histo_gan_tpu_torch.sweep import prepare
    from palette_and_histo_gan_tpu_torch.utils import tracing

    def per_call(enter) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            with enter("G-fwd"):
                pass
        return 1e6 * (time.perf_counter() - t0) / n

    setup = prepare("histogram", 4, "float32", torch.device("cuda", 0), histogram_impl="pallas2")
    setup.run(1)
    out = {"span_off_us": per_call(tracing.span),
           "record_function_us": per_call(torch.profiler.record_function)}
    tracing.enable()
    try:
        out["span_on_us"] = per_call(tracing.span)
    finally:
        tracing.enable(False)
        tracing.clear()
    count = [0]
    real = tracing.span

    def counted(name, **attrs):
        count[0] += 1
        return real(name, **attrs)

    tracing.span = counted
    try:
        setup.run(1)
    finally:
        tracing.span = real
    out["spans_a_step"] = count[0]
    out["us_a_step"] = out["span_off_us"] * count[0]
    out["on_us_a_step"] = out["span_on_us"] * count[0]
    out["profiled_us_a_step"] = out["record_function_us"] * count[0]
    return out

# ------------------------------------------------- the regime's entry points


REGIME_STEPS = 126  # two epochs of 63 steps
REGIME_EVAL_EVERY = 63
REGIME_VARIANTS = ("baseline-no-aug", "histogram", "indexed")
# the repository's JAX build records, whose keys the port's records hold
REGIME_RECORDS = {"baseline-no-aug": "build_train_jax.json",
                  "histogram": "build_train_jax_histogram.json",
                  "indexed": "build_train_jax_indexed.json"}
REGIME_PARITY_STEPS = 2
REGIME_FID_AT = (63, 126)  # the RGBA variants' FID curve, on the shared-init InceptionV3
# the port's low-rank FID against the reference's scipy formula on the same
# activations (tests/test_torch_compare_reference_train.py's rtol)
REGIME_FID_REL = 1e-3
BASELINE_EPOCHS = 1
# measure_baseline under torchrun on every card (phase_measure_baseline_dp)
BASELINE_DP_VARIANTS = ("baseline-no-aug", "histogram")
BASELINE_DP_LAUNCHES = {"K1": 63, "K3b": 126, "K4b": 63}  # a rank's, both variants
# rank 0's L1 and FID against phase_measure_baseline's record: another process
# picks its cuDNN algorithms anew, and 63 GAN steps carry those last-bit
# differences to up to 5.9e-3 of the FID at world size 1 on one H100
BASELINE_DP_REL = 5e-2
# the shared-init features' spread across images over their mean |value|,
# by quirk mode: Keras' glorot kernels would leave ~2^-47 (the script's note)
SHARED_SPREAD_REL = {True: 1e-5, False: 1e-3}
BENCH_BATCH, BENCH_STEPS = 1024, 60
BENCH_VS_TIMED = 0.05  # bench's img/s against phase_timed_chunk's device clock


def phase_shared_inception(device) -> dict:
    """The shared-init InceptionV3 of scripts/make_shared_inception.py (the
    extractor of the repository's FID curves), drawn without TensorFlow by
    `python -m palette_and_histo_gan_tpu_torch.convert_inception
    --shared-init F` (its main, in this process, timed) under TEMP_FOLDER.
    Gates: F's digest the one the CPU tests pin
    (models/inception.py::SHARED_INIT_SHA256); 22 sprites' activations at
    input 299 from F on the card within FID_ACT_REL of the largest of the
    CPU's, in both quirk modes; their spread across images (the mean over
    features of the standard deviation over images, over the mean
    |activation|) above SHARED_SPREAD_REL. Returns F's path and the numbers."""
    from palette_and_histo_gan_tpu_torch import convert_inception
    from palette_and_histo_gan_tpu_torch.eval import fid
    from palette_and_histo_gan_tpu_torch.models import inception

    base = os.path.abspath(os.path.join(TEMP_FOLDER, "shared_inception"))
    shutil.rmtree(base, ignore_errors=True)
    path = os.path.join(base, "inception_shared.npz")
    t0 = time.perf_counter()
    run_entry_point(convert_inception.main, ["--shared-init", path], "shared_inception")
    out = {"path": path, "command_s": time.perf_counter() - t0}
    with np.load(path) as f:
        out["digest"] = inception.flat_digest({k: f[k] for k in f.files})
    log("shared_inception", f"{path}: sha256 {out['digest']}, pinned "
        f"{inception.SHARED_INIT_SHA256}; the command took {out['command_s']:.2f} s")
    if out["digest"] != inception.SHARED_INIT_SHA256:
        raise AssertionError(f"shared-init weights: digest {out['digest']}")
    card_ev = fid.FidEvaluator(FID_BATCH, device=device, weights=path)
    cpu_ev = fid.FidEvaluator(FID_BATCH, device="cpu", weights=path)
    sprites = fid_sprites(22, SEED + 3)
    for quirks, x in ((True, sprites.astype(np.float32) / 127.5 - 1.0),
                      (False, sprites.astype(np.float32))):
        card_ev.reference_quirks = cpu_ev.reference_quirks = quirks
        got, want = card_ev.activations(x).cpu(), cpu_ev.activations(x)
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        acts = got.double()
        spread = float(acts.std(dim=0).mean())
        rel = spread / float(acts.abs().mean())
        out[f"quirks_{quirks}"] = {"err": err, "scale": scale, "spread": spread,
                                   "spread_rel": rel}
        log("shared_inception", f"quirks {quirks}: card vs CPU activations max abs {err:.3e} "
            f"({err / scale:.3e} of max |act| {scale:.4f}; tol {FID_ACT_REL}); spread across "
            f"22 images {spread:.4e}, {rel:.3e} of the mean |act| (gate "
            f"{SHARED_SPREAD_REL[quirks]})")
        if not err <= FID_ACT_REL * scale:
            raise AssertionError(f"shared-init activations, quirks {quirks}: card vs CPU {err}")
        if not rel > SHARED_SPREAD_REL[quirks]:
            raise AssertionError(f"shared-init features, quirks {quirks}: spread {rel} of the "
                                 "mean: degenerate")
    return out


def regime_root() -> str:
    """A fresh seeded synthetic dataset root (ref_regime.py's few-colour
    250 / 44 pairs) for the regime's entry points."""
    from palette_and_histo_gan_tpu_torch.ref_regime import write_synthetic_root

    base = os.path.abspath(os.path.join(TEMP_FOLDER, "regime"))
    shutil.rmtree(base, ignore_errors=True)
    t0 = time.perf_counter()
    root = write_synthetic_root(os.path.join(base, "dataset"))
    log("regime", f"synthetic root {root} written in {time.perf_counter() - t0:.1f} s")
    return root


def repo_json(name: str):
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), name)) as f:
        return json.load(f)


def run_entry_point(main, argv: list, what: str) -> tuple[list, dict]:
    """`main(argv)` of a tool in this process, its output logged line by
    line; returns the output's lines and the kernels' launches in it."""
    import contextlib
    import io

    from palette_and_histo_gan_tpu_torch.sweep import launches_since, read_launches

    buf = io.StringIO()
    before = read_launches()
    with contextlib.redirect_stdout(buf):
        code = main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    launches = launches_since(before)
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        log(what, line[:400])
    if code != 0:
        raise AssertionError(f"{what} {' '.join(argv)} returned {code}")
    return lines, launches


def phase_reference_regime(device, root: str, inception_npz: str) -> dict:
    """compare_reference_train's main on the card at full width from the
    synthetic root, REGIME_STEPS steps (an eval every REGIME_EVAL_EVERY) of
    baseline-no-aug, histogram and indexed, each against the repository's
    JAX build record of its variant (a different step count: "not
    comparing"); the RGBA variants with their FID curve at REGIME_FID_AT on
    the shared-init InceptionV3 at `inception_npz`. Gates: finite curves,
    eval L1s and FIDs; the FID at REGIME_FID_AT, its low-rank value within
    REGIME_FID_REL of the scipy one; the record's keys a
    superset of the JAX record's; the first REGIME_PARITY_STEPS steps'
    losses equal to the same steps of the port on the CPU within
    PARITY_RTOL; histogram launching K3b twice and K4b once a step (the
    regime's float32 under "pallas2"), indexed K5 in its dataset build."""
    from palette_and_histo_gan_tpu_torch import compare_reference_train as crt

    out = {}
    for variant in REGIME_VARIANTS:
        path = os.path.join(TEMP_FOLDER, "regime", f"build_train_torch_{variant}.json")
        fid_args = [] if variant == "indexed" else [
            "--fid-at", ",".join(map(str, REGIME_FID_AT)), "--inception-npz", inception_npz]
        _, launches = run_entry_point(crt.main, [
            "--variant", variant, "--steps", str(REGIME_STEPS), "--eval-every",
            str(REGIME_EVAL_EVERY), "--data-root", root, "--reference",
            REGIME_RECORDS[variant], "--out", path, "--device", device.type, *fid_args], "regime")
        with open(path) as f:
            record = json.load(f)
        fids = record.get("fid", []) + record.get("fid_lowrank", [])
        values = [v for c in record["curves"].values() for v in c] + record["eval_l1"] + fids
        if not all(math.isfinite(v) for v in values):
            raise AssertionError(f"regime {variant}: non-finite curves, eval L1s or FIDs")
        fid_rel = None
        if fid_args:
            if record["fid_steps"] != list(REGIME_FID_AT):
                raise AssertionError(f"regime {variant}: FID at {record['fid_steps']}")
            fid_rel = max(abs(lo - sc) / abs(sc) for sc, lo in zip(record["fid"],
                                                                  record["fid_lowrank"]))
            log("regime", f"{variant}: FID at {record['fid_steps']} scipy {record['fid']}, "
                f"low-rank {record['fid_lowrank']}; worst relative gap {fid_rel:.2e} (tol "
                f"{REGIME_FID_REL})")
            if fid_rel > REGIME_FID_REL:
                raise AssertionError(f"regime {variant}: low-rank FID {fid_rel:.2e} from scipy's")
        if any(len(c) != REGIME_STEPS for c in record["curves"].values()) or record[
                "eval_steps"] != [1, REGIME_EVAL_EVERY, REGIME_STEPS]:
            raise AssertionError(f"regime {variant}: curves of {[len(c) for c in record['curves'].values()]} "
                                 f"steps, evals at {record['eval_steps']}")
        missing = set(repo_json(REGIME_RECORDS[variant])) - set(record)
        if missing:
            raise AssertionError(f"regime {variant}: the record lacks the JAX record's {missing}")
        need = ({"K3b": 2 * REGIME_STEPS, "K4b": REGIME_STEPS} if variant == "histogram"
                else {"K5": 4} if variant == "indexed" else {})
        wrong = {k: launches.get(k, 0) for k, n in need.items() if launches.get(k, 0) != n}
        if device.type == "cuda" and wrong:
            raise AssertionError(f"regime {variant}: launches {launches}; needed {need}")
        cpu = crt.train(variant, REGIME_PARITY_STEPS, REGIME_PARITY_STEPS, root=root,
                        device="cpu", histogram_impl=record["histogram_impl"])["curves"]
        worst = max(abs(record["curves"][k][i] - v[i]) / max(abs(v[i]), 1e-12)
                    for k, v in cpu.items() for i in range(REGIME_PARITY_STEPS))
        log("regime", f"{variant}: {REGIME_STEPS} steps, {record['host_ms_per_step']:.3f} host "
            f"ms/step, wall {record['wall_seconds']:.2f} s, test L1 {record['eval_l1']}, "
            f"launches {launches}; first {REGIME_PARITY_STEPS} steps card vs CPU worst rel "
            f"{worst:.2e} (tol {PARITY_RTOL})")
        if worst > PARITY_RTOL:
            raise AssertionError(f"regime {variant}: card and CPU steps differ by {worst:.2e}")
        out[variant] = {"launches": launches, "host_ms_per_step": record["host_ms_per_step"],
                        "wall_seconds": record["wall_seconds"], "eval_l1": record["eval_l1"],
                        "parity": worst, "fid": record.get("fid"),
                        "fid_lowrank": record.get("fid_lowrank"), "fid_rel": fid_rel}
    total = {}
    for run in out.values():
        for k, n in run["launches"].items():
            total[k] = total.get(k, 0) + n
    return {"runs": out, "launches": total}


def phase_measure_baseline(device, root: str) -> dict:
    """measure_baseline's main on the card: the four variants for
    BASELINE_EPOCHS epoch (63 steps) from the synthetic root, with the
    Trainer's previews, L1 reports and checkpoints, FID on (random
    InceptionV3 weights). Gates: finite L1s and FIDs, 63 steps, the keys
    of baseline_results.json's entries, `train_chunk` among the phases;
    K1 once a step for baseline and histogram, K3b twice and K4b once a
    step for histogram, K5 in indexed's dataset build, none for
    baseline-no-aug."""
    from palette_and_histo_gan_tpu_torch import measure_baseline

    path = os.path.join(TEMP_FOLDER, "baseline_results.json")
    _, launches = run_entry_point(measure_baseline.main, [
        "--epochs", str(BASELINE_EPOCHS), "--data-root", root, "--out", path, "--temp-folder",
        os.path.join(TEMP_FOLDER, "measure_baseline"), "--device", device.type],
        "measure_baseline")
    with open(path) as f:
        results = json.load(f)["results"]
    keys = set(repo_json("baseline_results.json")["results"][0])
    steps = 63 * BASELINE_EPOCHS
    need = {"baseline-no-aug": {}, "baseline": {"K1": steps},
            "histogram": {"K1": steps, "K3b": 2 * steps, "K4b": steps},
            "indexed": {"K5": 4}}
    for r in results:
        v = r["variant"]
        bad = [k for k in ("l1_train", "l1_test", "fid_train", "fid_test")
               if not math.isfinite(r[k])]
        if bad or r["steps"] != steps or not keys <= set(r) or "train_chunk" not in r[
                "phase_seconds"]:
            raise AssertionError(f"measure_baseline {v}: non-finite {bad}, {r['steps']} steps, "
                                 f"missing keys {keys - set(r)}, phases {r['phase_seconds']}")
        if device.type == "cuda" and r["launches"] != need[v]:
            raise AssertionError(f"measure_baseline {v}: launches {r['launches']}; "
                                 f"needed {need[v]}")
        log("measure_baseline", f"{v}: {r['train_seconds']:.2f} s, {r['steps_per_second']:.2f} "
            f"steps/s, phases {r['phase_seconds']}, L1 {r['l1_train']:.5f}/{r['l1_test']:.5f}, "
            f"FID {r['fid_train']:.6g}/{r['fid_test']:.6g}, peak device memory "
            f"{r['peak_device_memory_bytes']} bytes, launches {r['launches']}")
    if [r["variant"] for r in results] != list(measure_baseline.VARIANTS):
        raise AssertionError(f"measure_baseline ran {[r['variant'] for r in results]}")
    return {"results": results, "launches": launches}


def phase_measure_baseline_dp(device, root: str, single: list) -> dict:
    """`torchrun --standalone --nproc-per-node=N -m
    palette_and_histo_gan_tpu_torch.measure_baseline --epochs 1 --variants
    baseline-no-aug histogram` over NCCL, N every card of the machine (one
    card: a world of one; on the CPU two ranks over Gloo), from the regime's
    root, through torchrun_audited. Gates: exit 0; only rank 0 prints and
    writes (the audit hook), and it wrote the record; the record's
    `world_size` N, 63 steps a variant; each rank's launches
    BASELINE_DP_LAUNCHES on a card; rank 0's L1s and FIDs finite and within
    BASELINE_DP_REL of `single`, phase_measure_baseline's one-process
    record of the same variants (the same FID weights: random, seed 0)."""
    world = torch.cuda.device_count() if device.type == "cuda" else 2
    ran = torchrun_audited("measure_baseline_dp", world, [
        "-m", "palette_and_histo_gan_tpu_torch.measure_baseline", "--epochs",
        str(BASELINE_EPOCHS), "--variants", *BASELINE_DP_VARIANTS, "--data-root", root,
        "--device", device.type])
    path = os.path.join(ran["run"], "build", "baseline_results.json")
    if not any(p == path for _, p in ran["writes"][0]):
        raise AssertionError(f"measure_baseline_dp: rank 0 did not write {path}")
    with open(path) as f:
        record = json.load(f)
    if record["world_size"] != world or [r["variant"] for r in record["results"]] != list(
            BASELINE_DP_VARIANTS):
        raise AssertionError(f"measure_baseline_dp: world_size {record['world_size']} of "
                             f"{world}, variants {[r['variant'] for r in record['results']]}")
    launches = {r: {k: n for k, n in (counts or {}).items() if n}
                for r, counts in ran["launches"].items()}
    log("measure_baseline_dp", f"{world} rank(s): exit 0 in {ran['seconds']:.1f} s; world_size "
        f"{record['world_size']}; launches by rank {launches}; rank 0 wrote "
        f"{len(ran['writes'][0])} paths, ranks above 0 printed nothing and wrote nothing")
    if device.type == "cuda" and any(n != BASELINE_DP_LAUNCHES for n in launches.values()):
        raise AssertionError(f"measure_baseline_dp: launches {launches}; each rank needed "
                             f"{BASELINE_DP_LAUNCHES}")
    want = {r["variant"]: r for r in single}
    worst = 0.0
    for r in record["results"]:
        v, ref = r["variant"], want[r["variant"]]
        keys = ("l1_train", "l1_test", "fid_train", "fid_test")
        if r["steps"] != 63 * BASELINE_EPOCHS or not all(math.isfinite(r[k]) for k in keys):
            raise AssertionError(f"measure_baseline_dp {v}: {r}")
        rel = {k: abs(r[k] - ref[k]) / abs(ref[k]) for k in keys}
        worst = max(worst, *rel.values())
        log("measure_baseline_dp", f"{v}: {r['train_seconds']:.2f} s, L1 {r['l1_train']:.5f}/"
            f"{r['l1_test']:.5f}, FID {r['fid_train']:.6g}/{r['fid_test']:.6g}; against one "
            f"process {', '.join(f'{k} {x:.2e}' for k, x in rel.items())} relative (tol "
            f"{BASELINE_DP_REL}); rank 0's launches {r['launches']}")
    if worst > BASELINE_DP_REL:
        raise AssertionError(f"measure_baseline_dp: {worst:.2e} from the one-process record")
    return {"world": world, "seconds": ran["seconds"], "results": record["results"],
            "launches": launches, "worst": worst}


def phase_bench(device, timed: dict) -> dict:
    """The port's bench at BENCH_BATCH bfloat16 for BENCH_STEPS steps, its
    line logged; its img/s (device clock) within BENCH_VS_TIMED of the
    histogram "pallas2" b1024 bfloat16 timed chunk's device clock, the same
    program."""
    from unittest import mock

    from palette_and_histo_gan_tpu_torch import bench

    env = {"PHG_BENCH_BATCH": str(BENCH_BATCH), "PHG_BENCH_STEPS": str(BENCH_STEPS),
           "PHG_BENCH_DTYPE": "bfloat16"}
    with mock.patch.dict(os.environ, env):
        lines, launches = run_entry_point(
            bench.main, ["--device", device.type, "--out", os.path.join(TEMP_FOLDER, "bench.json")],
            "bench")
    record = json.loads(lines[-1])
    want = BENCH_BATCH / (timed["device_ms_per_step"] / 1e3)
    off = abs(record["value"] - want) / want
    log("bench", f"{record['value']:.1f} img/s against the timed chunk's {want:.1f}: "
        f"{100 * off:.2f}% apart (gate {100 * BENCH_VS_TIMED:.0f}%); launches {launches}")
    if record["vs_baseline"] is not None or device.type == "cuda" and (
            record["clock"] != "device" or off > BENCH_VS_TIMED):
        raise AssertionError(f"bench: {record}; {100 * off:.2f}% from the timed chunk")
    return {"record": record, "launches": launches, "vs_timed": off}


# ------------------------------------------------------------------- main


LIBRARIES = (("phg_augment", "augment.cu"), ("phg_histogram", "histogram.cu"),
             ("phg_palette", "palette.cu"), ("phg_moments", "moments.cu"),
             ("phg_indexed_loss", "indexed_loss.cu"))


def build_kernels() -> None:
    """The five libraries, with their nvcc processes at once."""
    from concurrent.futures import ThreadPoolExecutor

    from palette_and_histo_gan_tpu_torch.kernels import build
    from palette_and_histo_gan_tpu_torch.ops import (augment_kernel, histogram_kernel, indexed_loss,
                                                     moments, palette_kernel)

    t0 = time.perf_counter()
    loaders = (augment_kernel.library, histogram_kernel.library, palette_kernel.library,
               moments.library, indexed_loss.library)
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


def kernel_entry(name, kernel, launches, max_abs_err, times) -> dict:
    """One entry of the kernels line for TPU kernel `kernel` (its source and
    the TPU body it replaces from kernels/table.py); `times` is (kernel ms,
    plain ms, bound ms, what bounds it). No single PyTorch call computes
    any of these functions, so library_ms is null."""
    from palette_and_histo_gan_tpu_torch.kernels.table import BY_NAME

    ms, plain_ms, bound_ms, bound_by = times
    return {
        "name": name, "route": "cuda", "source": BY_NAME[kernel].source,
        "replaces": BY_NAME[kernel].body,
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
    hist = {"worst": phase_histogram_check(device), "times": phase_histogram_times(device),
            "padded": phase_histogram_padded(device)}

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
    in_stats = phase_in_stats(device)
    cce = phase_indexed_loss(device)
    decoder = phase_decoder_layouts(device)
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
    tools = {}
    for name, phase in (
        ("sweep", lambda: phase_sweep(device, bf16["pallas2"]["device_ms_per_step"])),
        ("infer", lambda: phase_infer(device)), ("components", lambda: phase_components(device)),
        ("roofline", lambda: phase_roofline(device)),
    ):
        t0 = time.perf_counter()
        tools[name] = phase()
        tools[name]["phase_s"] = time.perf_counter() - t0
        log(name, f"phase {tools[name]['phase_s']:.1f} s")
    t0 = time.perf_counter()
    shared = phase_shared_inception(device)
    log("shared_inception", f"phase {time.perf_counter() - t0:.1f} s")
    root = regime_root()
    for name, phase in (
        ("regime", lambda: phase_reference_regime(device, root, shared["path"])),
        ("measure_baseline", lambda: phase_measure_baseline(device, root)),
        ("measure_baseline_dp", lambda: phase_measure_baseline_dp(
            device, root, tools["measure_baseline"]["results"])),
        ("bench", lambda: phase_bench(device, bf16["pallas2"])),
    ):
        t0 = time.perf_counter()
        tools[name] = phase()
        tools[name]["phase_s"] = time.perf_counter() - t0
        log(name, f"phase {tools[name]['phase_s']:.1f} s")
    ranges = range_cost_us()
    log("spans", f"{ranges['spans_a_step']} spans a b4 f32 histogram step: "
        f"{ranges['span_off_us']:.3f} us a span off, {ranges['us_a_step']:.1f} us a step (host); "
        f"{ranges['span_on_us']:.2f} us on (record, events), {ranges['on_us_a_step']:.1f} "
        f"us a step; "
        f"{ranges['record_function_us']:.2f} us a range in a profile, "
        f"{ranges['profiled_us_a_step']:.1f} us a step")
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
        kernel_entry(f"augment_{entry}", kernel, launches[entry],
                     kern["worst"][entry], kern["times"][(entry, 1024)])
        for entry, kernel in AUGMENT_KERNELS.items()
    ]
    kernels += [
        kernel_entry(name, name, launches[name], hist["worst"][name], hist["times"][(name, 1024)])
        for name in HIST_KERNELS
    ]
    # the tensor-core kernels run in the b1024 bf16 chunks
    for entry in kernels:
        if entry["name"] in BF16_LAUNCHES_A_STEP:
            entry["bf16_launches"] = sum(r["bf16_launches"][entry["name"]] for r in bf16.values())
    kernels.append(kernel_entry("K5", "K5", launches["K5"], 0, pal["times"][pal["n_images"]]))
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
    # the launches of the sweep's process (eight rows, SWEEP_STEPS timed
    # steps each after as many of warm-up and as many profiled)
    for entry in kernels:
        name = {"augment_packed": "packed"}.get(entry["name"], entry["name"])
        if tools["sweep"]["launches"].get(name):
            entry["sweep_launches"] = tools["sweep"]["launches"][name]
    # the launches of the regime's entry points: compare_reference_train's
    # three runs, measure_baseline's four fits, bench's process of steps
    for entry in kernels:
        name = {"augment_packed": "K1", "augment_rgba": "K2"}.get(entry["name"], entry["name"])
        for key, n in (("regime_launches", tools["regime"]["launches"].get(name)),
                       ("measure_baseline_launches", tools["measure_baseline"]["launches"].get(name)),
                       ("measure_baseline_dp_rank_launches",
                        tools["measure_baseline_dp"]["launches"][0].get(name)),
                       ("bench_launches", tools["bench"]["launches"].get(name))):
            if n:
                entry[key] = n
    # K3a beside the bound of its products as float32 FMAs
    k3a = next(e for e in kernels if e["name"] == "K3a")
    k3a["bound_f32_fma_ms"] = hist["times"][("K3a fma", 1024)][0]
    # K6 at MOMENTS_ENTRY_ROW, its launches those of the A/B; beside it the
    # A/B's forms A and B at that row, every A/B row, and what K6 under the
    # networks' InstanceNorm could save a b1024 step at most
    k6 = kernel_entry("K6", "K6", in_stats["launches"], in_stats["worst"], in_stats["times"])
    k6["ab_ms"] = in_stats["ab_ms"]
    k6["ab_rows"] = [
        {key: r[key] for key in ("shape", "layout", "floor_ms", "A_event_ms", "B_event_ms",
                                 "C_event_ms", "A_device_ms", "B_device_ms", "C_device_ms",
                                 "A_ms", "B_ms", "C_ms", "B_output")}
        for r in in_stats["rows"]
    ]
    k6["instance_norm_step"] = in_stats["step"]
    k6["small_device_ms"] = in_stats["small_device_ms"]
    kernels.append(k6)
    # the indexed losses' kernel pair, which replaces no TPU kernel: both
    # kernels at the float32 b1024 step's shape, their launches the indexed
    # main path's, the phase's checks beside them, every shape's times
    pair = cce["times"]["B=1024 float32"]
    kernels.append({
        "name": "CCE", "route": "cuda", "source": "palette_and_histo_gan_tpu_torch/csrc/indexed_loss.cu",
        "replaces": None, "launches": {key: launches[key] for key in cce["launches"]},
        "check_launches": cce["launches"], "max_abs_err": cce["worst"],
        "ms": pair["fwd_ms"] + pair["bwd_ms"], "plain_ms": pair["plain_ms"],
        "bound_ms": pair["fwd_bound_ms"] + pair["bwd_bound_ms"], "bound_by": "bytes",
        "library_ms": None, "times": cce["times"],
    })
    log("summary", f"{card}: b4 kernel/plain ms "
        + ", ".join(f"{e} {kern['times'][(e, 4)][0]:.4f}/{kern['times'][(e, 4)][1]:.4f}" for e in ("packed", "rgba"))
        + ", " + ", ".join(f"{n} {hist['times'][(n, 4)][0]:.4f}/{hist['times'][(n, 4)][1]:.4f}" for n in HIST_KERNELS)
        + f", K5 {pal['times'][4][0]:.4f}/{pal['times'][4][1]:.4f}"
        + f"; K3a b1024 {k3a['ms']:.4f} ms: {100 * k3a['bound_ms'] / k3a['ms']:.1f}% of its 3xTF32 bound "
        + f"{k3a['bound_ms']:.4f} ms, {100 * k3a['bound_f32_fma_ms'] / k3a['ms']:.1f}% of the float32-FMA "
        + f"bound {k3a['bound_f32_fma_ms']:.4f} ms"
        + f"; K6 {MOMENTS_ENTRY_ROW[0]} {MOMENTS_ENTRY_ROW[1]} {k6['ms']:.4f} ms, "
        + f"{100 * k6['bound_ms'] / k6['ms']:.1f}% of its bytes bound {k6['bound_ms']:.4f} ms (A "
        + f"{k6['ab_ms']['A']:.4f}, B {k6['ab_ms']['B']:.4f} ms)"
        + f"; CCE b1024 f32 {kernels[-1]['ms']:.4f} ms, {100 * kernels[-1]['bound_ms'] / kernels[-1]['ms']:.1f}% "
        + f"of its bytes bound {kernels[-1]['bound_ms']:.4f} ms (plain {kernels[-1]['plain_ms']:.4f} ms)"
        + "; decoder b1024 f32 fwd + bwd ms parent/port " + ", ".join(
            f"up{r['block']} {sum(r['parent']['fwd_ms'] + r['parent']['bwd_ms']) / 2:.2f}/"
            f"{sum(r['port']['fwd_ms'] + r['port']['bwd_ms']) / 2:.2f}" for r in decoder)
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
        + f"; spans {ranges['us_a_step']:.2f} us a b4 f32 step off (host, "
        + f"{ranges['spans_a_step']} x {ranges['span_off_us']:.3f}; on "
        + f"{ranges['on_us_a_step']:.1f}; profiled {ranges['profiled_us_a_step']:.1f})"
        + "; sweep (device ms/step, b1024 bf16) " + ", ".join(
            f"{r['variant']} {1e3 * r['step_seconds']:.3f}" for r in tools["sweep"]["rows"]
            if r["batch"] == 1024)
        + f", {100 * tools['sweep']['vs_timed']:.2f}% from the timed chunk"
        + "; infer b1024 bf16 ms a batch " + ", ".join(
            f"{r['variant']} {r['dropout'].split()[0]} {r['ms_per_batch']:.3f}"
            for r in tools["infer"]["rows"] if r["batch"] == 1024)
        + "; roofline b1024 bf16 unattributed " + ", ".join(
            f"{v} {100 * tools['roofline'][v]['unattributed_share']:.2f}%"
            for v in ROOFLINE_VARIANTS)
        + f"; bench {tools['bench']['record']['value']:.1f} img/s b{BENCH_BATCH} bf16 "
        + f"({100 * tools['bench']['vs_timed']:.2f}% from the timed chunk)"
        + "; regime host ms/step " + ", ".join(
            f"{v} {tools['regime']['runs'][v]['host_ms_per_step']:.3f}" for v in REGIME_VARIANTS)
        + "; measure_baseline (1 epoch) s " + ", ".join(
            f"{r['variant']} {r['train_seconds']:.2f}" for r in tools["measure_baseline"]["results"])
        + f"; measure_baseline under torchrun x {tools['measure_baseline_dp']['world']} s " + ", ".join(
            f"{r['variant']} {r['train_seconds']:.2f}" for r in tools["measure_baseline_dp"]["results"])
        + f" ({tools['measure_baseline_dp']['worst']:.2e} from one process)"
        + f"; shared-init InceptionV3 command {shared['command_s']:.2f} s; regime FID (scipy) at "
        + f"{list(REGIME_FID_AT)} " + ", ".join(
            f"{v} {tools['regime']['runs'][v]['fid']}" for v in REGIME_VARIANTS if v != "indexed")
        + "; tool phases " + ", ".join(f"{k} {v['phase_s']:.1f} s" for k, v in tools.items())
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
