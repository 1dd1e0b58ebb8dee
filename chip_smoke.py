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
     the bfloat16 histogram backward and counts its HGMMA (wgmma)
     instructions in the library's SASS (cuobjdump): none fails.
  3. augment kernel vs plain: every input format x float32/bfloat16 output
     x normalize on/off, at B=4 and B=1024, on the same draws; float32
     within 5e-4 on the 0-255 scale, bfloat16 within one bfloat16 ulp
     beyond that float32 tolerance. Times both at the main path's shapes
     with CUDA events.
  4. histogram kernels vs plain: each of K3a, K3b (forward) and K4a, K4b,
     K4c (backward) at B=4 and B=1024, 64x64 images, 64 bins, in every
     chain its configuration allows, on the same seeded pixels and
     cotangents; within HIST_TOL of the largest |plain value|. Times both
     with CUDA events in the chain each regime runs: B=1024 with the
     bfloat16 compute dtype (K3a/K4a keep their float32 chain), B=4 float32.
  5. parity: two full-width float32 histogram-variant steps on the card
     (kernel path) against the same steps on the CPU (plain path), from the
     same weights on the same batches, deterministic dropout and no
     augmentation draws kept (the kernel only normalizes); losses within
     rtol 1e-3. Under the default histogram ("xla"/"tri"), "pallas" and
     histogram_bwd="pallas".
  6. main path: a full-width float32 histogram-variant Trainer, batch 4, on
     a seeded synthetic sprite set of 250 train / 44 test pairs;
     fit(steps=8, update_steps=4) with the L1 report, then one single step
     (make_train_step) on a uint8 batch; once under each histogram
     configuration ("xla"/"tri", "pallas", "pallas2", histogram_bwd
     "pallas"). The kernel launch counts are set to 0 before each run and
     read after; the augmentation's must be at least 8 (packed) and 1
     (uint8), the configuration's histogram forward at least 16 and its
     backward at least 8.
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
 10. timed chunks, each after a 2-step warm-up, through Trainer.fit at
     full width: histogram float32 batch 4 (40 steps) and bfloat16 batch
     1024 (10 steps) under "xla"/"tri", bfloat16 batch 1024 under
     "pallas", "pallas2" and histogram_bwd="pallas"; indexed float32 batch
     4 (40 steps) and bfloat16 batch 1024 (10 steps); finite losses,
     ms/step, img/s, peak device memory. The histogram launch counts are
     set to 0 before each warm-up and read after its chunk: under
     "pallas2" and histogram_bwd="pallas" the bfloat16 backward (the
     tensor-core kernel, K4b and K4c) must run once a step, 12 times.

The kernels line gives each kernel's time at the main path's largest
shape beside its bound: the largest of the bytes it must move (inputs read
once, outputs written once) over 3.35 TB/s and its operations over the
card's peak for their type (PEAK); for the histogram kernels the products
at the chain's peak and the elementwise chain at float32's
(ops/histogram_kernel.py::work). K4b and K4c also give the bfloat16
backward's launches in the b1024 bf16 chunks (bf16_launches).
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 47
F32_TOL = 5e-4  # on the 0-255 scale (palette_and_histo_gan_tpu/ops/augment_pallas.py:67-68)
PARITY_RTOL = 1e-3
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
#  * float32: the same elementwise chain op for op; the sums over 4096
#    pixels (forward) and over 64 bins (backward) run in another order;
#  * bfloat16: the products are exact in float32 on both sides, but a
#    float32 sum in another order (for the backward, the tensor cores'
#    accumulation) can put a bfloat16 rounding of m1, da or
#    a per-pixel reduction on the other side of a tie, one bfloat16 ulp
#    (2^-8 relative) of that value; the backward allows two such ulps of
#    the largest row. The approximate reciprocal (plain: exact) rounds to
#    the same bfloat16 (tests/test_torch_histogram_bwd_bf16.py).
HIST_TOL = {
    ("fwd", "float32"): 1e-5, ("bwd", "float32"): 1e-4,
    ("fwd", "bfloat16"): 1e-4, ("bwd", "bfloat16"): 8e-3,
}
# the backwards whose bfloat16 chain runs the tensor-core kernel
# (hist_bwd_bf16); their b1024 bf16 chunks must launch it every step
BF16_BACKWARDS = ("K4b", "K4c")
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
# logs of the smoke's Trainers go under a folder .gitignore lists
TEMP_FOLDER = os.path.join("build", "chip_smoke")

# An H100 SXM's peaks (NVIDIA's data sheet, dense): memory bytes/s and
# operations/s by type. int32 on the CUDA cores: 132 SMs x 64 INT32 lanes x
# 1.98 GHz (the Hopper white paper; half the float32 lanes behind the
# float32 67 TFLOP/s). bfloat16 is the tensor cores' rate: the bfloat16
# chain's products are bfloat16 x bfloat16 summed in float32.
PEAK = {"bytes": 3.35e12, "float32": 67e12, "bfloat16": 989e12, "int32": 132 * 64 * 1.98e9}
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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


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


def histogram_inputs(b: int, device, seed: int):
    """Per-pixel logs (B, 3, HW) and Iy (B, HW) of seeded uint8 pixels, and
    a seeded (B, 3, 64, 64) cotangent, all float32 on `device`."""
    from palette_and_histo_gan_tpu_torch.ops import histogram_kernel as hk

    rng = np.random.default_rng(seed)
    flat01 = torch.from_numpy(rng.integers(0, 256, (b, 4096, 3), dtype=np.uint8)).to(device).float() / 255.0
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
    approx = name == "K4c" and chain == "bfloat16"
    return hk.histogram_backward_cuda(logs, iy, g, approx=approx, kernel=name, **kw)


def phase_histogram_check(device) -> dict:
    """Each histogram kernel against its plain version in every chain its
    configuration allows, at B=4 and B=1024 (and the RBF kernel at B=4).
    Returns per kernel its worst absolute error."""
    worst = {name: 0.0 for name in HIST_KERNELS}
    for b in (4, 1024):
        logs, iy, g = histogram_inputs(b, device, SEED + b)
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
                    log("hist", f"{name} B={b} {chain} {method}: max|kernel - plain| {err:.3e}, "
                        f"{rel:.3e} of max|plain| (tol {tol:g})")
                    if not (math.isfinite(rel) and rel <= tol):
                        raise AssertionError(f"{name} disagrees with its plain version: B={b} {chain} {method}")
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
            # the products at the chain's peak (bfloat16: the tensor
            # cores), the elementwise chain at float32's, the bytes
            w = hk.work(HIST_KERNELS[name][0], b, logs.shape[-1])
            times[(name, b)] = ((k1 + k2) / 2, (p1 + p2) / 2,
                                *bound(w["bytes"], (w["products"], chain), (w["elementwise"], "float32")))
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


def phase_parity(device, config_overrides: dict) -> float:
    """Two float32 steps on `device` against the same two on the CPU, from
    the same weights; returns the worst relative loss difference."""
    from palette_and_histo_gan_tpu_torch import config_for_variant
    from palette_and_histo_gan_tpu_torch.train import create_train_state, make_train_step
    from palette_and_histo_gan_tpu_torch.train.steps import pack_rows

    config = config_for_variant(
        "histogram", deterministic_dropout=True, augment_probability=0.0,
        temp_folder=TEMP_FOLDER, **config_overrides,
    )
    ref = create_train_state(config, "cpu", SEED)
    dev = create_train_state(config, device, SEED)
    dev.generator.load_state_dict(ref.generator.state_dict())
    dev.discriminator.load_state_dict(ref.discriminator.state_dict())
    step = make_train_step(config)
    rng = np.random.default_rng(SEED)
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
            log("parity", f"step {i} {k}: {device.type} {m_dev[k]:.7g}  cpu {m_ref[k]:.7g}  rel {rel:.2e}")
    if worst > PARITY_RTOL:
        raise AssertionError(f"card and CPU steps differ by {worst:.2e} > {PARITY_RTOL}")
    return worst


def phase_main_path(device, config_overrides: dict, hist_kernels=(), steps=8, update_steps=4) -> dict:
    """The Trainer's fit and one single step on a uint8 batch; returns the
    launch counts of that run, augmentation's and histogram's."""
    from palette_and_histo_gan_tpu_torch import config_for_variant
    from palette_and_histo_gan_tpu_torch.data import batch_indices
    from palette_and_histo_gan_tpu_torch.ops import augment_kernel, histogram_kernel
    from palette_and_histo_gan_tpu_torch.train import make_train_step
    from palette_and_histo_gan_tpu_torch.train.trainer import Trainer

    config = config_for_variant("histogram", temp_folder=TEMP_FOLDER, **config_overrides)
    trainer = Trainer(config, device, synthetic_datasets(config, device))
    log("main", f"train {trainer.train_ds.n} / test {trainer.test_ds.n} pairs, batch {config.batch_size}, "
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
            f"step {i}: G total {row['generator/total_loss']:.5f}  "
            f"G hellinger {row['generator/histogram_loss']:.5f}  "
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
    # each step runs the histogram twice (real and fake) and backpropagates
    # the fake's only
    need = {"packed": steps, "rgba": 1}
    for name in hist_kernels:
        need[name] = 2 * steps if HIST_KERNELS[name][0] == "fwd" else steps
    short = {k: launches[k] for k, n in need.items() if launches[k] < n}
    if device.type == "cuda" and short:
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


def phase_timed_chunk(device, variant: str, compute_dtype: str, config_overrides: dict,
                      steps: int, bf16_kernels=()) -> dict:
    """One chunk of `steps` steps through Trainer.fit after a 2-step
    warm-up; returns ms/step, img/s, the peak device memory and the
    bfloat16 histogram backward's launches in warm-up and chunk, which must
    reach one a step for each kernel named in `bf16_kernels`."""
    from palette_and_histo_gan_tpu_torch import config_for_variant
    from palette_and_histo_gan_tpu_torch.ops import histogram_kernel
    from palette_and_histo_gan_tpu_torch.train.trainer import Trainer

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
    short = {k: out["bf16_launches"][k] for k in bf16_kernels if out["bf16_launches"][k] < 2 + steps}
    if device.type == "cuda" and short:
        raise AssertionError(f"the {compute_dtype} chunk launched the bfloat16 histogram backward "
                             f"{short} times; needed {2 + steps} each")
    log(
        "timed",
        f"{variant} {compute_dtype} batch {config.batch_size}, {steps} steps in {seconds:.4f} s: "
        f"{out['ms_per_step']:.3f} ms/step, {out['img_per_s']:.1f} img/s, "
        f"peak {out['peak_gib']:.2f} GiB; last step G total "
        f"{last['generator/total_loss']:.5f} D total {last['discriminator/total_loss']:.5f}; "
        f"bfloat16 histogram backward launches {out['bf16_launches']}",
    )
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


def tensor_core_report() -> dict:
    """For each instantiation of the bfloat16 histogram backward
    (hist_bwd_bf16<method>): ptxas' registers and spill bytes from the
    build, and its count of HGMMA (wgmma) instructions in the built
    library's SASS (cuobjdump). Fails if one has none."""
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
        if "hist_bwd_bf16" not in fn:
            continue
        method = "RBF" if "ILi1E" in fn else "inverse-quadratic"
        regs, spills = ptxas.get(fn, (None, None))
        out[method] = {"hgmma": hgmma.get(fn, 0), "registers": regs, "spill_bytes": spills}
        log("build", f"hist_bwd_bf16<{method}>: {hgmma.get(fn, 0)} HGMMA in the SASS; ptxas: "
            f"{regs} registers, spill stores/loads {spills} bytes (None: built before this process)")
    if len(out) != 2 or not all(r["hgmma"] for r in out.values()):
        raise AssertionError(f"the bfloat16 histogram backward lacks tensor-core instructions: {out}")
    return out


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

    t_start = time.perf_counter()
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
        worst = phase_parity(device, dict(batch_size=4, **HIST_CONFIGS[label][0]))
        log("parity", f"{label}: worst relative loss difference {worst:.2e} (tol {PARITY_RTOL})")

    launches = {}
    for label, (overrides, names) in HIST_CONFIGS.items():
        counts = phase_main_path(device, dict(batch_size=4, **overrides), names)
        if label == "xla/tri":
            launches.update(packed=counts["packed"], rgba=counts["rgba"])
        launches.update({name: counts[name] for name in names})

    pal = phase_palette_check(device)
    worst = phase_indexed_parity(device)
    log("parity", f"indexed: worst relative loss difference {worst:.2e} (tol {PARITY_RTOL})")
    launches.update(phase_indexed_main_path(device))

    f32 = phase_timed_chunk(device, "histogram", "float32", dict(batch_size=4), steps=40)
    bf16 = {
        label: phase_timed_chunk(device, "histogram", "bfloat16",
                                 dict(batch_size=1024, **overrides), steps=10,
                                 bf16_kernels=[n for n in names if n in BF16_BACKWARDS])
        for label, (overrides, names) in HIST_CONFIGS.items()
    }
    idx_f32 = phase_timed_chunk(device, "indexed", "float32", dict(batch_size=4), steps=40)
    idx_bf16 = phase_timed_chunk(device, "indexed", "bfloat16", dict(batch_size=1024), steps=10)
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
    # the bfloat16 backward (tensor cores) runs in the b1024 bf16 chunks
    for entry in kernels:
        if entry["name"] in BF16_BACKWARDS:
            entry["bf16_launches"] = sum(r["bf16_launches"][entry["name"]] for r in bf16.values())
    kernels.append(kernel_entry("K5", PAL_SOURCE, PAL_REPLACES, launches["K5"], 0,
                                pal["times"][pal["n_images"]]))
    log("summary", f"{card}: b4 kernel/plain ms "
        + ", ".join(f"{e} {kern['times'][(e, 4)][0]:.4f}/{kern['times'][(e, 4)][1]:.4f}" for e in ("packed", "rgba"))
        + ", " + ", ".join(f"{n} {hist['times'][(n, 4)][0]:.4f}/{hist['times'][(n, 4)][1]:.4f}" for n in HIST_KERNELS)
        + f", K5 {pal['times'][4][0]:.4f}/{pal['times'][4][1]:.4f}"
        + f"; histogram f32 b4 {f32['ms_per_step']:.3f} ms/step {f32['img_per_s']:.1f} img/s; bf16 b1024 "
        + ", ".join(f"{label} {r['ms_per_step']:.3f} ms/step {r['img_per_s']:.1f} img/s {r['peak_gib']:.2f} GiB"
                    for label, r in bf16.items())
        + f"; indexed f32 b4 {idx_f32['ms_per_step']:.3f} ms/step {idx_f32['img_per_s']:.1f} img/s"
        + f", bf16 b1024 {idx_bf16['ms_per_step']:.3f} ms/step {idx_bf16['img_per_s']:.1f} img/s "
        + f"{idx_bf16['peak_gib']:.2f} GiB"
        + f"; smoke {time.perf_counter() - t_start:.1f} s")
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
