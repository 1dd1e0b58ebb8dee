"""The fused RGB-uv histogram kernels (csrc/histogram.cu): ctypes wrappers,
their plain PyTorch versions, and the per-pixel prologue and finish around
them.

A forward and a backward (one kernel for each chain) stand in for the five
TPU kernels of the JAX package's three Pallas histogram designs
(ROADMAP.md, Queue 2):
  * the forward, (B, 3, HW) logs + (B, HW) Iy -> (B, 3, 64, 64) unnormalized
    planes, for K3a (`histogram_pallas.py::_fwd_kernel`, float32 chain) and
    K3b (`histogram_pallas2.py::_fwd_kernel`, chain in the compute dtype).
    Both chains take H = (Iy Ku) Kv^T on the tensor cores (wgmma, bins as
    M and N, pixels as K), Iy Ku built in registers as the A fragments, Kv
    through two shared-memory buffers a warpgroup, two warpgroups a block
    whose float32 sums are added in a fixed order. A float32 chain
    launches `hist_fwd_f32`: 3xTF32 (each float32 factor split into TF32
    parts hi and lo, lo_A hi_B + hi_A lo_B + hi_A hi_B on wgmma m64n64k8
    tf32), float32-level accuracy, so not subject to
    `config.set_f32_parity_mode`; for small batches an image's pixels
    split over several blocks (`forward_block_pixels`), whose partial
    planes, in a scratch tensor this wrapper allocates, a second pass adds
    in index order. A bfloat16 chain launches `hist_fwd_bf16` (m64n64k16,
    Iy Ku in packed bfloat16);
  * the backward, + the (B, 3, 64, 64) cotangent -> (B, 4, HW) rows
    [numer_r, numer_g, numer_b, d_iy] summed over the channels, for K4a
    (`histogram_pallas.py::_bwd_kernel`), K4b (`histogram_pallas2.py::
    _bwd_kernel`) and K4c (`histogram_pallas3.py::_bwd3_kernel`), all with
    K4c's algebra: m1 = Gc^T Ku, da = Gc Kv, dKv = Iy m1. A float32 chain
    launches `hist_bwd_f32` (float32 FMAs; a block owns up to 1,024 pixels
    of an image, reads each cotangent plane once and transposes it in
    shared memory, 8 x 8 products a thread, the slope weights recomputed
    in registers), a bfloat16 chain `hist_bwd_bf16` (products on the
    tensor cores, wgmma). `backward_block_pixels` is the launch's rule for
    the pixels a block owns.

`histogram_forward` / `histogram_backward` send CUDA tensors to the kernel
(it launches or raises) and CPU tensors to the plain version; `kernel`
names the TPU kernel the call stands in for, and the CUDA launch counts
under that name (`bf16_launches` counts the launches in a bfloat16 chain,
the tensor-core kernels', once more, apart). The plain versions compute
the kernels' algorithm with the same roundings: bin centres
-3 + i * (6 / (size - 1)) in float32 (the TPU kernels' formula, one ulp off
jnp.linspace at most bins), the chain in `chain` with every elementwise
result rounded to it, products accumulated in float32 (the float32
forward's in float64, rounded once: see `_forward_product`), and in a bfloat16
chain m1, da, each product before its reduction and each reduction rounded
to bfloat16, as the TPU kernels' bfloat16 arithmetic rounds them. The
reciprocal is the correctly rounded one everywhere: the float32 kernels
take it branch-free (`reciprocal_mismatches` holds that against
`__frcp_rn` on the card), and of a bfloat16 value the approximate one that
K4c's TPU kernel takes rounds to the same bfloat16
(tests/test_torch_histogram_bwd_bf16.py).
`work` counts what a call of either kernel must do, for its bound.

`FusedHistogram` is the autograd Function of the v1 and v2 entries
(ops/histogram_pallas.py, ops/histogram_pallas2.py), which differ only
in the chain and in the TPU kernels they stand in for; the v3 backward
is ops/histogram_pallas3.py.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build
from .histogram import CHANNEL_TRIPLES, EPSILON, matmul_f32

KERNEL_BINS = 64  # the CUDA kernels are built for 64 bins
PIXEL_TILE = 64  # and for images of a multiple of 64 pixels
FORWARD_KERNELS = ("K3a", "K3b")
BACKWARD_KERNELS = ("K4a", "K4b", "K4c")
METHODS = ("inverse-quadratic", "RBF")
CHAINS = (torch.float32, torch.bfloat16)

# launches in this process, by the TPU kernel each call stands in for. Only
# a launch that returned no error counts; callers that want to count a run
# set all to 0 first (reset_launches). bf16_launches counts the launches in
# a bfloat16 chain (the tensor-core kernels hist_fwd_bf16 and
# hist_bwd_bf16) once more, apart.
launches = {k: 0 for k in FORWARD_KERNELS + BACKWARD_KERNELS}
bf16_launches = {k: 0 for k in FORWARD_KERNELS + BACKWARD_KERNELS}

_lib = None


def reset_launches() -> None:
    for counts in (launches, bf16_launches):
        for key in counts:
            counts[key] = 0


def library() -> ctypes.CDLL:
    """The kernels' shared library, built from csrc/histogram.cu at first
    use, with multiply-add contraction allowed for the products (the
    elementwise chain uses non-contracting intrinsics)."""
    global _lib
    if _lib is None:
        lib = build.load_library("phg_histogram", ("histogram.cu",))
        lib.phg_hist_fwd.argtypes = (
            # bf16, rbf; logs, iy, out, scratch; scratch floats; batch, hw;
            # inv_s; stream
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_long]
            + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]
        )
        lib.phg_hist_fwd.restype = ctypes.c_int
        lib.phg_hist_bwd.argtypes = (
            # bf16, rbf; logs, iy, g, rows; batch, hw; inv_s, scale; stream
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
            + [ctypes.c_float] * 2 + [ctypes.c_void_p]
        )
        lib.phg_hist_bwd.restype = ctypes.c_int
        lib.phg_rcp_mismatches.argtypes = (
            # first bit pattern, count; counter; stream
            [ctypes.c_uint] * 2 + [ctypes.c_void_p] * 2
        )
        lib.phg_rcp_mismatches.restype = ctypes.c_int
        lib.phg_tf32_mismatches.argtypes = lib.phg_rcp_mismatches.argtypes
        lib.phg_tf32_mismatches.restype = ctypes.c_int
        _lib = lib
    return _lib


# ------------------------------------------------------ prologue and finish


def logs_and_intensity(flat01: torch.Tensor):
    """(B, HW, 3) pixels in [0, 1] -> logs (B, 3, HW) = log(x + eps) and
    Iy (B, HW) = sqrt(sum x^2 + eps), both in flat01's dtype."""
    logs = torch.log(flat01 + EPSILON).movedim(-1, 1).contiguous()
    iy = torch.sqrt(torch.sum(torch.square(flat01), dim=-1) + EPSILON)
    return logs, iy


def finish(rows: torch.Tensor, flat01: torch.Tensor, iy: torch.Tensor) -> torch.Tensor:
    """d(loss)/d(flat01) from the backward's (B, 4, HW) rows:
    numer / (x + eps) + (d_iy / Iy) x, in float32."""
    numer = rows[:, :3].transpose(1, 2)  # (B, HW, 3)
    return numer / (flat01 + EPSILON) + (rows[:, 3] / iy)[..., None] * flat01


def domain(size: int, device) -> torch.Tensor:
    """Bin centres -3 + i * (6 / (size - 1)) in float32, as the TPU kernels
    build them (histogram_pallas.py::_domain)."""
    steps = torch.arange(size, dtype=torch.float32, device=device)
    return -3.0 + steps * (6.0 / (size - 1))


def chain_scalar(value: float, chain: torch.dtype) -> float:
    """`value` rounded to the chain's type, as jnp.asarray(value, dtype)."""
    return float(torch.tensor(value, dtype=torch.float64).to(chain))


def _check_args(method, chain, kernel, kernels):
    if method not in METHODS:
        raise ValueError(f"unknown histogram method {method!r}")
    if chain not in CHAINS:
        raise ValueError(f"chain must be float32 or bfloat16, got {chain}")
    if kernel not in kernels:
        raise ValueError(f"kernel must be one of {kernels}, got {kernel!r}")


# per (pixel, bin, channel), as K4c's algebra writes it with the
# inverse-quadratic kernel (the main path's): a kernel value is
# x = diff - t, x * x, * inv_s, 1 + d and a reciprocal; the forward takes
# two and Iy * Ku; the backward two, the two slope weights k * (k * x) and
# a multiply and an add for each of s_y, s_u and s_v
ELEMENTWISE_OPS = {"fwd": 2 * 5 + 1, "bwd": 2 * 5 + 2 * 2 + 3 * 2}


def work(direction: str, batch: int, hw: int, size: int = KERNEL_BINS,
         chain: torch.dtype = torch.float32) -> dict:
    """What one call of the forward ("fwd") or backward ("bwd") kernel in
    `chain` must do, from its shapes: `products`, the FLOP of its matrix
    products (the forward's H = (Iy Ku)^T Kv, the backward's m1 and da; 2 a
    multiply-add), taken `passes` times on the units `product_type` names
    (the float32 forward: three TF32 products, 3xTF32; the float32
    backward: float32 FMAs; a bfloat16 chain: the tensor cores in
    bfloat16), `elementwise`, the operations of the kernel-value chain and
    the per-pixel sums (ELEMENTWISE_OPS), and `bytes`, its float32 inputs
    read once and its output written once."""
    cells = batch * 3 * size * hw  # (image, channel, bin, pixel)
    inputs = 4 * (batch * 3 * hw + batch * hw)  # logs and Iy
    if direction == "fwd":
        products = 2 * cells * size
        moved = inputs + 4 * batch * 3 * size * size
    elif direction == "bwd":
        products = 2 * 2 * cells * size
        moved = inputs + 4 * batch * 3 * size * size + 4 * batch * 4 * hw
    else:
        raise ValueError(f"direction must be 'fwd' or 'bwd', got {direction!r}")
    if chain == torch.bfloat16:
        passes, product_type = 1, "bfloat16"
    elif direction == "fwd":
        passes, product_type = 3, "tf32"
    else:
        passes, product_type = 1, "float32"
    return {"products": products, "passes": passes, "product_type": product_type,
            "elementwise": ELEMENTWISE_OPS[direction] * cells, "bytes": moved}


# -------------------------------------------------------------- plain torch


def _kernel_values(diff, t, method, inv_s):
    """Per channel: K(diff - t) and the slope weight (K^2 x, or K x for
    RBF), (B, size, HW) in diff's dtype (the chain)."""
    x = diff[:, None, :] - t
    d = x * x * inv_s
    if method == "RBF":
        k = torch.exp(-d)
        return k, k * x
    k = (1.0 + d).float().reciprocal().to(x.dtype)
    return k, k * (k * x)


def _forward_product(a, b):
    """a @ b, (B, size, HW) x (B, HW, size), with a float32 result. In a
    float32 chain the float32 products (exact in float64) are summed in
    float64 and rounded once: the sum the TPU kernel's Precision.HIGHEST
    product and the card's 3xTF32 kernel approximate. A float32 sum in one
    fixed order is itself off that sum by up to ~1.3e-5 of the largest
    value over 8,384 pixels (cuBLAS's sequential order on an H100), the
    kernel by < 1e-6 (PERF.md). A bfloat16 chain's products are
    exact in float32 and summed there, as the tensor cores sum them."""
    if a.dtype == torch.float32:
        return torch.matmul(a.double(), b.double()).float()
    return matmul_f32(a, b)


def histogram_forward_plain(logs, iy, *, size, method, sigma, chain):
    """The forward kernel's function in PyTorch: logs (B, 3, HW) and Iy
    (B, HW) float32 -> (B, 3, size, size) float32."""
    t = domain(size, logs.device).to(chain)[:, None]  # (size, 1)
    inv_s = chain_scalar(1.0 / sigma**2, chain)
    iy_c = iy.to(chain)[:, None, :]  # (B, 1, HW)
    planes = []
    for c, p1, p2 in CHANNEL_TRIPLES:
        ku, _ = _kernel_values((logs[:, c] - logs[:, p1]).to(chain), t, method, inv_s)
        kv, _ = _kernel_values((logs[:, c] - logs[:, p2]).to(chain), t, method, inv_s)
        planes.append(_forward_product(iy_c * ku, kv.transpose(1, 2)))
    return torch.stack(planes, dim=1)


def histogram_backward_plain(logs, iy, g, *, size, method, sigma, chain):
    """The backward kernel's function in PyTorch: logs (B, 3, HW), Iy
    (B, HW) and the cotangent g (B, 3, size, size), float32 -> rows
    (B, 4, HW) float32 = [numer_r, numer_g, numer_b, d_iy]. It takes the
    exact reciprocal, as the float32 kernel does; the bfloat16 kernel takes
    the approximate one, which of a bfloat16 value, rounded to bfloat16,
    gives the same bits always (tests/test_torch_histogram_bwd_bf16.py)."""
    t = domain(size, logs.device).to(chain)[:, None]
    inv_s = chain_scalar(1.0 / sigma**2, chain)
    scale = -2.0 / sigma**2
    gc_all = g.to(chain)
    numer = [0.0, 0.0, 0.0]
    d_iy = 0.0
    for ch, (c, p1, p2) in enumerate(CHANNEL_TRIPLES):
        ku, su = _kernel_values((logs[:, c] - logs[:, p1]).to(chain), t, method, inv_s)
        kv, sv = _kernel_values((logs[:, c] - logs[:, p2]).to(chain), t, method, inv_s)
        gc = gc_all[:, ch]  # (B, size_i, size_j)
        m1 = matmul_f32(gc.transpose(1, 2), ku).to(chain)  # (B, j, HW)
        da = matmul_f32(gc, kv).to(chain)  # (B, i, HW)

        def reduce(a, b):
            return torch.sum(a * b, dim=1, dtype=torch.float32).to(chain).float()

        s_y, s_u, s_v = reduce(m1, kv), reduce(da, su), reduce(m1, sv)
        d_iu = iy * (scale * s_u)
        d_iv = iy * (scale * s_v)
        d_iy = d_iy + s_y
        numer[c] = numer[c] + (d_iu + d_iv)
        numer[p1] = numer[p1] - d_iu
        numer[p2] = numer[p2] - d_iv
    return torch.stack(numer + [d_iy], dim=1)


# ------------------------------------------------------------ CUDA wrappers


def _check_cuda_inputs(what, logs, iy, extra=()):
    if not logs.is_cuda:
        raise ValueError(f"{what} needs CUDA tensors, got {logs.device}")
    if logs.dim() != 3 or logs.shape[1] != 3:
        raise ValueError(f"{what}: logs must be (B, 3, HW), got {tuple(logs.shape)}")
    b, _, hw = logs.shape
    if hw < PIXEL_TILE or hw % PIXEL_TILE or not 1 <= b <= 65535:
        raise ValueError(
            f"{what}: the kernel takes 1..65535 images of a multiple of "
            f"{PIXEL_TILE} pixels, got B={b}, HW={hw}"
        )
    for name, t, shape in (("logs", logs, (b, 3, hw)), ("iy", iy, (b, hw)), *extra):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != logs.device:
            raise ValueError(
                f"{what}: {name} must be float32 {shape} on {logs.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte aligned")


MAX_BLOCK_PIXELS = 1024
# the fewest pixels a block of the backward takes: a 64-pixel tile in a
# float32 chain, one for each of the two warpgroups in a bfloat16 chain
MIN_BLOCK_PIXELS = {torch.float32: PIXEL_TILE, torch.bfloat16: 2 * PIXEL_TILE}


def backward_block_pixels(batch: int, hw: int, sms: int, chain: torch.dtype) -> int:
    """The pixels of one image that a block of the backward kernel owns, as
    csrc/histogram.cu::backward_block_pixels chooses them: the most (one
    load of the cotangent planes for more tiles), halved while the grid
    (blocks an image x batch) would not give every one of the card's `sms`
    multiprocessors two blocks."""
    block_pixels = MAX_BLOCK_PIXELS
    while (block_pixels > MIN_BLOCK_PIXELS[chain]
           and batch * -(-hw // block_pixels) < 2 * sms):
        block_pixels //= 2
    return block_pixels


# the fewest and the most pixels a block of the float32 forward takes (the
# most: what its shared memory stages)
MIN_FORWARD_BLOCK_PIXELS = 128
MAX_FORWARD_BLOCK_PIXELS = 4096


def forward_block_pixels(batch: int, hw: int, sms: int) -> int:
    """The pixels of one image that a block of the float32 forward owns, as
    csrc/histogram.cu::forward_block_pixels chooses them: the whole image up
    to MAX_FORWARD_BLOCK_PIXELS, halved (rounded up to a multiple of 64)
    while the grid (3 x batch x parts) would not give every one of the
    card's `sms` multiprocessors two blocks, down to
    MIN_FORWARD_BLOCK_PIXELS. The last part of an image holds what is
    left."""
    block_pixels = min(hw, MAX_FORWARD_BLOCK_PIXELS)
    while (block_pixels > MIN_FORWARD_BLOCK_PIXELS
           and 3 * batch * -(-hw // block_pixels) < 2 * sms):
        block_pixels = -(-(block_pixels // 2) // PIXEL_TILE) * PIXEL_TILE
    return block_pixels


_multiprocessor_counts: dict[int, int] = {}


def _multiprocessors(device: torch.device) -> int:
    """The card's SM count, read once a device (the launch rules' input)."""
    if device.index not in _multiprocessor_counts:
        _multiprocessor_counts[device.index] = (
            torch.cuda.get_device_properties(device).multi_processor_count)
    return _multiprocessor_counts[device.index]


def _count_mismatches(entry: str, device, first: int, last: int) -> int:
    """Run the bit-pattern check `entry` of the library over [first, last)
    on `device`; returns its count."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"{entry} needs a CUDA device, got {device}")
    count = torch.zeros(1, dtype=torch.int64, device=device)
    check = getattr(library(), entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for start in range(first, last, 1 << 30):
            rc = check(start, min(1 << 30, last - start), count.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"{entry} launch failed: cudaError {rc}")
    return int(count)


def reciprocal_mismatches(device, first: int = 0x00800000, last: int = 0x7E800000) -> int:
    """On `device`, the number of float32 bit patterns in [first, last)
    (default: every positive normal value below 2^126, whose reciprocal is
    normal too) on which the float32 chain's branch-free reciprocal differs
    from the correctly rounded `__frcp_rn`. 0 on an H100."""
    return _count_mismatches("phg_rcp_mismatches", device, first, last)


def tf32_mismatches(device, first: int = 0, last: int = 1 << 32) -> int:
    """On `device`, the number of finite float32 bit patterns in [first,
    last) (default: all) on which `cvt.rna.tf32.f32` differs from the
    float32 forward's TF32 rounding, the integer (bits + 2^12) &
    ~(2^13 - 1), which the CPU tests emulate too. 0 on an H100."""
    return _count_mismatches("phg_tf32_mismatches", device, first, last)


def histogram_forward_cuda(logs, iy, *, size, method, sigma, chain, kernel):
    """Launch the forward kernel; raises on anything it does not take and
    on a failed launch."""
    _check_args(method, chain, kernel, FORWARD_KERNELS)
    if size != KERNEL_BINS:
        raise ValueError(f"the histogram kernel is built for {KERNEL_BINS} bins, got {size}")
    _check_cuda_inputs("histogram_forward_cuda", logs, iy)
    b, _, hw = logs.shape
    out = torch.empty((b, 3, size, size), dtype=torch.float32, device=logs.device)
    scratch = None  # the float32 forward's partial planes, when it splits
    if chain == torch.float32:
        parts = -(-hw // forward_block_pixels(b, hw, _multiprocessors(logs.device)))
        if parts > 1:
            scratch = torch.empty((parts,) + out.shape, dtype=torch.float32, device=logs.device)
    lib = library()
    with torch.cuda.device(logs.device):
        rc = lib.phg_hist_fwd(
            int(chain == torch.bfloat16), int(method == "RBF"),
            logs.data_ptr(), iy.data_ptr(), out.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), 0 if scratch is None else scratch.numel(),
            b, hw, chain_scalar(1.0 / sigma**2, chain),
            torch.cuda.current_stream(logs.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"histogram forward kernel launch failed: cudaError {rc}")
    launches[kernel] += 1
    if chain == torch.bfloat16:
        bf16_launches[kernel] += 1
    return out


def histogram_backward_cuda(logs, iy, g, *, size, method, sigma, chain, kernel):
    """Launch the backward kernel; raises on anything it does not take and
    on a failed launch."""
    _check_args(method, chain, kernel, BACKWARD_KERNELS)
    if size != KERNEL_BINS:
        raise ValueError(f"the histogram kernel is built for {KERNEL_BINS} bins, got {size}")
    b = logs.shape[0]
    _check_cuda_inputs("histogram_backward_cuda", logs, iy, (("g", g, (b, 3, size, size)),))
    hw = logs.shape[2]
    rows = torch.empty((b, 4, hw), dtype=torch.float32, device=logs.device)
    lib = library()
    with torch.cuda.device(logs.device):
        rc = lib.phg_hist_bwd(
            int(chain == torch.bfloat16), int(method == "RBF"),
            logs.data_ptr(), iy.data_ptr(), g.data_ptr(), rows.data_ptr(), b, hw,
            chain_scalar(1.0 / sigma**2, chain), -2.0 / sigma**2,
            torch.cuda.current_stream(logs.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"histogram backward kernel launch failed: cudaError {rc}")
    launches[kernel] += 1
    if chain == torch.bfloat16:
        bf16_launches[kernel] += 1
    return rows


# ----------------------------------------------------------------- dispatch


def histogram_forward(logs, iy, *, size, method, sigma, chain, kernel):
    """The forward: the kernel for CUDA tensors, the plain version for CPU
    tensors. logs (B, 3, HW) and iy (B, HW) float32."""
    if logs.is_cuda:
        return histogram_forward_cuda(
            logs, iy, size=size, method=method, sigma=sigma, chain=chain, kernel=kernel
        )
    if logs.device.type != "cpu":
        raise ValueError(f"no histogram kernel for tensors on {logs.device}")
    _check_args(method, chain, kernel, FORWARD_KERNELS)
    return histogram_forward_plain(logs, iy, size=size, method=method, sigma=sigma, chain=chain)


def histogram_backward(logs, iy, g, *, size, method, sigma, chain, kernel):
    """The backward: the kernel for CUDA tensors, the plain version for CPU
    tensors. g (B, 3, size, size) float32."""
    if logs.is_cuda:
        return histogram_backward_cuda(
            logs, iy, g, size=size, method=method, sigma=sigma, chain=chain, kernel=kernel
        )
    if logs.device.type != "cpu":
        raise ValueError(f"no histogram kernel for tensors on {logs.device}")
    _check_args(method, chain, kernel, BACKWARD_KERNELS)
    return histogram_backward_plain(logs, iy, g, size=size, method=method, sigma=sigma, chain=chain)


# ---------------------------------------------------- the fused histograms


class FusedHistogram(torch.autograd.Function):
    """(B, HW, 3) float32 pixels in [0, 1] -> (B, 3, size, size), through
    the forward kernel and the backward kernel named in `kernels`."""

    @staticmethod
    def forward(ctx, flat01, size, method, sigma, chain, kernels):
        logs, iy = logs_and_intensity(flat01)
        ctx.save_for_backward(flat01, logs, iy)
        ctx.args = dict(size=size, method=method, sigma=sigma, chain=chain)
        ctx.bwd_kernel = kernels[1]
        return histogram_forward(logs, iy, kernel=kernels[0], **ctx.args)

    @staticmethod
    def backward(ctx, g):
        flat01, logs, iy = ctx.saved_tensors
        rows = histogram_backward(
            logs, iy, g.float().contiguous(), kernel=ctx.bwd_kernel, **ctx.args
        )
        return finish(rows, flat01, iy), None, None, None, None, None


def fused_histogram(image_batch, size, method, sigma, chain, kernels):
    """[-1, 1] NHWC in, (B, size, size, 3) normalized to sum 1 per image
    out: rescaled in the input's dtype, then float32 before the logs, as
    the JAX package's v1 and v2 entries do."""
    b = image_batch.shape[0]
    flat = (image_batch[..., :3] * 0.5 + 0.5).reshape(b, -1, 3).float()
    hist = FusedHistogram.apply(flat, size, method, sigma, chain, kernels).movedim(1, -1)
    return hist / torch.sum(hist, dim=(1, 2, 3), keepdim=True)
