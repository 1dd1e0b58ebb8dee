"""A/B of the InstanceNorm statistics pass at the decoder's operating points.

    python -m palette_and_histo_gan_tpu_torch.bench_in_stats [--device cuda|cpu]
        [--shape B,C,H,W ...]

The counterpart of `scripts/bench_in_stats.py`. Three forms of (mean,
mean2) over the spatial axes of a bfloat16 (B, C, H, W) tensor, each
(B, C) float32:

  A. `stats_torch`: the two reductions of the networks' bfloat16
     InstanceNorm (`models/networks.py`), mean2 of the bfloat16 square;
  B. `stats_dot`: the ones contraction through cuBLAS; float32 output
     where `torch.mm` / `torch.bmm` take `out_dtype=` on the device, else
     bfloat16 output upcast (each row says which);
  C. `moments`: kernel K6 (`ops/moments.py`, `csrc/moments.cu`), mean2 of
     the float32 square; on a CPU tensor its plain version.

Rows: the script's four decoder shapes (its NHWC (1024, 8, 8, 256), ...,
(1024, 64, 64, 32) as (B, C, H, W)), each as a contiguous (NCHW) tensor
and as a `channels_last` (NHWC in memory) one. A and B are held to C
within 1e-2 absolute, as the script holds its forms to each other
(scripts/bench_in_stats.py:102); A's mean2 sits a few 1e-3 or less from C's
(bfloat16 squares), inside that.

Times: `utils/profiling.py::marginal_call_seconds` (48 and 12 calls, best
of 3), as the script times its forms; on a card, CUDA events over 200
calls beside it, and the device time alone (torch.profiler's kernels,
copies and memsets over 50 calls, `utils/profiling.py::
device_step_seconds`): where a form's device work is shorter than its
host overhead (small shapes), the first two time the host. Each form runs
over a pool of distinct input tensors in turn (at least 4; on a card more
than 128 MB), so that no call finds its input in the card's 50 MB L2
cache and the time is the device memory's. Each row gives the floor, the
bytes (the input read once, the two outputs written once) at 3.35 TB/s.
The first line is the card's name and power limit (nvidia-smi), then one
JSON line a row. The default device is the card; `--device cpu` runs the
plain path and names the CPU in every row.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys

import torch

from .ops import moments as moments_ops
from .utils.profiling import card_line, device_step_seconds, marginal_call_seconds
from .utils.roofline import PEAK

# the script's decoder operating points, NHWC (1024, H, W, C) -> (B, C, H, W)
SHAPES = ((1024, 256, 8, 8), (1024, 128, 16, 16), (1024, 64, 32, 32), (1024, 32, 64, 64))
LAYOUTS = ("nchw", "nhwc")
CHECK_ATOL = 1e-2  # scripts/bench_in_stats.py:102
MIN_POOL = 4
MIN_POOL_BYTES = 128 * 2**20
EVENT_CALLS = 200
DEVICE_CALLS = 50
SEED = 0


def stats_torch(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The networks' bfloat16 InstanceNorm statistics (models/networks.py,
    InstanceNorm.forward), without the keepdim."""
    mean = x.mean((2, 3), dtype=torch.float32)
    mean2 = torch.square(x).mean((2, 3), dtype=torch.float32)
    return mean, mean2


def dot_takes_out_dtype(device) -> bool:
    """Whether torch.mm and torch.bmm give a float32 product of bfloat16
    operands (`out_dtype=`) on `device`."""
    a = torch.ones((1, 2, 8), dtype=torch.bfloat16, device=device)
    try:
        torch.mm(a[0], a[0].t(), out_dtype=torch.float32)
        torch.bmm(a, a.transpose(1, 2), out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError):
        return False
    return True


def stats_dot(x: torch.Tensor, out_dtype: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Sums over HW as products with a ones vector (the square in x's
    dtype), divided by HW, as the script's `stats_dot`: float32 products
    with `out_dtype`, else products in x's dtype upcast."""
    b, c, h, w = x.shape
    hw = h * w
    kw = {"out_dtype": torch.float32} if out_dtype else {}
    if x.is_contiguous():
        flat = x.reshape(b * c, hw)
        ones = torch.ones((hw, 1), dtype=x.dtype, device=x.device)
        s, s2 = torch.mm(flat, ones, **kw), torch.mm(flat * flat, ones, **kw)
    else:  # channels_last: (B, HW, C) in memory
        flat = x.permute(0, 2, 3, 1).reshape(b, hw, c)
        ones = torch.ones((1, 1, hw), dtype=x.dtype, device=x.device).expand(b, 1, hw)
        s, s2 = torch.bmm(ones, flat, **kw), torch.bmm(ones, flat * flat, **kw)
    return s.float().reshape(b, c) / hw, s2.float().reshape(b, c) / hw


def make_pool(shape, layout: str, device, seed: int = SEED) -> list[torch.Tensor]:
    """Distinct seeded N(0, 1) bfloat16 tensors of `shape` in `layout`: at
    least MIN_POOL of them, and on a card more than MIN_POOL_BYTES
    together (more than its L2 cache holds)."""
    device = torch.device(device)
    numel = shape[0] * shape[1] * shape[2] * shape[3]
    size = MIN_POOL
    if device.type == "cuda":
        size = max(MIN_POOL, -(-(MIN_POOL_BYTES + 1) // (2 * numel)))
    fmt = torch.contiguous_format if layout == "nchw" else torch.channels_last
    gen = torch.Generator(device=device).manual_seed(seed)
    return [
        torch.randn(shape, generator=gen, device=device).to(torch.bfloat16).contiguous(memory_format=fmt)
        for _ in range(size)
    ]


def event_ms(fn, pool, calls: int = EVENT_CALLS) -> float:
    """Mean ms a call of `fn` on the pool's tensors in turn, by CUDA events,
    after a warm-up."""
    for x in pool:
        fn(x)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(calls):
        fn(pool[i % len(pool)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def device_ms(fn, pool, calls: int = DEVICE_CALLS) -> float:
    """Mean ms of device time a call of `fn` on the pool's tensors in turn
    (torch.profiler; raises without a CUDA device), after a warm-up."""

    def run(n):
        for i in range(n):
            fn(pool[i % len(pool)])

    run(len(pool))
    return 1e3 * device_step_seconds(run, calls)


def max_err(a, b) -> float:
    return max(float((a[0] - b[0]).abs().max()), float((a[1] - b[1]).abs().max()))


def ab_row(shape, layout: str, device) -> dict:
    """One row: the three forms on a pool of `shape` tensors in `layout`,
    checked against C, timed. `C_calls` counts the calls of form C the row
    made (each launches K6 once on a card)."""
    device = torch.device(device)
    pool = make_pool(shape, layout, device)
    out_dtype = dot_takes_out_dtype(device)
    calls = {"C": 0}

    def form_c(x):
        calls["C"] += 1
        return moments_ops.moments(x)

    forms = {"A": stats_torch, "B": lambda x: stats_dot(x, out_dtype), "C": form_c}
    got = {name: fn(pool[0]) for name, fn in forms.items()}
    a_vs_c, b_vs_c = max_err(got["A"], got["C"]), max_err(got["B"], got["C"])
    if not (a_vs_c < CHECK_ATOL and b_vs_c < CHECK_ATOL):
        raise AssertionError(f"{shape} {layout}: A vs C {a_vs_c:.3e}, B vs C {b_vs_c:.3e} "
                             f"(limit {CHECK_ATOL})")
    b, c, h, w = shape
    nbytes = 2 * b * c * h * w + 2 * 4 * b * c
    row = {
        "shape": list(shape), "layout": layout, "dtype": "bfloat16", "device": str(device),
        "bytes": nbytes, "floor_ms": 1e3 * nbytes / PEAK["bytes"], "pool": len(pool),
        "pool_bytes": 2 * b * c * h * w * len(pool),
        "B_output": "float32 (out_dtype)" if out_dtype else "bfloat16, upcast",
        "A_vs_C": a_vs_c, "B_vs_C": b_vs_c,
        "mean_A_vs_C": float((got["A"][0] - got["C"][0]).abs().max()),
        "mean2_A_vs_C": float((got["A"][1] - got["C"][1]).abs().max()),
    }
    on_card = device.type == "cuda"
    for name, fn in forms.items():
        turn = itertools.cycle(pool)
        row[f"{name}_ms"] = 1e3 * marginal_call_seconds(lambda: fn(next(turn)), (), 48, 12, 3)
        row[f"{name}_event_ms"] = event_ms(fn, pool) if on_card else None
        row[f"{name}_device_ms"] = device_ms(fn, pool) if on_card else None
    row["C_calls"] = calls["C"]
    return row


def instance_norm_inputs(batch: int, dtype: torch.dtype, device) -> list[tuple[tuple, str]]:
    """(shape, layout) of the input of each InstanceNorm of a full-width
    generator's forward (models/networks.py, 64x64 RGBA in), in order:
    the statistics a training step computes, once each (one generator
    forward a step; the discriminator has no InstanceNorm). The layout is
    "nchw", "nhwc" or "other" (neither), as the device's convolutions left
    it. The weights are left uninitialized: only shapes and strides count."""
    from .models.networks import InstanceNorm, UnetGenerator

    generator = UnetGenerator(dtype=dtype).to(device)
    seen = []

    def record(module, args):
        x = args[0]
        try:
            order = moments_ops.layout(x)
        except ValueError:
            order = "other"
        seen.append((tuple(x.shape), order))

    hooks = [m.register_forward_pre_hook(record) for m in generator.modules()
             if isinstance(m, InstanceNorm)]
    try:
        with torch.no_grad():
            generator(torch.zeros((batch, 64, 64, 4), device=device), deterministic=True)
    finally:
        for hook in hooks:
            hook.remove()
    return seen


def parse_shape(text: str) -> tuple[int, int, int, int]:
    shape = tuple(int(v) for v in text.split(","))
    if len(shape) != 4 or min(shape) < 1:
        raise argparse.ArgumentTypeError(f"a shape is B,C,H,W of positive integers, got {text!r}")
    return shape


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default: the kernel) or cpu (the plain path)")
    parser.add_argument("--shape", type=parse_shape, action="append",
                        help="B,C,H,W (repeatable); default the four decoder shapes")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bench_in_stats: PyTorch sees no CUDA device (--device cpu runs "
                             "the plain path)")
        print(card_line(), flush=True)
    else:
        print(f"{device}: no card, the plain path", flush=True)
    for shape in args.shape or SHAPES:
        for layout in LAYOUTS:
            print(json.dumps(ab_row(shape, layout, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
