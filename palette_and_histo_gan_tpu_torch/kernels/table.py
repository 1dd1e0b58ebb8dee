"""Every TPU kernel of the repository and its counterpart in the port.

One row per place where the repository's JAX code calls
`pl.pallas_call` (`tests/test_torch_kernel_table.py` scans the repository
and holds this table to the calls it finds): the call's site, the
function that reaches it, the Pallas kernel body it runs, and the port's
CUDA source and the wrapper that launches it. Paths are relative to the
repository root; `chip_smoke.py` reports each kernel's `replaces` from
here.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Kernel:
    name: str  # the port's name for it, as in PERF.md and the launch counts
    site: str  # "file:line" of the pl.pallas_call
    reaches: str  # the function around that call
    body: str  # "file:line" of the Pallas kernel body the call runs
    source: str  # the port's CUDA source
    entry: str  # "module::function" of the port's wrapper that launches it


_JAX = "palette_and_histo_gan_tpu/ops/"
_PORT = "palette_and_histo_gan_tpu_torch/"

KERNELS = (
    Kernel("K1", _JAX + "augment_pallas.py:354", "_call_kernel_packed",
           _JAX + "augment_pallas.py:273", _PORT + "csrc/augment.cu",
           "ops/augment_kernel.py::augment_cuda"),
    Kernel("K2", _JAX + "augment_pallas.py:196", "_call_kernel",
           _JAX + "augment_pallas.py:119", _PORT + "csrc/augment.cu",
           "ops/augment_kernel.py::augment_cuda"),
    Kernel("K3a", _JAX + "histogram_pallas.py:107", "_forward_unnormalized",
           _JAX + "histogram_pallas.py:76", _PORT + "csrc/histogram.cu",
           "ops/histogram_kernel.py::histogram_forward_cuda"),
    Kernel("K3b", _JAX + "histogram_pallas2.py:83", "_forward_unnormalized",
           _JAX + "histogram_pallas2.py:42", _PORT + "csrc/histogram.cu",
           "ops/histogram_kernel.py::histogram_forward_cuda"),
    Kernel("K4a", _JAX + "histogram_pallas.py:197", "_backward_unnormalized",
           _JAX + "histogram_pallas.py:125", _PORT + "csrc/histogram.cu",
           "ops/histogram_kernel.py::histogram_backward_cuda"),
    Kernel("K4b", _JAX + "histogram_pallas2.py:183", "_backward_unnormalized",
           _JAX + "histogram_pallas2.py:99", _PORT + "csrc/histogram.cu",
           "ops/histogram_kernel.py::histogram_backward_cuda"),
    Kernel("K4c", _JAX + "histogram_pallas3.py:166", "backward_unnormalized_pallas3",
           _JAX + "histogram_pallas3.py:63", _PORT + "csrc/histogram.cu",
           "ops/histogram_kernel.py::histogram_backward_cuda"),
    Kernel("K5", _JAX + "palette_pallas.py:49", "rgba_to_indexed_pallas",
           _JAX + "palette_pallas.py:26", _PORT + "csrc/palette.cu",
           "ops/palette_kernel.py::rgba_to_indexed_cuda"),
    Kernel("K6", "scripts/bench_in_stats.py:63", "stats_pallas",
           "scripts/bench_in_stats.py:50", _PORT + "csrc/moments.cu",
           "ops/moments.py::moments_cuda"),
)

BY_NAME = {k.name: k for k in KERNELS}
