"""Configuration of the port: the frozen `Config`, the dataset constants,
and what the port accepts.

`Config` has the fields, defaults, validation and properties of the JAX
package's `palette_and_histo_gan_tpu/config.py`, so that one set of keyword
arguments builds both configurations (the parity tests do so). The port
owns this copy and imports nothing of the JAX package.

The histogram knobs mean what they mean in the JAX step:
`histogram_impl` "xla" (plain PyTorch forward), "pallas" (kernels K3a/K4a,
float32 chain) or "pallas2" (kernels K3b/K4b, chain in the compute dtype);
under "xla" only, `histogram_bwd` "tri" (plain PyTorch) or "pallas"
(kernel K4c). The JAX step ignores `histogram_bwd` under "pallas" and
"pallas2", and so does the port.

Knobs the port does not implement raise `NotImplementedError` in
`check_supported`: `histogram_bwd` "dual", "tri2", "tri2b", "tri2c" under
`histogram_impl="xla"`, XLA dot-structure alternatives of the "tri"
backward measured on the TPU and not ported.

`data_parallel` chooses data parallelism over torch.distributed
(parallel/, train/trainer.py::data_group): "auto" when a process group of
more than one rank exists or torchrun's WORLD_SIZE is above 1, "on"
always (a world of one included), "off" never. `batch_size` is the global
batch.

Knobs that only choose a TPU lowering of the same function, and that the
port ignores: `transpose_impl`, `head_conv`, `infer_head_conv`,
`d_input_split`, `dropout_prng`, `xla_compiler_options`, `donate_state`,
`data_axis` (the port's data-parallel group has one axis). `augment_impl`
"xla" asks for the plain augmentation, which the port runs only on CPU
tensors; a CUDA batch always goes through the kernel, and
`check_supported` rejects "xla" for a CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import Tuple

import torch

SEED = 47

DIRECTIONS = ("back", "left", "front", "right")
DIRECTION_FRONT = 2
DIRECTION_RIGHT = 3
DIRECTION_FOLDERS = tuple(f"{i}-{name}" for i, name in enumerate(DIRECTIONS))

DATASET_SIZES = (294,)
TRAIN_PERCENTAGE = 0.85

BATCH_SIZE = 4
IMG_SIZE = 64
INPUT_CHANNELS = 4
OUTPUT_CHANNELS = 4

MAX_PALETTE_SIZE = 256
# hotpink filler of the unused palette slots
INVALID_INDEX_COLOR = (255, 0, 220, 255)

TEMP_FOLDER = "temp-side2side"

MODEL_VARIANTS = ("baseline-no-aug", "baseline", "indexed", "histogram")
PALETTE_ORDERINGS = ("top2bottom", "bottom2top", "grayness", "shuffled")

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the histogram backwards the port runs under histogram_impl="xla"
HISTOGRAM_BWDS = ("tri", "pallas")


def default_data_root() -> str:
    """$PHG_DATA_ROOT, else datasets/rpg-maker-xp at the repository root."""
    env = os.environ.get("PHG_DATA_ROOT")
    if env:
        return env
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(here, "datasets", "rpg-maker-xp")


@dataclasses.dataclass(frozen=True)
class Config:
    """All knobs of the reference experiments, with the JAX package's
    names and defaults.

    Reference hyperparameters:
      - baseline (no aug.) / baseline: lambda_l1=100
      - histogram:                     lambda_l1=30,  lambda_histogram=1
      - indexed:                       lambda_segmentation=0.01 (lambda_l1=0)
    """

    model: str = "baseline-no-aug"  # one of MODEL_VARIANTS
    source_direction: int = DIRECTION_FRONT
    target_direction: int = DIRECTION_RIGHT
    palette_ordering: str = "grayness"  # for the indexed variant

    # losses
    lambda_l1: float = 100.0
    lambda_histogram: float = 1.0
    lambda_segmentation: float = 0.01

    # optimizer (keras Adam, eps 1e-7)
    learning_rate: float = 2e-4
    beta1: float = 0.5
    beta2: float = 0.999
    adam_eps: float = 1e-7

    # schedule
    epochs: int = 160
    batch_size: int = BATCH_SIZE
    seed: int = SEED

    # data
    img_size: int = IMG_SIZE
    input_channels: int = INPUT_CHANNELS
    output_channels: int = OUTPUT_CHANNELS
    augment_probability: float = 0.8
    data_root: str = dataclasses.field(default_factory=default_data_root)
    # several dataset roots, concatenated in global-index order; empty means
    # (data_root,). dataset_sizes aligns 1:1 with the roots; each root splits
    # ceil(0.85 * n) / the rest into train / test.
    data_roots: Tuple[str, ...] = ()
    dataset_sizes: Tuple[int, ...] = DATASET_SIZES

    # histogram loss
    histogram_size: int = 64
    histogram_method: str = "inverse-quadratic"
    histogram_sigma: float = 0.02
    histogram_bwd: str = "tri"
    # TPU lowering knobs: validated as in the JAX package, ignored here
    xla_compiler_options: tuple = (("xla_tpu_scoped_vmem_limit_kib", "40960"),)
    head_conv: str = "swapgrad"
    infer_head_conv: str = "train"
    d_input_split: bool = False
    histogram_impl: str = "xla"
    augment_impl: str = "auto"

    # network widths; narrow overrides keep the same topology
    down_filters: Tuple[int, ...] = (64, 128, 256, 512, 512, 512)
    up_filters: Tuple[int, ...] = (512, 512, 256, 128, 64, 32)

    compute_dtype: str = "float32"  # "float32" or "bfloat16"
    transpose_impl: str = "lax_flipgrad"
    dropout_prng: str = "rbg"
    # parity hook: the generator's dropout is the identity in the train
    # steps (dropout streams cannot be matched across frameworks)
    deterministic_dropout: bool = False
    data_axis: str = "data"
    data_parallel: str = "auto"
    donate_state: bool = True

    # bookkeeping
    temp_folder: str = TEMP_FOLDER

    def __post_init__(self):
        """Fail at construction, not deep inside a step."""
        _check = {
            "model": (self.model, MODEL_VARIANTS),
            "palette_ordering": (self.palette_ordering, PALETTE_ORDERINGS),
            "histogram_method": (self.histogram_method, ("RBF", "inverse-quadratic")),
            "histogram_bwd": (
                self.histogram_bwd, ("tri", "dual", "tri2", "tri2b", "tri2c", "pallas"),
            ),
            "histogram_impl": (self.histogram_impl, ("xla", "pallas", "pallas2")),
            "augment_impl": (self.augment_impl, ("auto", "xla", "pallas")),
            "transpose_impl": (self.transpose_impl, ("lax", "lax_flipgrad", "subpixel")),
            "head_conv": (self.head_conv, ("swapgrad", "narrow", "dup8", "nchw")),
            "infer_head_conv": (self.infer_head_conv, ("train", "nchw")),
            "compute_dtype": (self.compute_dtype, ("float32", "bfloat16")),
            "data_parallel": (self.data_parallel, ("auto", "on", "off")),
            "dropout_prng": (self.dropout_prng, ("threefry", "rbg")),
        }
        for field, (value, valid) in _check.items():
            if value not in valid:
                raise ValueError(f"config.{field}={value!r}; valid: {valid}")
        for field in ("source_direction", "target_direction"):
            if getattr(self, field) not in range(len(DIRECTIONS)):
                raise ValueError(
                    f"config.{field}={getattr(self, field)!r}; valid: 0-3 "
                    f"({', '.join(DIRECTIONS)})"
                )
        if len(self.effective_data_roots) != len(self.dataset_sizes):
            raise ValueError(
                f"data roots ({len(self.effective_data_roots)}: "
                f"{self.effective_data_roots}) and dataset_sizes "
                f"({len(self.dataset_sizes)}: {self.dataset_sizes}) must "
                "align 1:1; pass --data-roots/--dataset-sizes together"
            )
        if any(n < 1 for n in self.dataset_sizes):
            raise ValueError(f"dataset_sizes entries must be >= 1, got {self.dataset_sizes}")
        if self.batch_size < 1 or self.epochs < 1:
            raise ValueError(
                f"batch_size ({self.batch_size}) and epochs ({self.epochs}) must be >= 1"
            )
        if len(self.down_filters) != len(self.up_filters):
            raise ValueError(
                f"down_filters ({len(self.down_filters)}) and up_filters "
                f"({len(self.up_filters)}) must have the same depth"
            )

    @property
    def architecture_name(self) -> str:
        return f"{DIRECTIONS[self.source_direction]}-to-{DIRECTIONS[self.target_direction]}"

    @property
    def effective_data_roots(self) -> Tuple[str, ...]:
        return self.data_roots if self.data_roots else (self.data_root,)

    @property
    def train_sizes(self) -> Tuple[int, ...]:
        """Per-dataset train sizes, ceil(0.85 * n)."""
        return tuple(math.ceil(n * TRAIN_PERCENTAGE) for n in self.dataset_sizes)

    @property
    def test_sizes(self) -> Tuple[int, ...]:
        return tuple(n - t for n, t in zip(self.dataset_sizes, self.train_sizes))

    @property
    def train_size(self) -> int:
        return sum(self.train_sizes)

    @property
    def steps(self) -> int:
        """ceil(train_size / batch) * epochs."""
        return math.ceil(self.train_size / self.batch_size) * self.epochs

    @property
    def update_steps(self) -> int:
        return max(self.steps // 40, 1)

    @property
    def is_indexed(self) -> bool:
        return self.model == "indexed"

    @property
    def generator_in_channels(self) -> int:
        return 1 if self.is_indexed else self.input_channels

    @property
    def generator_out_channels(self) -> int:
        return MAX_PALETTE_SIZE if self.is_indexed else self.output_channels

    @property
    def generator_last_activation(self) -> str:
        return "softmax" if self.is_indexed else "tanh"

    @property
    def discriminator_in_channels(self) -> int:
        return 1 if self.is_indexed else self.input_channels

    @property
    def effective_lambda_l1(self) -> float:
        # the indexed variant forces lambda_l1 to 0
        return 0.0 if self.is_indexed else self.lambda_l1

    @property
    def uses_augmentation(self) -> bool:
        return self.model in ("baseline", "histogram")

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def config_for_variant(variant: str, **overrides) -> Config:
    """The per-variant configuration of the reference experiments."""
    if variant not in MODEL_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; use one of {MODEL_VARIANTS}")
    base = dict(model=variant)
    if variant == "histogram":
        base["lambda_l1"] = 30.0
        base["lambda_histogram"] = 1.0
    elif variant == "indexed":
        base["lambda_segmentation"] = 0.01
    else:
        base["lambda_l1"] = 100.0
    base.update(overrides)
    return Config(**base)


def check_supported(config: Config, device: torch.device | str) -> None:
    """Raise NotImplementedError for a configuration the port cannot run."""
    device = torch.device(device)
    if config.histogram_impl == "xla" and config.histogram_bwd not in HISTOGRAM_BWDS:
        raise NotImplementedError(
            f"histogram_bwd={config.histogram_bwd!r}: an XLA dot-structure "
            f"alternative the port does not run; it has {HISTOGRAM_BWDS}"
        )
    if device.type == "cuda" and config.augment_impl == "xla":
        raise ValueError(
            "augment_impl='xla' asks for the plain augmentation, which serves "
            "CPU tensors only; on a CUDA device the port runs the kernel "
            "(use 'auto' or 'pallas')"
        )


def compute_dtype(config: Config) -> torch.dtype:
    return DTYPES[config.compute_dtype]


def set_f32_parity_mode() -> None:
    """Pin float32 products to full float32: TF32 off for cuDNN
    convolutions and for cuBLAS matmuls (PyTorch's cuDNN default is TF32,
    about three decimal digits)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@contextlib.contextmanager
def float32_exact():
    """`set_f32_parity_mode` inside the scope only: TF32 off for cuDNN
    convolutions and cuBLAS matmuls, whatever the caller set; the caller's
    settings come back after it. Every entry point runs its float32 work
    under it (the Trainer, FID, serving, the weight converter's check)."""
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    matmul_precision = torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        torch.set_float32_matmul_precision(matmul_precision)


def set_deterministic_mode() -> None:
    """Pin cuDNN to deterministic algorithms, chosen without benchmarking,
    for runs that must repeat bit for bit on the card (a resumed run
    against the uninterrupted one). Callers opt in; the package does not
    set it."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
