"""Evaluation: FID on the card and the L1 report of every variant."""

from .fid import (
    FidEvaluator,
    frechet_distance,
    frechet_distance_lowrank,
    frechet_distance_scipy,
    sqrtm_newton_schulz,
)
from .metrics import (
    evaluate_l1,
    generate_split,
    generate_split_indexed,
    generate_split_rgba,
    report_l1,
)

__all__ = [
    "FidEvaluator",
    "frechet_distance",
    "frechet_distance_lowrank",
    "frechet_distance_scipy",
    "sqrtm_newton_schulz",
    "evaluate_l1",
    "generate_split",
    "generate_split_indexed",
    "generate_split_rgba",
    "report_l1",
]
