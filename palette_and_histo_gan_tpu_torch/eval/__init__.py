"""Evaluation: the L1 report of every variant."""

from .metrics import (
    evaluate_l1,
    generate_split,
    generate_split_indexed,
    generate_split_rgba,
    report_l1,
)

__all__ = [
    "evaluate_l1",
    "generate_split",
    "generate_split_indexed",
    "generate_split_rgba",
    "report_l1",
]
