"""Evaluation: L1 of the RGBA variants."""

from .metrics import evaluate_l1, generate_split_rgba, report_l1

__all__ = ["evaluate_l1", "generate_split_rgba", "report_l1"]
