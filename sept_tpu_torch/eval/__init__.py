"""Evaluation of the port: metrics, the sliding-window vote and the
utility-privacy sweep."""

from sept_tpu_torch.eval.metrics import accuracy, confusion, get_class_weight, result_dict, uar
from sept_tpu_torch.eval.sliding import make_sliding_vote_fn, sliding_vote

__all__ = [
    "accuracy",
    "confusion",
    "get_class_weight",
    "make_sliding_vote_fn",
    "result_dict",
    "sliding_vote",
    "uar",
]
