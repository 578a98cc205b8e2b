"""Evaluation metrics: accuracy, UAR (macro recall), confusion, class weights.

Counterpart of ``sept_tpu/eval/metrics.py``, in numpy as there (the
reference's ``training_tools.py``):

- ``ReturnResultDict`` -> :func:`result_dict`: nested
  {dataset: {acc/rec/conf/loss: {pred: value}}} with a per-corpus breakdown
  in combine mode; confusion matrices are row-normalized * 100, rounded to
  2 decimals;
- UAR (unweighted average recall / macro recall) is the paper's headline
  metric;
- ``get_class_weight`` with its doctest.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "accuracy",
    "uar",
    "confusion",
    "result_dict",
    "split_result",
    "get_class_weight",
]


def accuracy(truth: np.ndarray, pred: np.ndarray) -> float:
    truth, pred = np.asarray(truth), np.asarray(pred)
    return float(np.mean(truth == pred)) if len(truth) else 0.0


def uar(truth: np.ndarray, pred: np.ndarray) -> float:
    """Unweighted average recall = sklearn ``recall_score(average='macro')``
    (the reference metric, training_tools.py:142).

    sklearn's default label set is the sorted UNION of truth and pred: a
    class appearing only in predictions contributes recall 0 to the macro
    mean.  Averaging over truth-present classes only (the earlier behavior)
    inflated UAR whenever a model predicted a class absent from the split.
    """
    truth, pred = np.asarray(truth), np.asarray(pred)
    classes = np.unique(np.concatenate([truth, pred]))
    if len(classes) == 0:
        return 0.0
    recalls = [
        np.mean(pred[truth == c] == c) if np.any(truth == c) else 0.0
        for c in classes
    ]
    return float(np.mean(recalls))


def confusion(truth: np.ndarray, pred: np.ndarray, n_classes: int | None = None) -> np.ndarray:
    """Row-normalized confusion matrix * 100, rounded to 2 decimals
    (training_tools.py:143).  Rows/cols follow sklearn: sorted union of
    observed labels (or 0..n_classes-1 when given)."""
    truth, pred = np.asarray(truth), np.asarray(pred)
    labels = (
        np.arange(n_classes) if n_classes is not None
        else np.unique(np.concatenate([truth, pred]))
    )
    k = len(labels)
    idx = {c: i for i, c in enumerate(labels)}
    mat = np.zeros((k, k), dtype=np.float64)
    for t, p in zip(truth, pred):
        mat[idx[t], idx[p]] += 1
    rows = mat.sum(axis=1, keepdims=True)
    # deliberate deviation: sklearn's normalize='true' (what the reference
    # stores) emits NaN rows for classes absent from the truth; we emit 0.0
    # rows so confusion matrices stay JSON-serializable and comparable —
    # every populated row is identical to the reference's
    rows[rows == 0] = 1.0
    return np.round(mat / rows * 100, decimals=2)


def result_dict(
    truth: dict[str, list],
    predict: dict[str, list],
    dataset: str,
    pred: str,
    loss: float | None = None,
) -> dict:
    """The reference's nested result dict (training_tools.py:133-172)."""
    out = {}
    keys = [dataset]
    if dataset == "combine":
        keys += ["iemocap", "crema-d", "msp-improv"]
    elif dataset == "combine_two":  # training_adversary_baselines.py:53,148
        keys += ["iemocap", "crema-d"]
    for key in keys:
        t, p = np.asarray(truth[key]), np.asarray(predict[key])
        out[key] = {
            "acc": {pred: accuracy(t, p)},
            "rec": {pred: uar(t, p)},
            "conf": {pred: confusion(t, p)},
            "loss": {pred: loss},
        }
    return out


def split_result(truth: np.ndarray, pred: np.ndarray, datasets: np.ndarray,
                 rec_key: str = "rec") -> dict:
    """acc / recall / conf of one split's predictions; when ``datasets``
    holds more than one corpus tag (combine mode), a ``per_dataset``
    breakdown of acc and recall (training_tools.py:153-170).  ``rec_key``
    names the recall: ``"uar"`` in a fold's test result, ``"rec"`` in the
    sweep's."""
    truth, pred = np.asarray(truth), np.asarray(pred)
    out = {"acc": accuracy(truth, pred), rec_key: uar(truth, pred),
           "conf": confusion(truth, pred)}
    corpora = sorted(set(datasets.tolist()))
    if len(corpora) > 1:
        out["per_dataset"] = {ds: {"acc": accuracy(truth[datasets == ds], pred[datasets == ds]),
                                   rec_key: uar(truth[datasets == ds], pred[datasets == ds])}
                              for ds in corpora}
    return out


def get_class_weight(labels_dict: dict) -> dict:
    """Log-scaled inverse-frequency weights, floored at 1.0.

    >>> get_class_weight({0: 633, 1: 898, 2: 641, 3: 699, 4: 799})
    {0: 1.0, 1: 1.0, 2: 1.0, 3: 1.0, 4: 1.0}
    >>> get_class_weight({0: 5, 1: 78, 2: 2814, 3: 7914})
    {0: 7.366950709511269, 1: 4.619679795255778, 2: 1.034026384271035, 3: 1.0}
    """
    total = sum(labels_dict.values())
    max_num = max(labels_dict.values())
    mu = 1.0 / (total / max_num)
    out = {}
    for key, value in labels_dict.items():
        score = math.log(mu * total / float(value))
        out[key] = score if score > 1.0 else 1.0
    return out
