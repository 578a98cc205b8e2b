"""Reference checkpoints (``model.pt``) in and out of the port's artifacts.

Counterpart of the reference-facing half of
``sept_tpu/compat/torch_import.py``.  The reference saves
``model.state_dict()`` as ``model.pt`` for every artifact: a
``two_d_cnn_lstm``-family backbone, or a cloak wrapper
(``two_d_cnn_lstm_syn``: ``intermed.*`` + ``original_model.*``; with GRL
also ``gender_model.*``, its conv stack nested one level deeper by
``Sequential(GradientReversal, conv)``).  The port's backbones already use
the reference's key layout (:mod:`sept_tpu_torch.models.backbone`), so
import and export are key filtering, the canonical RNN biases and the
dead tensors:

- import keeps what the port's modules declare: the conv blocks (a fourth,
  ``conv.15`` / ``conv.16``, selects the deep model), the RNN, ``dense1``,
  the head(s) of ``pred`` and ``att_linear*`` for attention models; it drops
  ``dense2``, ``att_mat*``, the unused head and, without attention,
  ``att_linear*``.  Every tensor becomes float32, ``num_batches_tracked``
  int64;
- flax's cells have one bias a gate where torch's have two, and the JAX
  package's import folds each pair into one: the GRU's r and z biases into
  ``bias_ih = b_ih + b_hh`` with ``bias_hh[r, z] = 0`` (the n gate keeps
  both), the LSTM's four into ``bias_hh = b_ih + b_hh`` with ``bias_ih =
  0``.  The port's training pins those zero rows
  (:mod:`sept_tpu_torch.models.backbone`), so the fold is not only a gauge:
  weight decay falls on the sum, as in the JAX package;
- export writes the canonical biases back and synthesizes the reference's
  dead tensors at its init shapes so that strict loading succeeds: zero
  ``dense2`` (64, 128), ``att_mat1`` / ``att_mat2``, the unused head, and
  for models without attention zero ``att_linear1`` / ``att_linear2`` sized
  by ``attention_size`` (the reference default 256); ``num_batches_tracked``
  is 0.

Only the 2-D CNN + RNN family (``2d-cnn-lstm``, ``cnn-lstm-att``,
``deep-2d-cnn-lstm``, GRU or LSTM) crosses: the JAX package maps no other
model type either.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["load_torch_checkpoint", "split_reference_state_dict", "import_backbone",
           "import_cloak_noise", "export_backbone", "export_cloak_noise", "rnn_cell_of"]

_BLOCKS = ((0, 1), (5, 6), (10, 11), (15, 16))  # (conv, BatchNorm) Sequential indices
_HEADS = {"emotion": ("pred_emotion_layer",), "gender": ("pred_gender_layer",),
          "multitask": ("pred_emotion_layer", "pred_gender_layer")}
_HEAD_CLASSES = {"pred_emotion_layer": 4, "pred_gender_layer": 2}


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """``torch.load`` a ``model.pt`` state_dict to a numpy dict (CPU)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach().cpu().numpy() for k, v in sd.items() if hasattr(v, "detach")}


def split_reference_state_dict(sd: Dict[str, np.ndarray]) -> Tuple[
        Dict[str, np.ndarray], Optional[Dict[str, np.ndarray]],
        Optional[Dict[str, np.ndarray]]]:
    """Split a reference state_dict into (backbone, cloak, gender) parts,
    keyed in bare-model terms; cloak and gender are None when absent.  A
    ``module.`` DataParallel prefix is stripped first, and the gender
    branch's ``conv.1.<i>`` nesting undone."""
    sd = {re.sub(r"^module\.", "", k): v for k, v in sd.items()}
    cloak = {k.split(".", 1)[1]: v for k, v in sd.items() if k.startswith("intermed.")} or None
    g = {k.split(".", 1)[1]: v for k, v in sd.items() if k.startswith("gender_model.")}
    # the GRL (index 0 of the Sequential) has no tensors; the conv stack is 1
    gender = {re.sub(r"^conv\.1\.", "conv.", k): v for k, v in g.items()} or None
    backbone = {k.split(".", 1)[1]: v for k, v in sd.items()
                if k.startswith("original_model.")}
    if not backbone:
        backbone = {k: v for k, v in sd.items()
                    if not k.startswith(("intermed.", "gender_model."))}
    return backbone, cloak, gender


def rnn_cell_of(sd) -> str:
    """"gru" or "lstm", from the gate rows of ``rnn.weight_hh_l0``."""
    if "rnn.weight_hh_l0" not in sd:
        raise ValueError("not a two_d_cnn_lstm-family state_dict (no rnn.weight_hh_l0): "
                         "only that family is exchanged with the reference")
    w = sd["rnn.weight_hh_l0"]
    return {3: "gru", 4: "lstm"}[w.shape[0] // w.shape[1]]


def _fold_biases(b_ih, b_hh, rnn_cell: str):
    """Torch's two biases of a gate -> flax's one, in torch's canonical
    place: GRU r, z in ``bias_ih`` (n keeps both), LSTM all in ``bias_hh``."""
    h = b_hh.shape[0] // (3 if rnn_cell == "gru" else 4)
    if rnn_cell == "gru":
        rz = slice(0, 2 * h)
        b_ih, b_hh = b_ih.copy(), b_hh.copy()
        b_ih[rz] = b_ih[rz] + b_hh[rz]
        b_hh[rz] = 0.0
        return b_ih, b_hh
    return np.zeros_like(b_ih), b_ih + b_hh


def import_backbone(sd: Dict[str, np.ndarray], *, pred: str = "emotion",
                    att: Optional[str] = None, rnn_cell: str = "gru") -> Dict[str, torch.Tensor]:
    """Reference backbone state_dict (numpy) -> the port's state_dict."""
    if rnn_cell_of(sd) != rnn_cell:
        raise ValueError(f"rnn_cell {rnn_cell!r}, but the checkpoint's RNN is "
                         f"{rnn_cell_of(sd)!r}")
    blocks = _BLOCKS[:4 if "conv.15.weight" in sd else 3]
    out: Dict[str, np.ndarray] = {k: v for k, v in sd.items() if k.startswith("rnn.")}
    for conv, bn in blocks:
        for name in ("weight", "bias"):
            out[f"conv.{conv}.{name}"] = sd[f"conv.{conv}.{name}"]
        for name in ("weight", "bias", "running_mean", "running_var"):
            out[f"conv.{bn}.{name}"] = sd[f"conv.{bn}.{name}"]
    for k in [k for k in out if k.startswith("rnn.bias_ih")]:
        kh = k.replace("bias_ih", "bias_hh")
        out[k], out[kh] = _fold_biases(np.asarray(sd[k], np.float32),
                                       np.asarray(sd[kh], np.float32), rnn_cell)
    names = ["dense1.weight", "dense1.bias"]
    if att == "self_att":
        names += ["att_linear1.weight", "att_linear2.weight"]
    names += [f"{h}.{p}" for h in _HEADS[pred] for p in ("weight", "bias")]
    for k in names:
        out[k] = sd[k]
    state = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}
    for _, bn in blocks:
        n = sd.get(f"conv.{bn}.num_batches_tracked", 0)
        state[f"conv.{bn}.num_batches_tracked"] = torch.tensor(int(n), dtype=torch.int64)
    return state


def import_cloak_noise(cloak_sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``intermed.{locs,rhos}`` -> the port's CloakNoise state_dict, (1,
    win_len, n_feats) float32."""
    def one(t):
        t = np.array(t, np.float32)
        return torch.from_numpy(t if t.ndim == 3 else t[None])

    return {"locs": one(cloak_sd["locs"]), "rhos": one(cloak_sd["rhos"])}


def export_backbone(state: Dict[str, torch.Tensor], *,
                    attention_size: int = 256) -> Dict[str, torch.Tensor]:
    """The port's backbone state_dict -> a reference state_dict that
    strict-loads into ``two_d_cnn_lstm`` / ``deep_two_d_cnn_lstm[_tmp]``:
    canonical RNN biases, the dead tensors synthesized (module docstring)."""
    sd = {k: v.detach().cpu().clone() for k, v in state.items()}
    cell = rnn_cell_of(sd)
    for k in [k for k in sd if k.startswith("rnn.bias_ih")]:
        kh = k.replace("bias_ih", "bias_hh")
        b_ih, b_hh = _fold_biases(sd[k].numpy(), sd[kh].numpy(), cell)
        sd[k], sd[kh] = torch.from_numpy(b_ih), torch.from_numpy(b_hh)
    for k in [k for k in sd if k.endswith("num_batches_tracked")]:
        sd[k] = torch.tensor(0, dtype=torch.int64)
    for head, n in _HEAD_CLASSES.items():
        if f"{head}.weight" not in sd:
            sd[f"{head}.weight"] = torch.zeros(n, 128)
            sd[f"{head}.bias"] = torch.zeros(n)
    sd["dense2.weight"] = torch.zeros(64, 128)
    sd["dense2.bias"] = torch.zeros(64)
    hidden2 = 2 * sd["rnn.weight_hh_l0"].shape[1]
    if "att_linear1.weight" in sd:
        attention_size = sd["att_linear1.weight"].shape[0]
    else:
        sd["att_linear1.weight"] = torch.zeros(attention_size, hidden2)
        sd["att_linear2.weight"] = torch.zeros(16, attention_size)
    sd["att_mat1"] = torch.zeros(attention_size, hidden2)
    sd["att_mat2"] = torch.zeros(16, attention_size)
    return sd


def export_cloak_noise(noise: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's CloakNoise tensors -> the reference's ``cloak_noise``, (1,
    win_len, n_feats)."""
    return {k: noise[k].detach().cpu().to(torch.float32).reshape(
        (1,) + tuple(noise[k].shape[-2:])).clone() for k in ("locs", "rhos")}

