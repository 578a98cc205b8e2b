"""Carry trained JAX weights over to the port's state_dicts.

Takes the JAX package's trees as nested dicts of numpy arrays (``params``,
``batch_stats``) and returns torch state_dicts that strict-load into the
port's models (:mod:`sept_tpu_torch.models`) and
:class:`sept_tpu_torch.models.CloakNoise`.  For the 2-D CNN + RNN family
the mapping restates ``sept_tpu/compat/torch_import.py``'s export direction
(``export_backbone``, ``_gru_layer_out``, ``_lstm_layer_out``,
``export_cloak_noise``) without importing it:

- ``conv{b}/kernel`` (5, 5, in, out) -> ``conv.{0,5,10,15}.weight`` (out,
  in, 5, 5); ``bn{b}`` scale/bias and the running mean/var, copied
  verbatim, -> ``conv.{1,6,11,16}.*`` (block 3 is the deep model's);
- each flax ``GRUCell_{k}`` (forward then backward per layer) ->
  ``rnn.{weight,bias}_{ih,hh}_l{L}[_reverse]`` with gate rows r, z, n.  The
  flax cell has one bias for r and for z (torch only uses the sum of its
  pair), so those go wholly into ``bias_ih`` and ``bias_hh[r, z] = 0``;
- each ``OptimizedLSTMCell_{k}`` likewise with gate rows i, f, g, o: flax's
  input Dense layers ``i*`` have no bias, its hidden ones ``h*`` one, so
  ``bias_hh`` takes it and ``bias_ih = 0``;
- Dense kernels (in, out) -> Linear weights (out, in).

Only the tensors the port's modules declare are emitted: the reference's
dead ``dense2`` / ``att_mat*`` and unused heads are not.

``OneDConvNet`` and ``PlainConv2d`` have no reference names cited in the
JAX package, so their state_dicts keep JAX's parameter names, torch
layouts: ``Conv_{0,1,2}`` (Conv1d, (out, in, 5)), ``att_linear{1,2}``
(with biases), ``classifier``; ``conv{0..5}`` (Conv2d, (out, in, 3, 3)),
``bn{1,3,5}``, ``w1`` / ``w2`` (as they are).  Their heads take the 2-D
family's reference names ``pred_emotion_layer`` / ``pred_gender_layer``,
so that the zoo shares one head.  :func:`backbone_state_dict` tells the
types apart by their trees.

The cloaked models' trees (``CloakedModel``: ``noise``, ``backbone``;
``CloakedModelGRL``: ``noise``, ``emotion_backbone``, ``gender_backbone``)
map submodule by submodule.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

__all__ = ["backbone_state_dict", "cloak_noise_state_dict", "cloaked_state_dict",
           "cloaked_grl_state_dict"]

_CONV_IDX = (0, 5, 10, 15)
_BN_IDX = (1, 6, 11, 16)
_HEADS = (("pred_emotion", "pred_emotion_layer"), ("pred_gender", "pred_gender_layer"))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C", copy=True))  # owned, writable


def _gru_direction(cell: Dict[str, Any]) -> Dict[str, np.ndarray]:
    k = lambda n: np.asarray(cell[n]["kernel"]).T  # noqa: E731
    h = k("hr").shape[0]
    zeros = np.zeros(h, np.float32)
    return {
        "weight_ih": np.concatenate([k("ir"), k("iz"), k("in")], axis=0),
        "weight_hh": np.concatenate([k("hr"), k("hz"), k("hn")], axis=0),
        "bias_ih": np.concatenate([np.asarray(cell[g]["bias"])
                                   for g in ("ir", "iz", "in")]),
        "bias_hh": np.concatenate([zeros, zeros, np.asarray(cell["hn"]["bias"])]),
    }


def _lstm_direction(cell: Dict[str, Any]) -> Dict[str, np.ndarray]:
    k = lambda n: np.asarray(cell[n]["kernel"]).T  # noqa: E731
    h = k("hi").shape[0]
    return {
        "weight_ih": np.concatenate([k(f"i{g}") for g in "ifgo"], axis=0),
        "weight_hh": np.concatenate([k(f"h{g}") for g in "ifgo"], axis=0),
        "bias_ih": np.zeros(4 * h, np.float32),
        "bias_hh": np.concatenate([np.asarray(cell[f"h{g}"]["bias"]) for g in "ifgo"]),
    }


def _bn(sd, name, params, batch_stats, theirs):
    sd[f"{name}.weight"] = _t(params[theirs]["scale"])
    sd[f"{name}.bias"] = _t(params[theirs]["bias"])
    sd[f"{name}.running_mean"] = _t(batch_stats[theirs]["mean"])
    sd[f"{name}.running_var"] = _t(batch_stats[theirs]["var"])
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _dense(sd, name, tree, bias=True):
    sd[f"{name}.weight"] = _t(np.asarray(tree["kernel"]).T)
    if bias:
        sd[f"{name}.bias"] = _t(tree["bias"])


def _heads(sd, tree):
    for ours, theirs in _HEADS:
        if ours in tree:
            _dense(sd, theirs, tree[ours])


def backbone_state_dict(params: Dict[str, Any],
                        batch_stats: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX backbone (params, batch_stats) -> the port's state_dict, for any
    model type: ``Conv2dBiRNN`` / ``DeepConv2dBiRNN`` (a ``rnn`` tree),
    ``OneDConvNet`` (``classifier``) or ``PlainConv2d``."""
    if "rnn" not in params:
        return (_one_d_state_dict(params) if "classifier" in params
                else _plain_state_dict(params, batch_stats))
    sd: Dict[str, torch.Tensor] = {}
    n_blocks = sum(1 for k in params if re.fullmatch(r"conv\d", k))
    for b, (ci, bi) in enumerate(zip(_CONV_IDX[:n_blocks], _BN_IDX)):
        sd[f"conv.{ci}.weight"] = _t(np.transpose(
            np.asarray(params[f"conv{b}"]["kernel"]), (3, 2, 0, 1)))
        sd[f"conv.{ci}.bias"] = _t(params[f"conv{b}"]["bias"])
        _bn(sd, f"conv.{bi}", params, batch_stats, f"bn{b}")

    cells = params["rnn"]
    order = sorted(cells, key=lambda k: int(k.rsplit("_", 1)[1]))
    direction = _lstm_direction if order[0].startswith("OptimizedLSTMCell") else _gru_direction
    for layer in range(len(order) // 2):
        for j, suffix in ((0, ""), (1, "_reverse")):
            for name, v in direction(cells[order[2 * layer + j]]).items():
                sd[f"rnn.{name}_l{layer}{suffix}"] = _t(v)

    if "att_pool" in params:
        for name in ("att_linear1", "att_linear2"):
            _dense(sd, name, params["att_pool"][name], bias=False)
    _dense(sd, "dense1", params["heads"]["dense1"])
    _heads(sd, params["heads"])
    return sd


def _one_d_state_dict(params) -> Dict[str, torch.Tensor]:
    """JAX ``OneDConvNet`` params -> the port's state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for i in range(3):
        conv = params[f"Conv_{i}"]
        sd[f"Conv_{i}.weight"] = _t(np.transpose(np.asarray(conv["kernel"]), (2, 1, 0)))
        sd[f"Conv_{i}.bias"] = _t(conv["bias"])
    if "att_pool" in params:
        for name in ("att_linear1", "att_linear2"):
            _dense(sd, name, params["att_pool"][name])
    _dense(sd, "classifier", params["classifier"])
    _heads(sd, params)
    return sd


def _plain_state_dict(params, batch_stats) -> Dict[str, torch.Tensor]:
    """JAX ``PlainConv2d`` (params, batch_stats) -> the port's state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for i in range(6):
        sd[f"conv{i}.weight"] = _t(np.transpose(np.asarray(params[f"conv{i}"]["kernel"]),
                                                (3, 2, 0, 1)))
        sd[f"conv{i}.bias"] = _t(params[f"conv{i}"]["bias"])
        if f"bn{i}" in params:
            _bn(sd, f"bn{i}", params, batch_stats, f"bn{i}")
    for w in ("w1", "w2"):
        if w in params:
            sd[w] = _t(params[w])
    return sd


def cloak_noise_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``CloakNoise`` params {locs, rhos} (win, feats) -> the port's
    state_dict, with the reference's leading broadcast dim (1, win, feats)."""
    return {k: _t(np.asarray(params[k], np.float32)[None]) for k in ("locs", "rhos")}


def _cloaked(params, batch_stats, backbones) -> Dict[str, torch.Tensor]:
    sd = {f"noise.{k}": v for k, v in cloak_noise_state_dict(params["noise"]).items()}
    for name in backbones:
        sd.update({f"{name}.{k}": v for k, v in
                   backbone_state_dict(params[name], batch_stats[name]).items()})
    return sd


def cloaked_state_dict(params: Dict[str, Any],
                       batch_stats: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``CloakedModel`` (params, batch_stats) -> the port's
    ``CloakedModel`` state_dict."""
    return _cloaked(params, batch_stats, ("backbone",))


def cloaked_grl_state_dict(params: Dict[str, Any],
                           batch_stats: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``CloakedModelGRL`` (params, batch_stats) -> the port's
    ``CloakedModelGRL`` state_dict."""
    return _cloaked(params, batch_stats, ("emotion_backbone", "gender_backbone"))
