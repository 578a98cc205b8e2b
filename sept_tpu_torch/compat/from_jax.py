"""Carry trained JAX weights over to the port's state_dicts.

Takes the JAX package's trees as nested dicts of numpy arrays (``params``,
``batch_stats``) and returns torch state_dicts that strict-load into
:class:`sept_tpu_torch.models.Conv2dBiRNN` and
:class:`sept_tpu_torch.models.CloakNoise`.  The mapping restates
``sept_tpu/compat/torch_import.py``'s export direction (``export_backbone``,
``_gru_layer_out``, ``export_cloak_noise``) without importing it:

- ``conv{b}/kernel`` (5, 5, in, out) -> ``conv.{0,5,10}.weight`` (out, in,
  5, 5); ``bn{b}`` scale/bias and the running mean/var, copied verbatim,
  -> ``conv.{1,6,11}.*``;
- each flax ``GRUCell_{k}`` (forward then backward per layer) ->
  ``rnn.{weight,bias}_{ih,hh}_l{L}[_reverse]`` with gate rows r, z, n.  The
  flax cell has one bias for r and for z (torch only uses the sum of its
  pair), so those go wholly into ``bias_ih`` and ``bias_hh[r, z] = 0``;
- Dense kernels (in, out) -> Linear weights (out, in).

Only the tensors the port's modules declare are emitted: the reference's
dead ``dense2`` / ``att_mat*`` and unused heads are not.  The cloaked
models' trees (``CloakedModel``: ``noise``, ``backbone``;
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

_CONV_IDX = (0, 5, 10)
_BN_IDX = (1, 6, 11)


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


def backbone_state_dict(params: Dict[str, Any],
                        batch_stats: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``Conv2dBiRNN`` (params, batch_stats) -> the port's state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for b, (ci, bi) in enumerate(zip(_CONV_IDX, _BN_IDX)):
        sd[f"conv.{ci}.weight"] = _t(np.transpose(
            np.asarray(params[f"conv{b}"]["kernel"]), (3, 2, 0, 1)))
        sd[f"conv.{ci}.bias"] = _t(params[f"conv{b}"]["bias"])
        sd[f"conv.{bi}.weight"] = _t(params[f"bn{b}"]["scale"])
        sd[f"conv.{bi}.bias"] = _t(params[f"bn{b}"]["bias"])
        sd[f"conv.{bi}.running_mean"] = _t(batch_stats[f"bn{b}"]["mean"])
        sd[f"conv.{bi}.running_var"] = _t(batch_stats[f"bn{b}"]["var"])
        sd[f"conv.{bi}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)

    cells = params["rnn"]
    order = sorted(cells, key=lambda k: int(re.fullmatch(r"GRUCell_(\d+)", k).group(1)))
    for layer in range(len(order) // 2):
        for j, suffix in ((0, ""), (1, "_reverse")):
            for name, v in _gru_direction(cells[order[2 * layer + j]]).items():
                sd[f"rnn.{name}_l{layer}{suffix}"] = _t(v)

    if "att_pool" in params:
        for name in ("att_linear1", "att_linear2"):
            sd[f"{name}.weight"] = _t(np.asarray(params["att_pool"][name]["kernel"]).T)
    heads = params["heads"]
    for ours, theirs in (("dense1", "dense1"),
                         ("pred_emotion", "pred_emotion_layer"),
                         ("pred_gender", "pred_gender_layer")):
        if ours in heads:
            sd[f"{theirs}.weight"] = _t(np.asarray(heads[ours]["kernel"]).T)
            sd[f"{theirs}.bias"] = _t(heads[ours]["bias"])
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
