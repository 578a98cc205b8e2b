"""Import a trained reference checkpoint (``model.pt``) as an artifact of the
port.

Counterpart of ``sept_tpu/cli/import_torch.py``.  The reference's training
outputs are torch state_dicts; this entry point writes one into the port's
artifact layout (``<output_dir>/<artifact>/fold<k>/state_dict.pt`` and
``manifest_fold<k>.json``, :mod:`sept_tpu_torch.train.checkpoint`), so the
sweep, serving and cloak training consume it directly.  Artifact names must
match what the consumers resolve (``cli/train_baseline.py::artifact_name``,
``cli/train_cloak.py::cloak_artifact``):

    python -m sept_tpu_torch.cli.import_torch --checkpoint .../emotion/model.pt \\
        --output_dir out --artifact baseline_emotion --fold 1 --pred emotion
    # a trained cloak: noise + frozen backbone [+ GRL gender branch] are
    # detected from the keys and saved under the cloaked models' prefixes
    python -m sept_tpu_torch.cli.import_torch --checkpoint .../cloak/model.pt \\
        --output_dir out --artifact cloak_grl_lamda1.0_supp0 --fold 1

The backbone keeps the reference's keys less its dead tensors, with each RNN
gate's two biases folded into one as the JAX package folds them
(:mod:`sept_tpu_torch.compat.torch_io`).  The manifest's ``config`` (the
keys ``load_predictor`` reads) is inferred from the tensors.  No device is
needed.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np


def infer_config(backbone_sd, cloak_sd, *, pred: str, att: Optional[str], rnn_cell: str,
                 win_len: int) -> dict:
    """The manifest ``config`` of an imported reference checkpoint, read off
    its tensors (the JAX package's import_torch CLI): hidden and feature
    sizes, the deep model from ``conv.15.weight``, the window length from
    the cloak's ``locs`` (else ``win_len``), and ``global_feature`` where
    ``dense1`` takes the pooled width plus 88."""
    hidden = int(backbone_sd["rnn.weight_hh_l0"].shape[1])
    deep = "conv.15.weight" in backbone_sd
    if cloak_sd is not None:
        win_len = int(np.asarray(cloak_sd["locs"]).shape[-2])
    # the deep model flattens the RNN sequence: its width follows the
    # trained window length
    pooled = 2 * hidden * (win_len // 8 if deep else 1)
    return {
        "model_type": "deep-2d-cnn-lstm" if deep else "2d-cnn-lstm",
        "pred": pred if cloak_sd is None else "emotion",
        "hidden_size": hidden,
        "feature_len": int(backbone_sd["rnn.weight_ih_l0"].shape[1]) * 8 // 128,
        "win_len": win_len,
        "att": att,
        "attention_size": (int(backbone_sd["att_linear1.weight"].shape[0]) if att else 128),
        "rnn_cell": rnn_cell,
        "global_feature": int(backbone_sd["dense1.weight"].shape[1]) == pooled + 88,
    }


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True,
                   help="path to a reference model.pt state_dict")
    p.add_argument("--output_dir", required=True,
                   help="artifact root (the consumers' --output_dir)")
    p.add_argument("--artifact", required=True,
                   help="artifact name to write (e.g. baseline_emotion, "
                   "adv_baseline_gender, cloak_grl_lamda1.0_supp0)")
    p.add_argument("--fold", type=int, default=1)
    p.add_argument("--pred", choices=("emotion", "gender", "multitask"), default="emotion",
                   help="head(s) the model was trained with (bare backbones; "
                   "cloak wrappers always map emotion [+ gender branch])")
    p.add_argument("--att", choices=("none", "self_att"), default="none")
    p.add_argument("--rnn_cell", choices=("gru", "lstm"), default="gru",
                   help="lstm for the deep_two_d_cnn_lstm_tmp variant")
    p.add_argument("--win_len", type=int, default=200,
                   help="window length the model was trained on (recorded in the "
                   "manifest for predict/serve; cloak imports infer it from the "
                   "noise tensors instead)")
    args = p.parse_args(argv)

    from sept_tpu_torch.compat.torch_io import (import_backbone, import_cloak_noise,
                                                load_torch_checkpoint,
                                                split_reference_state_dict)
    from sept_tpu_torch.train.checkpoint import CheckpointManager

    att = None if args.att == "none" else args.att
    sd = load_torch_checkpoint(args.checkpoint)
    backbone_sd, cloak_sd, gender_sd = split_reference_state_dict(sd)
    bb = import_backbone(backbone_sd, pred=args.pred, att=att, rnn_cell=args.rnn_cell)
    if cloak_sd is None:
        kind, state = "backbone", bb
    else:
        state = {f"noise.{k}": v for k, v in import_cloak_noise(cloak_sd).items()}
        if gender_sd is None:
            kind = "cloak"
            state.update({f"backbone.{k}": v for k, v in bb.items()})
        else:
            kind = "cloak_grl"
            gb = import_backbone(gender_sd, pred="gender", att=att, rnn_cell=args.rnn_cell)
            state.update({f"emotion_backbone.{k}": v for k, v in bb.items()})
            state.update({f"gender_backbone.{k}": v for k, v in gb.items()})
    config = infer_config(backbone_sd, cloak_sd, pred=args.pred, att=att,
                          rnn_cell=args.rnn_cell, win_len=args.win_len)
    path = CheckpointManager(args.output_dir).save(args.artifact, args.fold, state, manifest={
        "imported_from": args.checkpoint,
        "source_format": f"reference torch state_dict ({kind})",
        "config": config,
    })
    print(f"imported {kind} -> {path} (config: {json.dumps(config)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
