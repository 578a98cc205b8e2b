"""Export an artifact of the port as a reference checkpoint (``model.pt``).

Counterpart of ``sept_tpu/cli/export_torch.py`` and the inverse of
``cli.import_torch``: a trained artifact (baseline backbone, or cloak /
cloak + GRL composite) becomes a torch state_dict that strict-loads into
the matching reference constructor (``two_d_cnn_lstm`` family /
``two_d_cnn_lstm_syn[_with_grl]``) and reproduces the port's forward.

    python -m sept_tpu_torch.cli.export_torch --output_dir out \\
        --artifact baseline_emotion --fold 1 --out model.pt

The wrapper kind is read off the stored keys (a bare backbone, ``noise`` +
``backbone``, or ``noise`` + ``emotion_backbone`` + ``gender_backbone``);
the RNN biases are written canonically and the reference's dead tensors
(dense2, att_mat*, the unused head, att_linear* for models without
attention) are synthesized at its init shapes
(:mod:`sept_tpu_torch.compat.torch_io`).  No device is needed.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--output_dir", required=True, help="artifact root")
    p.add_argument("--artifact", required=True)
    p.add_argument("--fold", type=int, default=1)
    p.add_argument("--out", required=True, help="model.pt path to write")
    p.add_argument("--rnn_cell", choices=("gru", "lstm"), default="gru",
                   help="the artifact's RNN cell (checked against its tensors)")
    p.add_argument("--attention_size", type=int, default=256,
                   help="size of the synthesized dead att tensors when the model "
                   "was trained without attention (reference default)")
    args = p.parse_args(argv)

    import torch

    from sept_tpu_torch.compat.torch_io import export_backbone, export_cloak_noise, rnn_cell_of
    from sept_tpu_torch.train.checkpoint import CheckpointManager

    state = CheckpointManager(args.output_dir).restore(args.artifact, args.fold, "cpu")

    def part(prefix):
        return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}

    def backbone(sd):
        if rnn_cell_of(sd) != args.rnn_cell:
            raise ValueError(f"--rnn_cell {args.rnn_cell}, but {args.artifact}'s RNN is "
                             f"{rnn_cell_of(sd)!r}")
        return export_backbone(sd, attention_size=args.attention_size)

    if "noise.locs" in state and any(k.startswith("backbone.") for k in state):
        kind = "cloak (two_d_cnn_lstm_syn)"
        sd = {f"intermed.{k}": v for k, v in export_cloak_noise(part("noise.")).items()}
        sd.update({f"original_model.{k}": v for k, v in backbone(part("backbone.")).items()})
    elif "noise.locs" in state and any(k.startswith("emotion_backbone.") for k in state):
        kind = "cloak+GRL (two_d_cnn_lstm_syn_with_grl)"
        sd = {f"intermed.{k}": v for k, v in export_cloak_noise(part("noise.")).items()}
        sd.update({f"original_model.{k}": v
                   for k, v in backbone(part("emotion_backbone.")).items()})
        for k, v in backbone(part("gender_backbone.")).items():
            # redo the Sequential(GradientReversal, conv) nesting
            gk = k.replace("conv.", "conv.1.") if k.startswith("conv.") else k
            sd[f"gender_model.{gk}"] = v
    else:
        kind = "backbone (two_d_cnn_lstm family)"
        sd = backbone(state)
    torch.save(sd, args.out)
    print(f"exported {kind} -> {args.out} ({len(sd)} tensors)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
