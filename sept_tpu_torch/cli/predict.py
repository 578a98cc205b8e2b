"""CLI: offline batch inference — a directory of WAVs in, a CSV out.

    python -m sept_tpu_torch.cli.predict --output_dir results \\
        --artifact baseline_emotion --fold 1 \\
        --wav_dir /data/clips --out predictions.csv --device cuda

    # or walk a known corpus layout
    python -m sept_tpu_torch.cli.predict ... --dataset crema-d --corpus_root /data/CREMA-D

    # privacy-preserving path: classify the NOISED representation
    python -m sept_tpu_torch.cli.predict ... --cloak cloak_grl_lamda1.0_supp40 \\
        --suppression_ratio 40

Counterpart of ``sept_tpu/cli/predict.py``, the batch counterpart of
``cli.serve`` on the same :func:`sept_tpu_torch.serve.load_predictor`.
Audio is decoded by the port's WAV decoder
(:mod:`sept_tpu_torch.runtime.wavio`), staged to the device as int16 PCM
where that is lossless (``narrow_pcm16``), and classified ``--batch_size``
files a predictor call.  Output CSV: one row per file with the predicted
label and the per-class probabilities (a multitask model: a label and the
probabilities of each head).
"""

from __future__ import annotations

import argparse
import csv
import os

from sept_tpu_torch.cli.common import add_device_arg


def iter_wav_dir(root: str) -> list[tuple[str, str]]:
    """(utt_id, path) for every .wav under ``root`` (recursive, sorted).

    utt_id is the path relative to root without the extension."""
    out = []
    for dirpath, _, names in sorted(os.walk(root)):
        for name in sorted(names):
            if name.lower().endswith(".wav"):
                path = os.path.join(dirpath, name)
                rel = os.path.relpath(path, root)
                out.append((os.path.splitext(rel)[0], path))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--output_dir", default="results")
    p.add_argument("--artifact", default="baseline_emotion")
    p.add_argument("--fold", type=int, default=1)
    p.add_argument("--cloak", default=None,
                   help="cloak artifact to classify the noised representation")
    p.add_argument("--suppression_ratio", type=int, default=0)
    p.add_argument("--wav_dir", default=None,
                   help="classify every .wav under this directory")
    p.add_argument("--dataset", default=None,
                   help="walk a known corpus layout instead of --wav_dir")
    p.add_argument("--corpus_root", default=None)
    p.add_argument("--out", default="predictions.csv")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--seed", type=int, default=0,
                   help="noise seed for the cloaked path")
    # model knobs default to the artifact's training manifest
    p.add_argument("--hidden_size", type=int, default=None)
    p.add_argument("--input_spec_size", type=int, default=None)
    p.add_argument("--win_len", type=int, default=None)
    add_device_arg(p)
    args = p.parse_args(argv)

    import numpy as np

    from sept_tpu_torch.runtime.wavio import decode_batch, narrow_pcm16
    from sept_tpu_torch.serve import _CLASS_NAMES, load_predictor

    if args.wav_dir:
        entries = iter_wav_dir(args.wav_dir)
    elif args.dataset and args.corpus_root:
        from sept_tpu_torch.data.walkers import walk_corpus

        entries = [(u.utt_id, u.path) for u in walk_corpus(args.dataset, args.corpus_root)]
    else:
        p.error("pass --wav_dir, or --dataset with --corpus_root")
    if not entries:
        p.error("no .wav files found")

    overrides = {
        k: v for k, v in (
            ("hidden_size", args.hidden_size),
            ("feature_len", args.input_spec_size),
            ("win_len", args.win_len),
        ) if v is not None
    }
    predictor = load_predictor(args.output_dir, args.artifact, args.fold,
                               cloak_artifact=args.cloak,
                               suppression_ratio=args.suppression_ratio,
                               device=args.device, **overrides)
    multitask = predictor.model.pred == "multitask"
    if multitask:
        heads = [(t, _CLASS_NAMES[t]) for t in ("emotion", "gender")]
        header = (["utt_id", "path"] + [f"label_{t}" for t, _ in heads]
                  + [f"p_{c}" for _, cs in heads for c in cs])
    else:
        classes = _CLASS_NAMES[predictor.model.pred]
        header = ["utt_id", "path", "label"] + [f"p_{c}" for c in classes]
    # the frontend's reflect pad needs n_fft // 2 + 1 samples: a decodable
    # but tiny fragment is skipped, not a failure of the whole run
    min_samples = predictor.n_fft // 2 + 1

    with open(args.out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        done = 0
        for lo in range(0, len(entries), args.batch_size):
            chunk = entries[lo:lo + args.batch_size]
            mat, lens = decode_batch([path for _, path in chunk], target_sr=16000)
            keep = [i for i in range(len(chunk)) if lens[i] >= min_samples]
            for i in range(len(chunk)):
                if lens[i] == 0:
                    print(f"skipping undecodable {chunk[i][1]}", flush=True)
                elif lens[i] < min_samples:
                    print(f"skipping too-short ({int(lens[i])} samples) {chunk[i][1]}",
                          flush=True)
            if not keep:
                continue
            waves = [narrow_pcm16(mat[i, :lens[i]]) for i in keep]
            probs = predictor.predict(waves, seed=args.seed)
            for row, i in enumerate(keep):
                utt, path = chunk[i]
                if multitask:
                    labels = [cs[int(np.argmax(probs[t][row]))] for t, cs in heads]
                    ps = [f"{x:.6f}" for t, _ in heads for x in probs[t][row]]
                    w.writerow([utt, path] + labels + ps)
                else:
                    pr = probs[row]
                    w.writerow([utt, path, classes[int(np.argmax(pr))]]
                               + [f"{x:.6f}" for x in pr])
            done += len(keep)
            print(f"{done}/{len(entries)} classified", flush=True)
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
