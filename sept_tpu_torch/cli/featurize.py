"""CLI: corpus featurization (the reference's audio_feature_extraction.py).

    python -m sept_tpu_torch.cli.featurize --dataset synthetic
    python -m sept_tpu_torch.cli.featurize --dataset crema-d --corpus_root DIR

Counterpart of ``sept_tpu/cli/featurize.py``.  Decodes audio with the
native decoder (``runtime/wavio.py``: threaded, the next chunk decoding
while this one featurizes), featurizes on the device
(``data/featurize.py``: the f32 mel kernel, and for ``--feature_type mfcc``
the floor + DCT kernel; with ``--functionals 1``, the default as in the JAX
package, the 88-dim gemaps and 988-dim emobase functionals of the same
chunks), and writes ``<work_dir>/feature/<type>/<dataset>/data_<len>.npz``
plus ``manifest.json``, the JAX package's files.  ``--import_opensmile
PATH`` (repeatable) replaces the computed functionals with real openSMILE
values from a CSV or the reference's feature pickle
(``data/opensmile_import.py``); an id the corpus lacks is an error, a
partial cover a warning.
"""

from __future__ import annotations

import argparse
import os

from sept_tpu_torch.cli.common import add_common_args, setup_seed
from sept_tpu_torch.device import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--n_speakers", type=int, default=10,
                   help="synthetic corpus size")
    p.add_argument("--utts_per_speaker", type=int, default=12)
    p.add_argument("--functionals", type=int, default=1,
                   help="also extract the 88-dim gemaps + 988-dim emobase "
                        "functionals (the reference extracts both beside the "
                        "spectral features); 0 skips them for runs that train "
                        "with global_feature=0")
    p.add_argument("--import_opensmile", action="append", default=None, metavar="PATH",
                   help="CSV (openSMILE pandas output) or reference feature "
                        "pickle whose real eGeMAPSv02 / emobase functionals "
                        "replace the computed stand-ins in the store, verbatim "
                        "(repeatable; see data/opensmile_import.py)")
    p.add_argument("--decode_chunk", type=int, default=512,
                   help="decode this many files at a time (0 = all at once): "
                        "bounds host memory and overlaps the next chunk's "
                        "threaded decode with this chunk's featurization")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    setup_seed(args.seed)

    from sept_tpu_torch.data.featurize import featurize_corpus
    from sept_tpu_torch.data.store import save_feature_store, save_manifest

    def featurize(waves):
        return featurize_corpus(waves, feature_type=args.feature_type,
                                feature_len=args.input_spec_size,
                                include_gemaps=bool(args.functionals), device=device)

    # an empty corpus refuses what featurize_corpus refuses (an unknown
    # feature type) before any audio is made or decoded
    featurize({})
    if args.dataset in ("synthetic", "synthetic_hard"):
        from sept_tpu_torch.data.synthetic import make_corpus, make_hard_corpus

        maker = make_hard_corpus if args.dataset == "synthetic_hard" else make_corpus
        corpus = maker(args.n_speakers, args.utts_per_speaker, args.seed)
        manifest = corpus.manifest
        store = featurize(corpus.waveforms)
    else:
        if not args.corpus_root:
            p.error(f"--corpus_root is required for dataset {args.dataset!r}")
        from concurrent.futures import ThreadPoolExecutor

        from sept_tpu_torch.data.walkers import walk_corpus
        from sept_tpu_torch.runtime.wavio import decode_batch, narrow_pcm16

        manifest = walk_corpus(args.dataset, args.corpus_root)

        def size_or_zero(path):
            # a file that cannot be stat-ed sorts first; decode_batch gives
            # it a length-0 row and it is skipped like any undecodable file
            try:
                return os.path.getsize(path)
            except OSError:
                return 0

        # size-sorted chunks: files of similar length decode together, so
        # each rectangular decode buffer is tight and the length buckets
        # inside featurize_corpus stay dense
        order = sorted(range(len(manifest)), key=lambda i: size_or_zero(manifest[i].path))
        step = args.decode_chunk if args.decode_chunk > 0 else max(1, len(order))
        chunks = [order[lo:lo + step] for lo in range(0, len(order), step)]

        store = {}
        with ThreadPoolExecutor(max_workers=1) as ex:
            def submit(idxs):
                return ex.submit(decode_batch, [manifest[i].path for i in idxs],
                                 target_sr=16000)

            fut = submit(chunks[0]) if chunks else None
            for ci, idxs in enumerate(chunks):
                mat, lens = fut.result()
                if ci + 1 < len(chunks):
                    # the decoder releases the GIL: the next chunk decodes
                    # while this one featurizes
                    fut = submit(chunks[ci + 1])
                # decoded 16-bit sources go to the device as int16 (half the
                # bytes, the same features)
                waves = {manifest[i].utt_id: narrow_pcm16(mat[r, : lens[r]])
                         for r, i in enumerate(idxs) if lens[r] > 0}
                store.update(featurize(waves))
        manifest = [u for u in manifest if u.utt_id in store]

    if args.import_opensmile:
        from sept_tpu_torch.data.opensmile_import import apply_opensmile, load_opensmile_file

        for path in args.import_opensmile:
            replaced, unmatched, uncovered = apply_opensmile(store, load_opensmile_file(path))
            if unmatched:
                p.error(f"--import_opensmile {path}: {len(unmatched)} utterance ids not in "
                        f"this corpus (first: {unmatched[:3]}) — wrong corpus or id scheme?")
            for name, miss in uncovered.items():
                # a partial import mixes real openSMILE values with computed
                # stand-ins: say so without blocking an intended partial corpus
                print(f"WARNING: --import_opensmile {path} covers only "
                      f"{len(store) - len(miss)}/{len(store)} utterances for {name!r}; "
                      f"the other {len(miss)} (first: {miss[:3]}) keep computed "
                      "stand-in values and are NOT numerically interoperable with "
                      "reference artifacts")
            print(f"imported {replaced} openSMILE functional vectors from {path}")

    out_dir = os.path.join(args.work_dir, "feature", args.feature_type, args.dataset)
    os.makedirs(out_dir, exist_ok=True)
    store_path = os.path.join(out_dir, f"data_{args.input_spec_size}.npz")
    save_feature_store(store_path, store)
    save_manifest(os.path.join(out_dir, "manifest.json"), manifest)
    print(f"featurized {len(manifest)} utterances -> {store_path}")


if __name__ == "__main__":
    main()
