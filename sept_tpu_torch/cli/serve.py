"""CLI: serve a trained model over HTTP (JSON in, probabilities out).

    python -m sept_tpu_torch.cli.serve --output_dir results --artifact \\
        baseline_emotion --fold 1 --port 8080 --device cuda

    # privacy-preserving path: classify the NOISED representation
    python -m sept_tpu_torch.cli.serve --output_dir results \\
        --cloak cloak_grl_lamda1.0_supp40 --suppression_ratio 40

Counterpart of ``sept_tpu/cli/serve.py``, on
:func:`sept_tpu_torch.serve.load_predictor` and
:class:`sept_tpu_torch.serve.PredictionServer`.  Protocol:

    GET  /healthz
    POST /predict  {"waveforms": [[...16 kHz float samples...], ...]}
                -> {"classes": [...], "probs": [[...]], "labels": [...]}

One process drives one card (``--device``, default ``cuda``; ``cpu`` runs the
plain versions).  There is no compile cache to enable: nothing compiles per
request shape, and the CUDA kernels' libraries are built once and kept on
disk by ``sept_tpu_torch.ops.cuda_lib``.  ``--warmup`` runs int16 zeros of
that many seconds over power-of-two row buckets up to ``--warmup_rows``
before the first request: the kernels' build or load, cuDNN's and cuBLAS's
set-up and the allocator's pool happen there instead.
"""

from __future__ import annotations

import argparse

from sept_tpu_torch.cli.common import add_device_arg


def make_server(argv=None):
    """Parse ``argv``, build the predictor, warm it up and return the
    :class:`~sept_tpu_torch.serve.PredictionServer`, bound and not yet
    serving (:func:`main` serves it until interrupted)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--output_dir", default="results")
    p.add_argument("--artifact", default="baseline_emotion",
                   help="frozen classifier artifact (cli.train_baseline)")
    p.add_argument("--fold", type=int, default=1)
    p.add_argument("--cloak", default=None,
                   help="cloak artifact name to serve the noised path "
                        "(cli.train_cloak, e.g. cloak_grl_lamda1.0_supp40)")
    p.add_argument("--suppression_ratio", type=int, default=0)
    # model knobs default to the artifact's manifest_fold<k>.json (written at
    # training time) so the served model is built as trained; pass a flag
    # only to override
    p.add_argument("--model_type", default=None)
    p.add_argument("--pred", default=None)
    p.add_argument("--att", default=None,
                   help="attention pooling override; pass 'none' to force "
                        "mean pooling over a manifest value")
    p.add_argument("--hidden_size", type=int, default=None)
    p.add_argument("--input_spec_size", type=int, default=None)
    p.add_argument("--win_len", type=int, default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--batch_window_ms", type=float, default=0.0,
                   help="micro-batch concurrent /predict requests arriving "
                        "within this window into one predictor call (0 = off)")
    p.add_argument("--max_stream_s", type=float, default=30.0,
                   help="streaming sessions keep only this trailing window "
                        "of audio (bounds per-push cost)")
    p.add_argument("--stream_ttl_s", type=float, default=300.0,
                   help="idle streaming sessions expire after this long")
    p.add_argument("--max_body_mb", type=float, default=256.0,
                   help="refuse request bodies larger than this (MiB)")
    p.add_argument("--warmup", type=float, default=0.0,
                   help="run this many seconds of int16 zeros across row "
                        "buckets 1..warmup_rows before accepting traffic "
                        "(0 = skip)")
    p.add_argument("--warmup_rows", type=int, default=8,
                   help="largest request batch to warm (power-of-two row "
                        "buckets up to this)")
    add_device_arg(p)
    args = p.parse_args(argv)

    import numpy as np

    from sept_tpu_torch.serve import PredictionServer, load_predictor

    overrides = {
        k: v for k, v in (
            ("model_type", args.model_type), ("pred", args.pred),
            ("att", args.att), ("hidden_size", args.hidden_size),
            ("feature_len", args.input_spec_size), ("win_len", args.win_len),
        ) if v is not None
    }
    if overrides.get("att", "").lower() == "none":
        overrides["att"] = None  # explicit mean-pooling override
    predictor = load_predictor(args.output_dir, args.artifact, args.fold,
                               cloak_artifact=args.cloak,
                               suppression_ratio=args.suppression_ratio,
                               device=args.device, **overrides)
    if args.warmup > 0:
        wave = np.zeros(int(args.warmup * 16000), np.int16)  # the production staging dtype
        rows = 1
        while rows <= max(1, args.warmup_rows):
            print(f"warmup: rows={rows} dur={args.warmup:g}s ...", flush=True)
            predictor.predict([wave] * rows)
            rows *= 2
        print("warmup done", flush=True)
    server = PredictionServer(predictor, host=args.host, port=args.port,
                              batch_window_ms=args.batch_window_ms,
                              max_stream_s=args.max_stream_s,
                              stream_ttl_s=args.stream_ttl_s,
                              max_body_mb=args.max_body_mb)
    print(f"serving {args.artifact} fold{args.fold}"
          + (f" + cloak {args.cloak}" if args.cloak else "")
          + f" on http://{server.host}:{server.port} ({predictor.device})", flush=True)
    return server


def main(argv=None):
    server = make_server(argv)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
