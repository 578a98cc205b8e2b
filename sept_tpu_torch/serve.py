"""Serving API in PyTorch: raw waveform -> emotion (and gender) predictions.

Counterpart of ``sept_tpu/serve.py``.  One call per utterance batch runs

    waveform -> mel (CUDA kernel) -> per-utterance z-norm* -> sliding windows
             -> [cloak noise] -> Conv2dBiRNN (block 1 in CUDA kernels)
             -> softmax-mean vote

(*) training normalizes per speaker; the speaker is unknown when serving, so
the predictor normalizes per utterance, or with fixed ``norm_stats=(mean,
std)``.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.  Building
a predictor switches TF32 off for cuBLAS and cuDNN
(``torch.backends.cuda.matmul.allow_tf32`` / ``torch.backends.cudnn.allow_tf32``
= False), the counterpart of the JAX package's ``PARITY_PRECISION =
HIGHEST``: blocks 2-3 (cuDNN) and the GRU would otherwise run in TF32.

:func:`load_predictor` builds a predictor from the artifacts the trainers
and ``cli.import_torch`` write (:mod:`sept_tpu_torch.train.checkpoint`);
``cli.serve`` and ``cli.predict`` are its command lines.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sept_tpu_torch.data.prep import HOP, pow2_rows, prepare_waves
from sept_tpu_torch.device import f32_precision, resolve_device
from sept_tpu_torch.models import CloakNoise, build_backbone, pooling_for
from sept_tpu_torch.ops.mel import mel_db

__all__ = ["Predictor", "CloakedPredictor", "PredictionServer", "load_predictor"]


class Predictor:
    """Batch waveform -> class probabilities."""

    def __init__(
        self,
        state_dict,
        model_type: str = "2d-cnn-lstm",
        pred: str = "emotion",
        hidden_size: int = 64,
        feature_len: int = 128,
        win_len: int = 200,
        shift_len: int = 50,
        n_fft: int = 800,
        norm_stats: Optional[tuple] = None,
        att: Optional[str] = None,
        attention_size: int = 128,
        device="cuda",
    ):
        self.device = resolve_device(device)
        f32_precision()
        self.model = build_backbone(model_type, hidden_size=hidden_size,
                                    feature_len=feature_len, win_len=win_len, pred=pred,
                                    att=att, attention_size=attention_size)
        self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()
        self.pooling = pooling_for(model_type)
        self.feature_len = feature_len
        self.win_len = win_len
        self.shift_len = shift_len
        self.n_fft = n_fft
        self.norm_stats = None if norm_stats is None else tuple(
            torch.as_tensor(np.asarray(s, np.float32), device=self.device)
            for s in norm_stats)

    def _normalize(self, feats, frame_valid):
        m = frame_valid[..., None]
        if self.norm_stats is not None:
            # pad frames are masked like the per-utterance branch: bucketing
            # pads the frame axis, and normalized dB-of-silence would leak
            # into window 0 of short utterances
            mean, std = self.norm_stats
            return ((feats - mean) / (std + 1e-5)) * m
        count = torch.clamp(m.sum(1, keepdim=True), min=1.0)
        mean = (feats * m).sum(1, keepdim=True) / count
        var = (((feats - mean) ** 2) * m).sum(1, keepdim=True) / count
        return ((feats - mean) / (torch.sqrt(var) + 1e-5)) * m

    def _noise(self, windows, seed):  # hook for CloakedPredictor
        return windows

    def bucket(self, waveforms: list[np.ndarray]):
        """Host staging: (padded rows (R, need), n_frames (R,), frame bucket).

        The frame count rounds up to a ``win_len`` multiple and the rows to a
        power of two; pad rows carry ``n_frames = 1`` and are dropped after
        the vote, so results equal the exact-shape computation.
        """
        padded, n_frames = prepare_waves(waveforms, self.n_fft)
        max_t = int(n_frames.max())
        max_t_b = max(1, -(-max_t // self.win_len)) * self.win_len
        # the sample width is always the frame bucket's requirement: cropping
        # is lossless (trailing < hop samples make no new frame)
        need = (max_t_b - 1) * HOP + self.n_fft
        rows = pow2_rows(len(waveforms), 1 << 30)
        buf = np.zeros((rows, need), padded.dtype)
        w = min(padded.shape[1], need)
        buf[: len(waveforms), :w] = padded[:, :w]
        nf = np.ones(rows, np.int32)
        nf[: len(waveforms)] = n_frames
        return buf, nf, max_t_b

    def windows(self, buf: np.ndarray, nf: np.ndarray, max_t: int, seed: int = 0):
        """Model input of one bucketed batch: (B * n_win, 1, win, D) windows
        (cloak noise applied) and the (B, n_win) valid-window mask."""
        # int16 PCM crosses host -> device as int16; mel_db normalizes it
        padded = torch.from_numpy(buf).to(self.device)
        n_frames = torch.from_numpy(nf).to(self.device)
        b = padded.shape[0]
        if max_t < self.win_len or max_t % self.win_len:
            raise ValueError(f"frame bucket {max_t} is not a multiple of {self.win_len}")
        feats = mel_db(padded, max_t, self.n_fft, HOP, self.feature_len)
        valid = (torch.arange(max_t, device=self.device)[None, :]
                 < n_frames[:, None]).to(torch.float32)
        feats = self._normalize(feats, valid)
        n_win = max(0, (max_t - self.win_len) // self.shift_len) + 1
        starts = torch.arange(n_win, device=self.device) * self.shift_len
        idx = starts[:, None] + torch.arange(self.win_len, device=self.device)[None, :]
        wins = self._noise(feats[:, idx, :], seed)  # (B, W, win, D)
        n_valid = torch.clamp((n_frames - self.win_len) // self.shift_len, min=0) + 1
        wvalid = torch.arange(n_win, device=self.device)[None, :] < n_valid[:, None]
        return wins.reshape(b * n_win, 1, self.win_len, self.feature_len), wvalid

    def _predict(self, buf, nf, max_t, seed):
        flat, wvalid = self.windows(buf, nf, max_t, seed)
        logits = self.model(flat, pooling=self.pooling)
        b, n_win = wvalid.shape
        w = wvalid.to(torch.float32)[..., None]

        def vote(head_logits):
            probs = torch.softmax(head_logits, -1).reshape(b, n_win, -1)
            return (probs * w).sum(1) / torch.clamp(w.sum(1), min=1.0)

        if isinstance(logits, tuple):  # multitask: (emotion, gender)
            return tuple(vote(h) for h in logits)
        return vote(logits)

    def predict(self, waveforms: list[np.ndarray], seed: int = 0):
        """list of 16 kHz waveforms -> (B, n_classes) probabilities.

        A ``pred="multitask"`` model returns ``{"emotion": (B, 4), "gender":
        (B, 2)}``, both heads voted over the same windows.  Waveforms are
        float32 in [-1, 1) or raw int16 PCM.
        """
        buf, nf, max_t = self.bucket(waveforms)
        with torch.inference_mode():
            out = self._predict(buf, nf, max_t, seed)
            n = len(waveforms)
            if isinstance(out, tuple):
                return {"emotion": out[0][:n].cpu().numpy(),
                        "gender": out[1][:n].cpu().numpy()}
            return out[:n].cpu().numpy()


class CloakedPredictor(Predictor):
    """Predictor that applies trained cloak noise to the features before the
    backbone: it serves the privacy-preserving representation.

    ``noise_state_dict`` holds the cloak's ``locs``/``rhos`` (1, win, feats);
    ``mask`` is an optional (win, feats) suppression mask.  Each call draws
    one noise field from a CPU ``torch.Generator`` seeded with ``seed``, so a
    seed gives the same noise on every device.
    """

    def __init__(self, *args, noise_state_dict=None, mask=None,
                 max_scale: float = 5.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.noise = CloakNoise(win_len=self.win_len, n_feats=self.feature_len,
                                max_scale=max_scale)
        self.noise.load_state_dict(noise_state_dict)
        self.noise.to(self.device).eval()
        self.mask = None if mask is None else torch.as_tensor(
            np.asarray(mask, np.float32), device=self.device)

    def _noise(self, windows, seed):
        b, w = windows.shape[:2]
        flat = windows.reshape(b * w, self.win_len, self.feature_len)
        gen = torch.Generator().manual_seed(int(seed))
        return self.noise(flat, self.mask, generator=gen).reshape(windows.shape)


# ---------------------------------------------------------------------------
# checkpoint -> predictor, and the HTTP deployment surface

_CLASS_NAMES = {
    # label order fixed by the reference's maps (training_tools.py:9-10)
    "emotion": ("neu", "hap", "sad", "ang"),
    "gender": ("F", "M"),
}


def load_predictor(
    output_dir: str,
    artifact: str = "baseline_emotion",
    fold: int = 1,
    cloak_artifact: Optional[str] = None,
    suppression_ratio: int = 0,
    n_fft: int = 800,
    device="cuda",
    **overrides,
) -> Predictor:
    """Build a serving predictor on ``device`` from training artifacts on
    disk.

    ``artifact``/``fold`` name the frozen classifier checkpoint
    (``cli.train_baseline`` or ``cli.import_torch``).  The architecture
    (model_type, pred, hidden_size, feature_len, win_len, att,
    attention_size) comes from the ``manifest_fold<k>.json`` beside it, so
    the served model is built as it was trained; keyword ``overrides`` take
    precedence over the manifest, and without a manifest the defaults apply.
    ``shift_len`` defaults to ``win_len // 4``; an unknown override raises
    ``TypeError``.  Artifacts trained with the global feature, and imported
    LSTM artifacts (the JAX package's ``Predictor`` builds a GRU whatever the
    manifest says, so it cannot serve them either), raise ``ValueError``.

    ``cloak_artifact`` (a ``cli.train_cloak`` artifact, plain or GRL) serves
    the privacy-preserving path: the cloak's ``noise.locs`` / ``noise.rhos``
    are restored, the evaluation-direction mask for ``suppression_ratio`` is
    taken from their scales at max_scale 5 (the evaluation bound), and a
    :class:`CloakedPredictor` is returned."""
    import json
    import os

    from sept_tpu_torch.eval.sweep import EVAL_MAX_SCALE, eval_mask
    from sept_tpu_torch.train.checkpoint import CheckpointManager

    mcfg = {}
    mpath = os.path.join(output_dir, artifact, f"manifest_fold{fold}.json")
    if os.path.isfile(mpath):
        with open(mpath) as f:
            mcfg = json.load(f).get("config", {})

    def knob(name, default):
        if name in overrides:
            return overrides.pop(name)
        return mcfg.get(name, default)

    win_len = int(knob("win_len", 200))
    common = dict(
        model_type=knob("model_type", "2d-cnn-lstm"),
        pred=knob("pred", "emotion"),
        hidden_size=int(knob("hidden_size", 64)),
        feature_len=int(knob("feature_len", 128)),
        win_len=win_len,
        shift_len=int(overrides.pop("shift_len", win_len // 4)),
        att=knob("att", None),
        attention_size=int(knob("attention_size", 128)),
        n_fft=n_fft,
    )
    if overrides:
        raise TypeError(f"unknown load_predictor overrides: {sorted(overrides)}")
    if mcfg.get("global_feature"):
        raise ValueError(
            f"{artifact} was trained with global_feature=1 (gemaps concat); "
            "the serving path computes windowed spectral features only — "
            "evaluate such artifacts with cli.evaluate, or retrain with "
            "--global_feature 0 to serve")
    if mcfg.get("rnn_cell", "gru") != "gru":
        raise ValueError(
            f"{artifact} holds an {mcfg['rnn_cell']!r} RNN (an imported "
            "deep_two_d_cnn_lstm_tmp); serving builds the GRU models only, as "
            "the JAX package's Predictor does")

    ckpt = CheckpointManager(output_dir)
    state = ckpt.restore(artifact, fold, "cpu")
    if cloak_artifact is None:
        return Predictor(state, device=device, **common)
    cloak = ckpt.restore(cloak_artifact, fold, "cpu")
    noise = {k: cloak[f"noise.{k}"] for k in ("locs", "rhos")}
    probe = CloakNoise(win_len=win_len, n_feats=common["feature_len"], max_scale=EVAL_MAX_SCALE)
    probe.load_state_dict(noise)
    with torch.no_grad():
        scales = probe.scales()[0].numpy()
    return CloakedPredictor(state, noise_state_dict=noise,
                            mask=eval_mask(scales, suppression_ratio),
                            max_scale=EVAL_MAX_SCALE, device=device, **common)


class PredictionServer:
    """Stdlib-only JSON-over-HTTP front for a :class:`Predictor`.

    Routes:
        GET  /healthz   -> {"status": "ok", "pred": ..., "cloaked": ...}
        GET  /metrics   -> request/error/waveform counters, device-call
                           latency quantiles (ms), micro-batch size stats
        POST /predict   -> body {"waveforms": [[float16k samples], ...],
                                 "seed": 0}
                           or   {"waveforms_pcm16": ["<base64 of raw
                                 little-endian int16 PCM>", ...], "seed": 0}
                           reply {"classes": [...], "probs": [[...], ...],
                                  "labels": [argmax class per waveform]}
                           (a multitask model replies {"tasks": {"emotion":
                           {...}, "gender": {...}}} with one block per head)
        POST /stream            -> {"session": id}   (optional {"seed": n})
        POST /stream/<id>       -> append {"pcm16": "<base64 int16>"} or
                                   {"samples": [...]}; reply adds the
                                   rolling {"probs": [...], "label": ...,
                                   "samples": total} over the session tail
        DELETE /stream/<id>     -> drop the session

    Streaming keeps only the trailing ``max_stream_s`` seconds of a session;
    idle sessions expire after ``stream_ttl_s``.  ``waveforms_pcm16`` is the
    compact wire format: int16 all the way to the device.

    Connections are handled on threads, while predictions are serialized
    through one device lock, so /healthz answers while a request computes.
    ``batch_window_ms > 0`` enables micro-batching: concurrent /predict
    requests that share a ``seed`` (cloaked predictors draw noise from it)
    and arrive within the window run as one predictor call, and each caller
    gets its slice.  0 (default) dispatches each request on its own.
    """

    def __init__(self, predictor: Predictor, host: str = "127.0.0.1",
                 port: int = 0, batch_window_ms: float = 0.0,
                 max_stream_s: float = 30.0, stream_ttl_s: float = 300.0,
                 max_sessions: int = 256, sample_rate: int = 16000,
                 max_body_mb: float = 256.0):
        import http.server
        import json
        import queue
        import threading
        import time
        import uuid

        device_lock = threading.Lock()

        # ---- observability: counters + a sliding latency window ----
        stats_lock = threading.Lock()
        stats = {"requests_total": 0, "errors_total": 0,
                 "waveforms_total": 0, "device_calls_total": 0,
                 "batched_requests_total": 0}
        recent_ms: list = []  # device-call latencies, last _WINDOW kept
        recent_batch: list = []  # waveforms per device call
        _WINDOW = 1024

        def _timed_predict(waves, seed, n_requests):
            with device_lock:
                # timed inside the lock: the device call, not the queue wait
                t0 = time.perf_counter()
                probs = predictor.predict(waves, seed=seed)
                ms = (time.perf_counter() - t0) * 1e3
            with stats_lock:
                stats["device_calls_total"] += 1
                stats["waveforms_total"] += len(waves)
                if n_requests > 1:
                    stats["batched_requests_total"] += n_requests
                recent_ms.append(ms)
                recent_batch.append(len(waves))
                del recent_ms[:-_WINDOW], recent_batch[:-_WINDOW]
            return probs

        def _metrics():
            with stats_lock:
                out = dict(stats)
                ms, bt = list(recent_ms), list(recent_batch)
            if ms:
                q = np.percentile(ms, [50, 90, 99])
                out["device_call_ms"] = {
                    "p50": round(float(q[0]), 2),
                    "p90": round(float(q[1]), 2),
                    "p99": round(float(q[2]), 2),
                    "window": len(ms),
                }
                out["waveforms_per_device_call"] = {
                    "mean": round(float(np.mean(bt)), 2),
                    "max": int(max(bt)),
                }
            out["micro_batching"] = (
                {"batch_window_ms": batch_window_ms}
                if batch_window_ms > 0 else None
            )
            return out

        class _Pending:
            __slots__ = ("waves", "seed", "done", "result", "error")

            def __init__(self, waves, seed):
                self.waves = waves
                self.seed = seed
                self.done = threading.Event()
                self.result = None
                self.error = None

        batch_queue: queue.Queue = queue.Queue()

        def _run_batch(group):
            # nothing here may escape: an uncaught exception would kill the
            # batcher thread and strand every queued request
            try:
                flat = [w for p in group for w in p.waves]
                probs = _timed_predict(flat, group[0].seed, len(group))
                lo = 0
                for p in group:
                    hi = lo + len(p.waves)
                    p.result = (
                        {k: v[lo:hi] for k, v in probs.items()}
                        if isinstance(probs, dict) else probs[lo:hi]
                    )
                    lo = hi
            except Exception as e:
                for p in group:
                    if p.result is None:
                        p.error = e
            finally:
                for p in group:
                    p.done.set()

        def _batcher():
            while True:
                first = batch_queue.get()
                if first is None:
                    return
                # same-seed requests inside the window join; other seeds go
                # back on the queue for the next batch
                deadline = time.monotonic() + batch_window_ms / 1000.0
                group, requeue = [first], []
                stop = False
                while True:
                    remain = deadline - time.monotonic()
                    if remain <= 0:
                        break
                    try:
                        p = batch_queue.get(timeout=remain)
                    except queue.Empty:
                        break
                    if p is None:
                        stop = True
                        break
                    (group if p.seed == first.seed else requeue).append(p)
                for r in requeue:
                    batch_queue.put(r)
                _run_batch(group)
                if stop:
                    # drain what is still queued (grouped by seed) so no
                    # caller blocks across shutdown
                    by_seed: dict = {}
                    while True:
                        try:
                            p = batch_queue.get_nowait()
                        except queue.Empty:
                            break
                        if p is not None:
                            by_seed.setdefault(p.seed, []).append(p)
                    for g in by_seed.values():
                        _run_batch(g)
                    return

        self._batcher_thread = None
        if batch_window_ms > 0:
            self._batcher_thread = threading.Thread(target=_batcher, daemon=True)
            self._batcher_thread.start()
        self._batch_queue = batch_queue

        def predict_waves(waves, seed):
            """One request's prediction, through the micro-batcher if on."""
            batcher = self._batcher_thread
            if batcher is None or not batcher.is_alive():
                return _timed_predict(waves, seed, 1)
            p = _Pending(waves, seed)
            batch_queue.put(p)
            while not p.done.wait(1.0):
                if not batcher.is_alive():
                    # the batcher exited (shutdown race) without serving this
                    # request: dispatch directly rather than hang the caller
                    return _timed_predict(waves, seed, 1)
            if p.error is not None:
                raise p.error
            return p.result

        # ---- streaming sessions: id -> accumulated trailing samples ----
        sessions_lock = threading.Lock()
        sessions: dict = {}  # id -> {"wave": np.ndarray, "seed": int, "t": float}
        max_samples = int(max_stream_s * sample_rate)
        # shortest wave the frontend takes: the center-STFT reflect pad needs
        # len > n_fft//2
        min_samples = predictor.n_fft // 2 + 1

        def _stream_create(seed):
            sid = uuid.uuid4().hex[:16]
            with sessions_lock:
                now = time.monotonic()
                for k in [k for k, s in sessions.items()
                          if now - s["t"] > stream_ttl_s]:
                    del sessions[k]
                while len(sessions) >= max_sessions:
                    del sessions[min(sessions, key=lambda k: sessions[k]["t"])]
                sessions[sid] = {"wave": np.zeros(0, np.int16), "seed": seed,
                                 "t": now}
            return sid

        def _stream_append(sid, chunk):
            """Append a chunk; (tail_wave, seed), or None if unknown/expired."""
            with sessions_lock:
                s = sessions.get(sid)
                now = time.monotonic()
                if s is None or now - s["t"] > stream_ttl_s:
                    sessions.pop(sid, None)
                    return None
                if s["wave"].dtype != chunk.dtype:
                    # sessions may mix pcm16 and float chunks: widen to f32
                    def f32(w):
                        return (w.astype(np.float32) / 32768.0
                                if w.dtype == np.int16 else w)

                    s["wave"], chunk = f32(s["wave"]), f32(chunk)
                s["wave"] = np.concatenate([s["wave"], chunk])[-max_samples:]
                s["t"] = now
                return s["wave"], s["seed"]

        multitask = predictor.model.pred == "multitask"
        classes = None if multitask else _CLASS_NAMES[predictor.model.pred]
        cloaked = isinstance(predictor, CloakedPredictor)

        def _payload(probs):
            """JSON body for one request's probabilities (B rows)."""
            if isinstance(probs, dict):
                return {"tasks": {
                    task: {
                        "classes": list(_CLASS_NAMES[task]),
                        "probs": p.tolist(),
                        "labels": [_CLASS_NAMES[task][i] for i in p.argmax(-1)],
                    }
                    for task, p in probs.items()
                }}
            return {"classes": list(classes), "probs": probs.tolist(),
                    "labels": [classes[i] for i in probs.argmax(-1)]}

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet by default
                pass

            def _send(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {"status": "ok",
                                     "pred": predictor.model.pred,
                                     "cloaked": cloaked})
                elif self.path == "/metrics":
                    self._send(200, _metrics())
                else:
                    self._send(404, {"error": "unknown route"})

            def _read_json(self):
                n = int(self.headers.get("Content-Length", 0))
                if not 0 <= n <= max_body_mb * 1024 * 1024:
                    # refuse before buffering; drain a bounded amount so a
                    # well-behaved sender can read the 400
                    try:
                        remaining = min(max(n, 0), 64 << 20)
                        while remaining > 0:
                            chunk = self.rfile.read(min(65536, remaining))
                            if not chunk:
                                break
                            remaining -= len(chunk)
                    except OSError:
                        pass
                    self.close_connection = True
                    raise ValueError(
                        f"request body {n} bytes exceeds the "
                        f"{max_body_mb:g} MiB limit")
                raw = self.rfile.read(n)
                return json.loads(raw) if raw else {}

            def _fail(self, code, obj):
                """4xx/5xx response, counted in errors_total."""
                with stats_lock:
                    stats["errors_total"] += 1
                self._send(code, obj)

            @staticmethod
            def _decode_pcm16(b64):
                import base64

                return np.frombuffer(base64.b64decode(b64), "<i2")

            def do_DELETE(self):
                if not self.path.startswith("/stream/"):
                    return self._send(404, {"error": "unknown route"})
                sid = self.path[len("/stream/"):]
                with sessions_lock:
                    known = sessions.pop(sid, None) is not None
                if known:
                    self._send(200, {"closed": sid})
                else:
                    self._send(404, {"error": f"unknown session {sid!r}"})

            def _do_stream(self):
                if self.path == "/stream":  # create
                    try:
                        req = self._read_json()
                        if not isinstance(req, dict):
                            raise ValueError("body must be a JSON object")
                        seed = int(req.get("seed", 0) or 0)
                    except (ValueError, TypeError, json.JSONDecodeError) as e:
                        return self._fail(400, {"error": str(e)})
                    return self._send(200, {"session": _stream_create(seed)})
                sid = self.path[len("/stream/"):]
                try:
                    req = self._read_json()
                    if "pcm16" in req:
                        chunk = self._decode_pcm16(req["pcm16"])
                    else:
                        chunk = np.asarray(req["samples"], np.float32)
                    if chunk.ndim != 1 or not len(chunk):
                        raise ValueError("chunk must be non-empty 1-D audio samples")
                except (ValueError, KeyError, TypeError,
                        json.JSONDecodeError) as e:
                    return self._fail(400, {"error": str(e)})
                got = _stream_append(sid, chunk)
                if got is None:
                    return self._fail(
                        404, {"error": f"unknown or expired session {sid!r}"})
                wave, seed = got
                if len(wave) < min_samples:
                    # not enough audio for one reflect-padded frame yet
                    return self._send(200, {
                        "samples": int(len(wave)), "buffered": True,
                        "need_samples": int(min_samples)})
                try:
                    # direct dispatch, not the micro-batcher: a long session
                    # tail would pad a merged batch up to its length bucket
                    probs = _timed_predict([wave], seed, 1)
                except Exception as e:
                    return self._fail(500, {"error": f"{type(e).__name__}: {e}"})
                if isinstance(probs, dict):
                    body = {"tasks": {
                        task: {"classes": list(_CLASS_NAMES[task]),
                               "probs": p[0].tolist(),
                               "label": _CLASS_NAMES[task][int(p[0].argmax())]}
                        for task, p in probs.items()
                    }}
                else:
                    body = {"classes": list(classes),
                            "probs": probs[0].tolist(),
                            "label": classes[int(probs[0].argmax())]}
                body["samples"] = int(len(wave))
                self._send(200, body)

            def do_POST(self):
                if self.path == "/stream" or self.path.startswith("/stream/"):
                    with stats_lock:
                        stats["requests_total"] += 1
                    return self._do_stream()
                if self.path != "/predict":
                    return self._send(404, {"error": "unknown route"})
                with stats_lock:
                    stats["requests_total"] += 1
                try:
                    req = self._read_json()
                    if "waveforms_pcm16" in req:
                        waves = [self._decode_pcm16(b)
                                 for b in req["waveforms_pcm16"]]
                        if not waves or any(not len(w) for w in waves):
                            raise ValueError(
                                "waveforms_pcm16 entries must be base64 of "
                                "non-empty little-endian int16 PCM")
                    else:
                        waves = [np.asarray(w, np.float32)
                                 for w in req["waveforms"]]
                        if not waves or any(w.ndim != 1 or not len(w)
                                            for w in waves):
                            raise ValueError(
                                "waveforms must be non-empty 1-D sample lists")
                    if any(len(w) < min_samples for w in waves):
                        # the reflect pad needs len > n_fft//2: a 400 here,
                        # not a 500 from deep in the model path
                        raise ValueError(
                            f"each waveform needs >= {min_samples} samples "
                            f"(n_fft//2 + 1) at 16 kHz")
                    seed = int(req.get("seed", 0) or 0)
                except (ValueError, KeyError, TypeError,
                        json.JSONDecodeError) as e:
                    return self._fail(400, {"error": str(e)})
                try:
                    probs = predict_waves(waves, seed)
                except Exception as e:  # any model/device failure -> 500,
                    # never a dropped connection with no HTTP response
                    return self._fail(500, {"error": f"{type(e).__name__}: {e}"})
                self._send(200, _payload(probs))

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]

    def serve_forever(self):
        self._httpd.serve_forever()

    def shutdown(self):
        # HTTP first: once no new requests arrive, the batcher sentinel drains
        # whatever is queued and exits
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._batcher_thread is not None:
            self._batch_queue.put(None)
            self._batcher_thread.join(timeout=30)
            self._batcher_thread = None
