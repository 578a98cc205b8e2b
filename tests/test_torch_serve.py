"""The port's serving path on the CPU vs the JAX package's, and its HTTP
routes (adapted from tests/test_serve.py).  Probabilities atol 1e-4."""

import base64
import contextlib
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from sept_tpu.serve import CloakedPredictor as JaxCloakedPredictor
from sept_tpu.serve import Predictor as JaxPredictor
from sept_tpu_torch.compat.from_jax import backbone_state_dict, cloak_noise_state_dict
from sept_tpu_torch.serve import CloakedPredictor, Predictor, PredictionServer

from _torch_helpers import jax_backbone

D, WIN, SHIFT = 32, 60, 15
KW = dict(hidden_size=8, feature_len=D, win_len=WIN, shift_len=SHIFT)


def _predictors(pred="emotion", att=None, **extra):
    _, params, stats = jax_backbone(8, pred, att, WIN, D)
    jp = JaxPredictor(params, stats, pred=pred, att=att, **KW, **extra)
    tp = Predictor(backbone_state_dict(params, stats), pred=pred, att=att,
                   device="cpu", **KW, **extra)
    return jp, tp


def _waves(rng, kind):
    if kind == "float":
        return [rng.standard_normal(n).astype(np.float32) * 0.3
                for n in (12000, 17500, 9000)]
    if kind == "int16":
        return [rng.integers(-20000, 20000, n).astype(np.int16)
                for n in (12000, 14000)]
    if kind == "mixed":
        return [rng.integers(-20000, 20000, 12000).astype(np.int16),
                rng.standard_normal(10000).astype(np.float32) * 0.3]
    return [rng.standard_normal(5000).astype(np.float32) * 0.3]  # < one window


@pytest.mark.parametrize("kind", ["float", "int16", "mixed", "short"])
def test_probs_match_jax(rng, kind):
    jp, tp = _predictors()
    waves = _waves(rng, kind)
    got = tp.predict(waves)
    assert got.shape == (len(waves), 4)
    np.testing.assert_allclose(got, jp.predict(waves), atol=1e-4)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_norm_stats_match_jax(rng):
    stats = (np.linspace(-60, -20, D).astype(np.float32),
             np.linspace(5, 15, D).astype(np.float32))
    jp, tp = _predictors(norm_stats=stats)
    waves = _waves(rng, "float")
    np.testing.assert_allclose(tp.predict(waves), jp.predict(waves), atol=1e-4)
    # bucketing pads the frame axis; the pad frames stay masked
    alone = tp.predict(waves[2:])
    np.testing.assert_allclose(alone[0], tp.predict(waves)[2], atol=1e-5)


def test_multitask_matches_jax(rng):
    jp, tp = _predictors(pred="multitask", att="self_att")
    waves = _waves(rng, "float")
    got, want = tp.predict(waves), jp.predict(waves)
    assert set(got) == {"emotion", "gender"}
    for task in got:
        np.testing.assert_allclose(got[task], want[task], atol=1e-4)


def _cloaked(mask, rhos=2.0):
    _, params, stats = jax_backbone(8, "emotion", None, WIN, D)
    noise = {"locs": np.full((WIN, D), 0.3, np.float32),
             "rhos": np.full((WIN, D), rhos, np.float32)}
    jp = JaxCloakedPredictor(params, stats, noise_params=noise, mask=mask,
                             max_scale=5.0, **KW)
    tp = CloakedPredictor(backbone_state_dict(params, stats),
                          noise_state_dict=cloak_noise_state_dict(noise),
                          mask=mask, max_scale=5.0, device="cpu", **KW)
    return jp, tp


def test_cloaked_zero_mask_matches_jax(rng):
    """With an all-zero mask the served features are the cloak's locs alone,
    deterministic in both packages."""
    jp, tp = _cloaked(np.zeros((WIN, D), np.float32))
    waves = _waves(rng, "float")
    np.testing.assert_allclose(tp.predict(waves, seed=3), jp.predict(waves, seed=3),
                               atol=1e-4)


def test_cloaked_noise_is_seeded(rng):
    mask = (rng.random((WIN, D)) > 0.3).astype(np.float32)
    _, tp = _cloaked(mask)
    _, clean = _predictors()
    waves = _waves(rng, "float")
    a, b, c = (tp.predict(waves, seed=s) for s in (0, 0, 7))
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 1e-6
    assert np.abs(a - clean.predict(waves)).max() > 1e-4


def test_bucketing_is_transparent(rng):
    _, tp = _predictors()
    waves = _waves(rng, "float")
    alone = tp.predict(waves[:1])
    np.testing.assert_allclose(alone[0], tp.predict(waves)[0], atol=1e-5)


# ---------------------------------------------------------------------------
# HTTP routes


@contextlib.contextmanager
def _serving(predictor, **kw):
    server = PredictionServer(predictor, port=0, **kw)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://{server.host}:{server.port}"
    finally:
        server.shutdown()
        t.join(10)
    assert not t.is_alive()


def _open(url, data=None, method=None, raw=None):
    body = raw if raw is not None else (
        None if data is None else json.dumps(data).encode())
    req = urllib.request.Request(url, data=body, method=method)
    return json.load(urllib.request.urlopen(req, timeout=60))


def _status(url, data=None, raw=None):
    try:
        _open(url, data, raw=raw)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)
    return 200, None


def test_http_predict_float_and_pcm16(rng):
    _, tp = _predictors()
    floats = [w.tolist() for w in _waves(rng, "float")[:2]]
    pcm = _waves(rng, "int16")
    with _serving(tp) as base:
        assert _open(f"{base}/healthz") == {"status": "ok", "pred": "emotion",
                                            "cloaked": False}
        out = _open(f"{base}/predict", {"waveforms": floats})
        assert out["classes"] == ["neu", "hap", "sad", "ang"]
        direct = tp.predict([np.asarray(w, np.float32) for w in floats])
        np.testing.assert_allclose(np.asarray(out["probs"]), direct, atol=1e-6)
        assert out["labels"] == [out["classes"][i] for i in direct.argmax(-1)]
        out = _open(f"{base}/predict", {"waveforms_pcm16": [
            base64.b64encode(w.astype("<i2").tobytes()).decode() for w in pcm]})
        np.testing.assert_allclose(np.asarray(out["probs"]), tp.predict(pcm), atol=1e-6)


def test_http_errors_and_metrics(rng):
    _, tp = _predictors()
    wave = _waves(rng, "float")[0].tolist()
    with _serving(tp) as base:
        m0 = _open(f"{base}/metrics")
        assert m0["requests_total"] == 0 and "device_call_ms" not in m0
        for _ in range(2):
            _open(f"{base}/predict", {"waveforms": [wave]})
        assert _status(f"{base}/predict", {"waveforms": []})[0] == 400
        assert _status(f"{base}/predict", {"waveforms": [wave[:100]]})[0] == 400
        assert _status(f"{base}/predict", {"waveforms": [wave], "seed": "abc"})[0] == 400
        assert _status(f"{base}/predict", {"waveforms_pcm16": ["!!!"]})[0] == 400
        assert _status(f"{base}/nope")[0] == 404
        m = _open(f"{base}/metrics")
        assert m["requests_total"] == 6 and m["errors_total"] == 4
        assert m["device_calls_total"] == 2 and m["waveforms_total"] == 2
        assert m["device_call_ms"]["p99"] >= m["device_call_ms"]["p50"] > 0
        assert m["waveforms_per_device_call"] == {"mean": 1.0, "max": 1}
        assert m["micro_batching"] is None
        # a failing predictor answers 500, not a dropped connection
        tp.model.pred_emotion_layer = None
        code, body = _status(f"{base}/predict", {"waveforms": [wave]})
        assert code == 500 and "error" in body


def test_http_oversized_body_is_refused(rng):
    _, tp = _predictors()
    with _serving(tp, max_body_mb=0.001) as base:
        code, body = _status(f"{base}/predict",
                             {"waveforms": [rng.standard_normal(4000).tolist()]})
        assert code == 400 and "exceeds" in body["error"]


def test_http_stream_session(rng):
    _, tp = _predictors()
    pcm = rng.integers(-20000, 20000, 12000).astype(np.int16)
    with _serving(tp) as base:
        assert _status(f"{base}/stream", raw=b"[1, 2]")[0] == 400
        sid = _open(f"{base}/stream", {})["session"]
        out = _open(f"{base}/stream/{sid}", {"samples": [0.1] * 100})
        assert out == {"samples": 100, "buffered": True, "need_samples": 401}
        assert _open(f"{base}/stream/{sid}", method="DELETE") == {"closed": sid}
        sid = _open(f"{base}/stream", {})["session"]
        outs = [_open(f"{base}/stream/{sid}",
                      {"pcm16": base64.b64encode(pcm[lo:lo + 4000].tobytes()).decode()})
                for lo in range(0, 12000, 4000)]
        assert [o["samples"] for o in outs] == [4000, 8000, 12000]
        np.testing.assert_allclose(outs[-1]["probs"], tp.predict([pcm])[0], atol=1e-5)
        assert outs[-1]["label"] in outs[-1]["classes"]
        out = _open(f"{base}/stream/{sid}", {"samples": [0.01] * 2000})
        assert out["samples"] == 14000  # a float chunk widens the session
        assert _open(f"{base}/stream/{sid}", method="DELETE") == {"closed": sid}
        assert _status(f"{base}/stream/{sid}", {"samples": [0.1, 0.2]})[0] == 404


def test_http_stream_tail_window(rng):
    _, tp = _predictors()
    w = (0.3 * rng.standard_normal(12000)).astype(np.float32)
    with _serving(tp, max_stream_s=1.0) as base:
        sid = _open(f"{base}/stream", {"seed": 3})["session"]
        _open(f"{base}/stream/{sid}", {"samples": w.tolist()})
        out = _open(f"{base}/stream/{sid}", {"samples": w.tolist()})
        assert out["samples"] == 16000
        tail = np.concatenate([w, w])[-16000:]
        np.testing.assert_allclose(out["probs"], tp.predict([tail], seed=3)[0], atol=1e-5)


def test_micro_batching_coalesces_and_keeps_seeds_apart(rng):
    mask = (rng.random((WIN, D)) > 0.3).astype(np.float32)
    _, tp = _cloaked(mask)
    waves = _waves(rng, "float")
    direct = {s: tp.predict(waves, seed=s) for s in (0, 7)}
    calls = []
    real = tp.predict

    def counting(ws, seed=0):
        calls.append((len(ws), seed))
        return real(ws, seed)

    tp.predict = counting
    results = {}
    with _serving(tp, batch_window_ms=300) as base:
        def fire(i, seed):
            results[(i, seed)] = _open(f"{base}/predict", {
                "waveforms": [waves[i].tolist()], "seed": seed})

        threads = [threading.Thread(target=fire, args=(i, s))
                   for s in (0, 7) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert all(not t.is_alive() for t in threads)
        m = _open(f"{base}/metrics")
    assert len(results) == 6
    assert sum(n for n, _ in calls) == 6 and len(calls) < 6, calls
    assert m["batched_requests_total"] >= 2
    for (i, s), r in results.items():
        np.testing.assert_allclose(np.asarray(r["probs"])[0], direct[s][i], atol=1e-5)


def test_micro_batching_propagates_errors(rng):
    _, tp = _predictors()
    tp.model.pred_emotion_layer = None
    wave = _waves(rng, "float")[0].tolist()
    codes = []

    def fire():
        codes.append(_status(f"{base}/predict", {"waveforms": [wave]})[0])

    with _serving(tp, batch_window_ms=100) as base:
        threads = [threading.Thread(target=fire) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    assert codes == [500, 500, 500]
