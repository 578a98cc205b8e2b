"""The port's serve and predict command lines against the JAX package's (CPU):
the option sets (and export_torch's and import_torch's), cli.serve's own
code path on port 0 in a thread, and ports of tests/test_cli_predict.py (a
WAV directory to the CSV, a corpus walk, the refusal without a source).
Probabilities: the port's CLIs against its in-process predictor within
1e-5, against the JAX package's predictor of the same weights within 1e-4."""

import argparse
import base64
import csv
import json
import os
import threading
import urllib.request

import numpy as np
import pytest

from sept_tpu.cli import export_torch as jexport_torch
from sept_tpu.cli import import_torch as jimport_torch
from sept_tpu.cli import predict as jpredict
from sept_tpu.cli import serve as jserve
from sept_tpu.serve import Predictor as JaxPredictor
from sept_tpu_torch.cli import export_torch, import_torch, predict, serve
from sept_tpu_torch.compat.from_jax import backbone_state_dict
from sept_tpu_torch.runtime.wavio import decode_wav, write_wav
from sept_tpu_torch.serve import load_predictor
from sept_tpu_torch.train.checkpoint import CheckpointManager

from _torch_helpers import jax_zoo

D, WIN, H = 32, 60, 8
CLASSES = ("neu", "hap", "sad", "ang")
# the port's flags beyond the JAX CLI's
PAIRS = {"serve": (serve.make_server, jserve.main, {"--device"}),
         "predict": (predict.main, jpredict.main, {"--device"}),
         "export_torch": (export_torch.main, jexport_torch.main, set()),
         "import_torch": (import_torch.main, jimport_torch.main, set())}


def options(main, monkeypatch):
    """The option strings of ``main``'s parser, read where it parses."""
    seen = {}

    def grab(self, args=None, namespace=None):
        seen["opts"] = {s for a in self._actions for s in a.option_strings}
        raise SystemExit(0)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(SystemExit):
            main([])
    return seen["opts"]


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_options_are_jax_plus_device(name, monkeypatch):
    ours, theirs, extra = PAIRS[name]
    assert options(ours, monkeypatch) == options(theirs, monkeypatch) | extra


def _artifact(out_dir):
    """A baseline_emotion artifact of JAX weights with the trainer's
    manifest keys; returns the JAX package's predictor of the same
    weights."""
    _, params, stats = jax_zoo("2d-cnn-lstm", H, "emotion", None, WIN, D)
    CheckpointManager(str(out_dir)).save("baseline_emotion", 1, backbone_state_dict(params, stats),
                                         manifest={"config": {
                                             "model_type": "2d-cnn-lstm", "pred": "emotion",
                                             "hidden_size": H, "feature_len": D, "win_len": WIN,
                                             "att": None, "global_feature": False}})
    return JaxPredictor(params, stats, hidden_size=H, feature_len=D, win_len=WIN,
                        shift_len=WIN // 4)


def _post(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    return json.load(urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=60))


def test_serve_cli_answers_healthz_and_predict(rng, tmp_path):
    """cli.serve's code path (manifest, warmup, micro-batching) on port 0:
    /healthz, then concurrent pcm16 /predict requests, each equal to a direct
    predict."""
    jp = _artifact(tmp_path)
    server = serve.make_server(["--output_dir", str(tmp_path), "--port", "0", "--device", "cpu",
                                "--warmup", "1", "--warmup_rows", "2",
                                "--batch_window_ms", "5"])
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://{server.host}:{server.port}"
    waves = [(0.3 * rng.standard_normal(12000 + 1500 * i) * 20000).astype(np.int16)
             for i in range(4)]
    results = {}
    try:
        assert _post(f"{base}/healthz") == {"status": "ok", "pred": "emotion", "cloaked": False}

        def fire(i):
            results[i] = _post(f"{base}/predict", {"waveforms_pcm16": [
                base64.b64encode(waves[i].astype("<i2").tobytes()).decode()]})

        threads = [threading.Thread(target=fire, args=(i,)) for i in range(len(waves))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
    finally:
        server.shutdown()
        t.join(10)
    assert not t.is_alive()
    direct = load_predictor(str(tmp_path), device="cpu")
    for i, w in enumerate(waves):
        assert results[i]["classes"] == list(CLASSES)
        np.testing.assert_allclose(results[i]["probs"], direct.predict([w]), atol=1e-5)
        np.testing.assert_allclose(results[i]["probs"], jp.predict([w]), atol=1e-4)


def _read(out_csv):
    with open(out_csv) as f:
        return {r["utt_id"]: r for r in csv.DictReader(f)}


def _probs(row):
    return np.asarray([float(row[f"p_{c}"]) for c in CLASSES])


def test_predict_cli_wav_dir(rng, tmp_path):
    jp = _artifact(tmp_path)
    wav_dir = tmp_path / "clips"
    (wav_dir / "sub").mkdir(parents=True)
    for name in ("a", "sub/b", "c"):
        write_wav(str(wav_dir / f"{name}.wav"), (0.3 * rng.standard_normal(12000)).astype(np.float32))
    write_wav(str(wav_dir / "tiny.wav"), np.zeros(100, np.float32))  # under n_fft // 2 + 1
    out_csv = tmp_path / "preds.csv"
    predict.main(["--output_dir", str(tmp_path), "--wav_dir", str(wav_dir), "--out",
                  str(out_csv), "--batch_size", "2", "--device", "cpu"])
    rows = _read(out_csv)
    assert set(rows) == {"a", os.path.join("sub", "b"), "c"}
    p = load_predictor(str(tmp_path), device="cpu")
    for name in ("a", os.path.join("sub", "b"), "c"):
        dec, _ = decode_wav(str(wav_dir / f"{name}.wav"))
        want = p.predict([dec])[0]
        got = _probs(rows[name])
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_allclose(got, jp.predict([dec])[0], atol=1e-4)
        assert rows[name]["label"] == CLASSES[int(want.argmax())]


def test_predict_cli_walks_a_corpus(rng, tmp_path):
    """--dataset / --corpus_root through the port's walkers: CREMA-D's layout,
    int16 staging of the 16-bit files."""
    jp = _artifact(tmp_path)
    root = tmp_path / "crema"
    root.mkdir()
    (root / "VideoDemographics.csv").write_text(
        "ActorID,Age,Sex,Race,Ethnicity\n1001,30,Male,x,y\n1002,30,Female,x,y\n")
    names = ["1001_DFA_ANG_XX", "1002_IEO_SAD_XX", "1001_IEO_HAP_XX"]
    for n in names:
        write_wav(str(root / f"{n}.wav"), (0.3 * rng.standard_normal(14000)).astype(np.float32))
    out_csv = tmp_path / "crema.csv"
    predict.main(["--output_dir", str(tmp_path), "--dataset", "crema-d", "--corpus_root",
                  str(root), "--out", str(out_csv), "--device", "cpu"])
    rows = _read(out_csv)
    assert len(rows) == len(names)
    by_path = {r["path"]: r for r in rows.values()}
    for n in names:
        dec, _ = decode_wav(str(root / f"{n}.wav"))
        pcm = np.rint(dec * 32768).astype(np.int16)
        np.testing.assert_allclose(_probs(by_path[str(root / f"{n}.wav")]),
                                   jp.predict([pcm])[0], atol=1e-4)


def test_predict_cli_requires_a_source(tmp_path):
    with pytest.raises(SystemExit):
        predict.main(["--output_dir", str(tmp_path), "--device", "cpu"])
