"""The port's load_predictor vs the JAX package's (CPU), on artifacts that
hold the same weights: the JAX trees saved through the JAX package's
CheckpointManager, their :mod:`sept_tpu_torch.compat.from_jax` state_dicts
through the port's, each with the manifest the JAX trainer writes.
Probabilities atol 1e-4; the cloak's mask equal to the JAX package's
eval_mask.  The cloak's epsilon is JAX's draw, injected into the port's
predictor (torch's and JAX's generators differ)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sept_tpu.eval.sweep import eval_mask as jax_eval_mask
from sept_tpu.models import CloakNoise as JaxCloakNoise
from sept_tpu.serve import load_predictor as jax_load_predictor
from sept_tpu.train import ExperimentConfig as JaxConfig
from sept_tpu.train.checkpoint import CheckpointManager as JaxCheckpoints
from sept_tpu.utils.logging import _jsonable
from sept_tpu_torch.compat.from_jax import backbone_state_dict, cloak_noise_state_dict
from sept_tpu_torch.serve import CloakedPredictor, load_predictor
from sept_tpu_torch.train.checkpoint import CheckpointManager

from _torch_helpers import jax_zoo

D, WIN, H = 32, 60, 8


def _manifest(**cfg):
    """The manifest the JAX trainer writes beside a checkpoint."""
    return {"config": _jsonable(JaxConfig(feature_len=D, win_len=WIN, **cfg)),
            "best_epoch": 0}


def _save(tmp_path, artifact, params, stats, manifest=None, port_sd=None):
    """Save the same weights as a JAX and as a port artifact: (jax_dir,
    port_dir)."""
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JaxCheckpoints(jdir).save(artifact, 1, params, stats, manifest=manifest)
    sd = port_sd if port_sd is not None else backbone_state_dict(params, stats)
    CheckpointManager(pdir).save(artifact, 1, sd, manifest=manifest)
    return jdir, pdir


def _waves(rng, n=2):
    return [(0.3 * rng.standard_normal(12000 + 2500 * i)).astype(np.float32) for i in range(n)]


def _inject_jax_eps(predictor, noise_params, seed):
    """Make the port's cloaked predictor take the epsilon that the JAX
    package's CloakedPredictor draws from ``seed`` (its CloakNoise's
    ``make_rng("noise")``)."""
    def draw(m):
        return m.eps_std * jax.random.normal(m.make_rng("noise"), m.rhos.shape, jnp.float32)

    eps = np.array(JaxCloakNoise(WIN, D, max_scale=5.0).apply(
        {"params": noise_params}, method=draw, rngs={"noise": jax.random.PRNGKey(seed)}))

    def noise(windows, _seed):
        b, w = windows.shape[:2]
        flat = windows.reshape(b * w, WIN, D)
        return predictor.noise(flat, predictor.mask, eps=torch.from_numpy(eps)).reshape(
            windows.shape)

    predictor._noise = noise


def _cloak_artifacts(tmp_path, params, stats):
    """A plain cloak and a GRL cloak artifact over the same backbone, varied
    scales so the percentile mask has something to suppress."""
    rng = np.random.default_rng(3)
    noise = {"locs": (0.1 * rng.standard_normal((WIN, D))).astype(np.float32),
             "rhos": np.linspace(-2.0, 2.0, WIN * D, dtype=np.float32).reshape(WIN, D)}
    _, gparams, gstats = jax_zoo("2d-cnn-lstm", H, "gender", None, WIN, D, seed=1)
    trees = {
        "cloak_lamda0.1_supp40": ({"noise": noise, "backbone": params},
                                  {"backbone": stats}),
        "cloak_grl_lamda0.1_supp40": ({"noise": noise, "emotion_backbone": params,
                                       "gender_backbone": gparams},
                                      {"emotion_backbone": stats, "gender_backbone": gstats}),
    }
    for name, (p, s) in trees.items():
        sd = {f"noise.{k}": v for k, v in cloak_noise_state_dict(noise).items()}
        for sub in p:
            if sub != "noise":
                sd.update({f"{sub}.{k}": v
                           for k, v in backbone_state_dict(p[sub], s[sub]).items()})
        _save(tmp_path, name, p, s, port_sd=sd)
    return noise


def test_load_predictor_from_artifacts(rng, tmp_path):
    """Clean and cloaked predictors rebuilt from the artifact layout, with
    overrides and without a manifest, against the JAX package's."""
    _, params, stats = jax_zoo("2d-cnn-lstm", H, "emotion", None, WIN, D)
    jdir, pdir = _save(tmp_path, "baseline_emotion", params, stats)
    noise = _cloak_artifacts(tmp_path, params, stats)
    kw = dict(hidden_size=H, feature_len=D, win_len=WIN)
    waves = _waves(rng)
    want = jax_load_predictor(jdir, **kw).predict(waves)
    clean = load_predictor(pdir, device="cpu", **kw)
    np.testing.assert_allclose(clean.predict(waves), want, atol=1e-4)
    scales = np.asarray((1.0 + jnp.tanh(noise["rhos"])) / 2.0 * (5.0 - 0.01) + 0.01)
    for cloak in ("cloak_lamda0.1_supp40", "cloak_grl_lamda0.1_supp40"):
        jp = jax_load_predictor(jdir, cloak_artifact=cloak, suppression_ratio=40, **kw)
        tp = load_predictor(pdir, cloak_artifact=cloak, suppression_ratio=40, device="cpu",
                            **kw)
        assert isinstance(tp, CloakedPredictor)
        mask = tp.mask.numpy()
        np.testing.assert_array_equal(mask, jax_eval_mask(scales, 40))
        np.testing.assert_array_equal(mask, np.asarray(jp.mask))
        assert 0.0 < mask.mean() < 1.0
        _inject_jax_eps(tp, noise, seed=4)
        got = tp.predict(waves, seed=4)
        np.testing.assert_allclose(got, jp.predict(waves, seed=4), atol=1e-4)
        assert np.abs(got - clean.predict(waves)).max() > 1e-5


def test_load_predictor_reads_training_manifest(rng, tmp_path):
    """No overrides: the model is built from the manifest; overrides beat
    it; global_feature and unknown overrides are refused as in JAX."""
    _, params, stats = jax_zoo("2d-cnn-lstm", 16, "gender", None, WIN, D)
    manifest = _manifest(model_type="2d-cnn-lstm", pred="gender", hidden_size=16)
    jdir, pdir = _save(tmp_path, "adv_baseline_gender", params, stats, manifest)
    p = load_predictor(pdir, "adv_baseline_gender", 1, device="cpu")
    assert p.model.rnn.hidden_size == 16 and p.model.pred == "gender"
    assert (p.win_len, p.shift_len, p.feature_len) == (WIN, WIN // 4, D)
    waves = _waves(rng)
    got = p.predict(waves)
    assert got.shape == (2, 2)
    np.testing.assert_allclose(got, jax_load_predictor(jdir, "adv_baseline_gender", 1)
                               .predict(waves), atol=1e-4)
    # overrides take precedence over the manifest, shift_len follows win_len
    o = load_predictor(pdir, "adv_baseline_gender", 1, device="cpu", win_len=40)
    assert (o.win_len, o.shift_len) == (40, 10)
    np.testing.assert_allclose(o.predict(waves), jax_load_predictor(
        jdir, "adv_baseline_gender", 1, win_len=40).predict(waves), atol=1e-4)

    with pytest.raises(TypeError, match="unknown"):
        load_predictor(pdir, "adv_baseline_gender", 1, device="cpu", hidden_sizes=32)
    with pytest.raises(TypeError, match="unknown"):
        load_predictor(pdir, "adv_baseline_gender", 1, device="cpu", rnn_cell="gru")
    import json

    for d in (jdir, pdir):
        with open(f"{d}/adv_baseline_gender/manifest_fold1.json", "w") as f:
            json.dump({"config": {"global_feature": True}}, f)
    with pytest.raises(ValueError, match="global_feature"):
        jax_load_predictor(jdir, "adv_baseline_gender", 1)
    with pytest.raises(ValueError, match="global_feature"):
        load_predictor(pdir, "adv_baseline_gender", 1, device="cpu")


def test_lstm_artifact_is_refused_where_jax_fails(rng, tmp_path):
    """An imported deep LSTM artifact (rnn_cell "lstm" in its manifest): the
    JAX package's Predictor builds a GRU and fails when it applies the
    parameters; the port refuses it by name."""
    from sept_tpu.cli import import_torch as jax_import
    from sept_tpu_torch.cli import import_torch
    from sept_tpu_torch.compat.torch_io import export_backbone

    _, params, stats = jax_zoo("deep-2d-cnn-lstm", H, "emotion", None, WIN, D, rnn_cell="lstm")
    pt = tmp_path / "model.pt"
    torch.save(export_backbone(backbone_state_dict(params, stats)), str(pt))
    argv = ["--checkpoint", str(pt), "--artifact", "baseline_emotion", "--rnn_cell", "lstm",
            "--win_len", str(WIN)]
    assert jax_import.main(argv + ["--output_dir", str(tmp_path / "jax")]) == 0
    assert import_torch.main(argv + ["--output_dir", str(tmp_path / "port")]) == 0
    with pytest.raises(Exception):
        jax_load_predictor(str(tmp_path / "jax")).predict(_waves(rng, 1))
    with pytest.raises(ValueError, match="lstm"):
        load_predictor(str(tmp_path / "port"), device="cpu")


def test_deep_model_predictor_uses_flatten_pooling(rng, tmp_path):
    """A deep artifact is served with flatten pooling (dense1 is 2H *
    win_len // 8 wide) and matches the JAX package's predictor."""
    _, params, stats = jax_zoo("deep-2d-cnn-lstm", H, "emotion", None, WIN, D)
    manifest = _manifest(model_type="deep-2d-cnn-lstm", hidden_size=H)
    jdir, pdir = _save(tmp_path, "baseline_emotion", params, stats, manifest)
    p = load_predictor(pdir, device="cpu")
    assert p.pooling is None and p.model.dense1.in_features == 2 * H * (WIN // 8)
    waves = _waves(rng)
    got = p.predict(waves)
    assert got.shape == (2, 4)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, jax_load_predictor(jdir).predict(waves), atol=1e-4)


def test_multitask_predictor_and_server(rng, tmp_path):
    """A multitask artifact serves both heads: a dict from predict(), a
    block per task over HTTP, equal to the JAX package's predictor."""
    import json
    import threading
    import urllib.request

    from sept_tpu_torch.serve import PredictionServer

    _, params, stats = jax_zoo("2d-cnn-lstm", H, "multitask", "self_att", WIN, D)
    manifest = _manifest(model_type="cnn-lstm-att", pred="multitask", att="self_att",
                         hidden_size=H)
    jdir, pdir = _save(tmp_path, "baseline_multitask", params, stats,
                       json.loads(json.dumps(manifest)))
    p = load_predictor(pdir, "baseline_multitask", device="cpu")
    waves = _waves(rng)
    out, want = p.predict(waves), jax_load_predictor(jdir, "baseline_multitask").predict(waves)
    assert set(out) == {"emotion", "gender"}
    for task in out:
        np.testing.assert_allclose(out[task], want[task], atol=1e-4)
    server = PredictionServer(p, port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        req = urllib.request.Request(
            f"http://{server.host}:{server.port}/predict",
            data=json.dumps({"waveforms": [w.tolist() for w in waves]}).encode())
        body = json.load(urllib.request.urlopen(req, timeout=60))
        assert set(body["tasks"]) == {"emotion", "gender"}
        np.testing.assert_allclose(body["tasks"]["emotion"]["probs"], out["emotion"], atol=1e-6)
        assert body["tasks"]["gender"]["classes"] == ["F", "M"]
    finally:
        server.shutdown()
        t.join(10)
