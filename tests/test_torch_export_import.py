"""The port's export_torch / import_torch against the JAX package's (CPU).

Ports of tests/test_import_torch_cli.py (a ``model.pt`` with the
reference's key layout, hidden 4 and 16 mel bins, through the import CLI;
the GRL cloak wrapper; export(import(sd)) keeping every live tensor; both
``--help``s), plus: the port's export of an artifact equals the JAX
package's ``export_backbone`` / export CLI of the same weights bit for bit,
synthesized tensors included, for the GRU, LSTM and deep models; the
port's import -> export equals the JAX package's import -> export of the
same file; and the import manifest's ``config`` equals the JAX package's.
"""

import json

import numpy as np
import pytest
import torch

from sept_tpu.cli import export_torch as jax_export_cli
from sept_tpu.cli import import_torch as jax_import_cli
from sept_tpu.compat import export_backbone as jax_export_backbone
from sept_tpu.compat import import_backbone as jax_import_backbone
from sept_tpu.train.checkpoint import CheckpointManager as JaxCheckpoints
from sept_tpu_torch.cli import export_torch, import_torch
from sept_tpu_torch.compat.from_jax import backbone_state_dict, cloak_noise_state_dict
from sept_tpu_torch.compat.torch_io import export_backbone, import_backbone
from sept_tpu_torch.models import build_backbone
from sept_tpu_torch.train.checkpoint import CheckpointManager

from _torch_helpers import jax_zoo

H, D = 4, 16
RNN_IN = 128 * D // 8
WIN = 48
DEAD = {"dense2.weight", "dense2.bias", "att_linear1.weight", "att_linear2.weight",
        "att_mat1", "att_mat2"}


def _reference_sd(rnn_cell="gru", deep=False, win_len=200, seed=0):
    """A reference two_d_cnn_lstm-family state_dict skeleton (random
    values), the deep variant with a fourth conv block."""
    g = torch.Generator().manual_seed(seed)
    t = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    sd = {}
    blocks = [(1, 32), (32, 64), (64, 128)] + ([(128, 128)] if deep else [])
    for b, (ci, co) in enumerate(blocks):
        conv, bn = 5 * b, 5 * b + 1
        sd[f"conv.{conv}.weight"] = t(co, ci, 5, 5)
        sd[f"conv.{conv}.bias"] = t(co)
        sd[f"conv.{bn}.weight"] = t(co)
        sd[f"conv.{bn}.bias"] = t(co)
        sd[f"conv.{bn}.running_mean"] = t(co)
        sd[f"conv.{bn}.running_var"] = t(co).abs() + 0.5
        sd[f"conv.{bn}.num_batches_tracked"] = torch.tensor(7)
    gates = 3 if rnn_cell == "gru" else 4
    for layer, nin in ((0, RNN_IN), (1, 2 * H)):
        for suf in ("", "_reverse"):
            sd[f"rnn.weight_ih_l{layer}{suf}"] = t(gates * H, nin)
            sd[f"rnn.weight_hh_l{layer}{suf}"] = t(gates * H, H)
            sd[f"rnn.bias_ih_l{layer}{suf}"] = t(gates * H)
            sd[f"rnn.bias_hh_l{layer}{suf}"] = t(gates * H)
    dense_in = 2 * H * (win_len // 8 if deep else 1)
    sd["dense1.weight"] = t(128, dense_in)
    sd["dense1.bias"] = t(128)
    sd["dense2.weight"] = t(64, 128)  # dead layer, must be ignored
    sd["dense2.bias"] = t(64)
    sd["att_linear1.weight"] = t(16, 2 * H)
    sd["att_linear2.weight"] = t(16, 16)
    sd["att_mat1"] = t(16, 2 * H)
    sd["att_mat2"] = t(16, 16)
    sd["pred_emotion_layer.weight"] = t(4, 128)
    sd["pred_emotion_layer.bias"] = t(4)
    sd["pred_gender_layer.weight"] = t(2, 128)
    sd["pred_gender_layer.bias"] = t(2)
    return sd


def _config(out_dir, artifact, fold):
    with open(out_dir / artifact / f"manifest_fold{fold}.json") as f:
        return json.load(f)["config"]


def _import_both(tmp_path, sd, name, extra=()):
    """The same model.pt through the JAX and the port's import CLI: the two
    manifest configs."""
    pt = tmp_path / f"{name}.pt"
    torch.save(sd, str(pt))
    argv = ["--checkpoint", str(pt), "--artifact", name, *extra]
    assert jax_import_cli.main(argv + ["--output_dir", str(tmp_path / "jax")]) == 0
    assert import_torch.main(argv + ["--output_dir", str(tmp_path / "port")]) == 0
    fold = int(extra[extra.index("--fold") + 1]) if "--fold" in extra else 1
    return _config(tmp_path / "jax", name, fold), _config(tmp_path / "port", name, fold)


def test_import_backbone_cli_roundtrip(tmp_path):
    jcfg, cfg = _import_both(tmp_path, _reference_sd(), "baseline_emotion",
                             ["--fold", "2", "--pred", "emotion"])
    ckpt = CheckpointManager(str(tmp_path / "port"))
    assert ckpt.exists("baseline_emotion", 2)
    got = ckpt.restore("baseline_emotion", 2, "cpu")
    assert got["conv.0.weight"].shape == (32, 1, 5, 5)
    assert got["rnn.weight_ih_l0"].shape == (3 * H, RNN_IN)
    assert got["rnn.weight_ih_l1_reverse"].shape == (3 * H, 2 * H)
    assert got["dense1.weight"].shape == (128, 2 * H)
    assert "pred_gender_layer.weight" not in got  # emotion-only head kept
    assert not DEAD & set(got)
    assert got["conv.11.running_var"].shape == (128,)
    # the manifest carries the inferred architecture under "config", as
    # the JAX package's import writes it, and the state builds from it
    assert cfg == jcfg
    assert (cfg["hidden_size"], cfg["feature_len"], cfg["model_type"]) == (H, D, "2d-cnn-lstm")
    assert cfg["pred"] == "emotion" and cfg["global_feature"] is False
    build_backbone(cfg["model_type"], **{k: cfg[k] for k in (
        "hidden_size", "feature_len", "win_len", "pred", "att", "rnn_cell")}).load_state_dict(got)


def test_import_grl_cloak_cli_roundtrip(tmp_path):
    """Wrapper state_dict (intermed + original_model + GRL-nested gender)."""
    bare = _reference_sd()
    sd = {"intermed.locs": torch.zeros(1, WIN, D), "intermed.rhos": torch.full((1, WIN, D), -2.0)}
    for k, v in bare.items():
        sd[f"original_model.{k}"] = v
        # the GRL wrap nests the gender conv one level deeper
        # (Sequential(GradientReversal, conv) -> conv.1.<i>)
        gk = k.replace("conv.", "conv.1.") if k.startswith("conv.") else k
        sd[f"gender_model.{gk}"] = v
    jcfg, cfg = _import_both(tmp_path, sd, "cloak_grl_lamda1.0_supp0")
    assert cfg == jcfg and cfg["win_len"] == WIN
    got = CheckpointManager(str(tmp_path / "port")).restore("cloak_grl_lamda1.0_supp0", 1, "cpu")
    # the sweep and load_predictor read noise.{locs,rhos}
    assert got["noise.locs"].shape == (1, WIN, D)
    assert torch.equal(got["noise.rhos"], torch.full((1, WIN, D), -2.0))
    assert got["emotion_backbone.conv.0.weight"].shape == (32, 1, 5, 5)
    assert got["gender_backbone.pred_gender_layer.weight"].shape == (2, 128)
    assert "gender_backbone.pred_emotion_layer.weight" not in got
    assert got["gender_backbone.conv.1.running_mean"].shape == (32,)


@pytest.mark.parametrize("rnn_cell,deep", [("gru", False), ("lstm", False), ("lstm", True)],
                         ids=["gru", "lstm", "deep_lstm"])
def test_import_export_roundtrip_preserves_live_tensors(rnn_cell, deep):
    """export(import(sd)) reproduces every live tensor; each RNN gate's bias
    pair is a gauge (only the sum enters the recurrence) and is
    sum-preserved; and the whole export equals the JAX package's
    export(import(sd)) bit for bit."""
    ref = _reference_sd(rnn_cell, deep)
    sd = {k: v.numpy() for k, v in ref.items()}
    back = export_backbone(import_backbone(sd, pred="multitask", rnn_cell=rnn_cell))
    want = jax_export_backbone(jax_import_backbone(sd, pred="multitask", rnn_cell=rnn_cell),
                               rnn_cell=rnn_cell)
    assert set(back) == set(want) == set(sd)
    for k, w in want.items():
        assert back[k].dtype == torch.from_numpy(np.asarray(w)).dtype, k
        np.testing.assert_array_equal(back[k].numpy(), w, err_msg=k)
    for k, v in sd.items():
        if k in DEAD or k.endswith("num_batches_tracked") or ".bias_" in k:
            continue  # dead, zeroed, or checked as sums below
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    for layer in (0, 1):
        for suf in ("", "_reverse"):
            ih, hh = f"rnn.bias_ih_l{layer}{suf}", f"rnn.bias_hh_l{layer}{suf}"
            np.testing.assert_allclose(back[ih].numpy() + back[hh].numpy(), sd[ih] + sd[hh],
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("model_type,rnn_cell", [("2d-cnn-lstm", "gru"),
                                                 ("2d-cnn-lstm", "lstm"),
                                                 ("deep-2d-cnn-lstm", "gru")])
def test_export_cli_matches_jax_export(model_type, rnn_cell, tmp_path):
    """A port artifact of JAX weights through export_torch equals the JAX
    package's export_backbone of the same weights, synthesized tensors
    included; re-imported, it gives back the artifact."""
    _, params, stats = jax_zoo(model_type, H, "emotion", None, WIN, D, rnn_cell=rnn_cell)
    sd = backbone_state_dict(params, stats)
    CheckpointManager(str(tmp_path)).save("baseline_emotion", 1, sd)
    out = tmp_path / "model.pt"
    assert export_torch.main(["--output_dir", str(tmp_path), "--artifact", "baseline_emotion",
                              "--out", str(out), "--rnn_cell", rnn_cell]) == 0
    got = torch.load(str(out), weights_only=True)
    want = jax_export_backbone({"params": params, "batch_stats": stats}, rnn_cell=rnn_cell)
    assert set(got) == set(want)
    for k, w in want.items():
        assert torch.equal(got[k], torch.from_numpy(np.array(w))), k
    again = import_backbone({k: v.numpy() for k, v in got.items()}, rnn_cell=rnn_cell)
    assert set(again) == set(sd)
    for k, v in sd.items():
        assert torch.equal(again[k], v), k
    with pytest.raises(ValueError, match="RNN"):
        export_torch.main(["--output_dir", str(tmp_path), "--artifact", "baseline_emotion",
                           "--out", str(out), "--rnn_cell", "lstm" if rnn_cell == "gru"
                           else "gru"])


def test_export_grl_cloak_cli_matches_jax(tmp_path):
    """A GRL cloak artifact: the port's export CLI and the JAX package's,
    each on its own package's artifact of the same weights, write the same
    model.pt; the port's import of it gives back the artifact."""
    _, params, stats = jax_zoo("2d-cnn-lstm", H, "emotion", None, WIN, D)
    _, gparams, gstats = jax_zoo("2d-cnn-lstm", H, "gender", None, WIN, D, seed=1)
    rng = np.random.default_rng(2)
    noise = {"locs": rng.standard_normal((WIN, D)).astype(np.float32),
             "rhos": rng.standard_normal((WIN, D)).astype(np.float32)}
    JaxCheckpoints(str(tmp_path / "jax")).save(
        "cloak_grl", 1, {"noise": noise, "emotion_backbone": params, "gender_backbone": gparams},
        {"emotion_backbone": stats, "gender_backbone": gstats})
    sd = {f"noise.{k}": v for k, v in cloak_noise_state_dict(noise).items()}
    for sub, (p, s) in (("emotion_backbone", (params, stats)),
                        ("gender_backbone", (gparams, gstats))):
        sd.update({f"{sub}.{k}": v for k, v in backbone_state_dict(p, s).items()})
    CheckpointManager(str(tmp_path / "port")).save("cloak_grl", 1, sd)
    for pkg, cli in (("jax", jax_export_cli), ("port", export_torch)):
        assert cli.main(["--output_dir", str(tmp_path / pkg), "--artifact", "cloak_grl",
                         "--out", str(tmp_path / f"{pkg}.pt")]) == 0
    got = torch.load(str(tmp_path / "port.pt"), weights_only=True)
    want = torch.load(str(tmp_path / "jax.pt"), weights_only=True)
    assert set(got) == set(want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    assert import_torch.main(["--checkpoint", str(tmp_path / "port.pt"), "--output_dir",
                              str(tmp_path / "back"), "--artifact", "cloak_grl"]) == 0
    back = CheckpointManager(str(tmp_path / "back")).restore("cloak_grl", 1, "cpu")
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_import_deep_lstm_config_matches_jax(tmp_path):
    """The deep LSTM variant (deep_two_d_cnn_lstm_tmp): the JAX package's
    dense1 width rule over the trained window length, and the config."""
    jcfg, cfg = _import_both(tmp_path, _reference_sd("lstm", deep=True, win_len=WIN), "deep",
                             ["--rnn_cell", "lstm", "--win_len", str(WIN)])
    assert cfg == jcfg
    assert (cfg["model_type"], cfg["rnn_cell"], cfg["global_feature"]) == (
        "deep-2d-cnn-lstm", "lstm", False)
    got = CheckpointManager(str(tmp_path / "port")).restore("deep", 1, "cpu")
    build_backbone(cfg["model_type"], hidden_size=H, feature_len=D, win_len=WIN,
                   rnn_cell="lstm").load_state_dict(got)


def test_import_torch_help_exits_zero(capsys):
    with pytest.raises(SystemExit) as e:
        import_torch.main(["--help"])
    assert e.value.code == 0
    assert "--checkpoint" in capsys.readouterr().out


def test_export_torch_help_exits_zero(capsys):
    with pytest.raises(SystemExit) as e:
        export_torch.main(["--help"])
    assert e.value.code == 0
    assert "--artifact" in capsys.readouterr().out
