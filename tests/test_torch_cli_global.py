"""The global feature through the port's command lines (CPU):

- ``featurize`` with its defaults (``--functionals 1``) on the synthetic
  corpus writes ``gemaps`` (88,) and ``emobase`` (988,) for every
  utterance, within rtol = atol = 2e-3 of the JAX CLI's store
  (tests/test_functionals.py's device-vs-oracle bound);
- ``run_all --global_feature 1`` for fold 1, one epoch a stage, writes
  artifacts whose manifests say ``global_feature`` and whose ``dense1``
  takes the pooled width plus 88, and its sweep CSV is, byte for byte, the
  one the port's in-process sweep (``SweepModel`` + ``evaluate_cloaked_test``
  with ``use_global``) writes from those artifacts.
"""

import argparse
import dataclasses
import json

import numpy as np
import pytest

from sept_tpu.cli import featurize as jfeaturize
from sept_tpu.data import store as jstore
from sept_tpu_torch.cli import featurize, run_all
from sept_tpu_torch.cli.common import add_common_args, config_from_args
from sept_tpu_torch.cli.train_baseline import artifact_name
from sept_tpu_torch.cli.train_cloak import cloak_artifact
from sept_tpu_torch.data import store
from sept_tpu_torch.eval import sweep as S
from sept_tpu_torch.models import N_GLOBAL, Conv2dBiRNN
from sept_tpu_torch.train.checkpoint import CheckpointManager

from test_torch_cli import RATIOS, SMALL

GLOBAL = SMALL + RATIOS + ["--global_feature", "1"]


def test_featurize_defaults_write_jax_functionals(tmp_path):
    args = ["--dataset", "synthetic", "--input_spec_size", "32", "--seed", "8",
            "--n_speakers", "4", "--utts_per_speaker", "2"]
    featurize.main(args + ["--work_dir", str(tmp_path / "ours"), "--device", "cpu"])
    jfeaturize.main(args + ["--work_dir", str(tmp_path / "theirs")])
    rel = "feature/mel_spec/synthetic/data_32.npz"
    ours = store.load_feature_store(str(tmp_path / "ours" / rel))
    theirs = jstore.load_feature_store(str(tmp_path / "theirs" / rel))
    assert ours.keys() == theirs.keys() and len(ours) == 8
    for u in ours:
        assert ours[u].keys() == theirs[u].keys() == {"mel1", "mel2", "gemaps", "emobase"}
        for k, width in (("gemaps", 88), ("emobase", 988)):
            assert ours[u][k].shape == theirs[u][k].shape == (width,)
            np.testing.assert_allclose(ours[u][k], theirs[u][k], rtol=2e-3, atol=2e-3,
                                       err_msg=f"{u} {k}")


@pytest.fixture(scope="module")
def run_all_global(tmp_path_factory):
    root = tmp_path_factory.mktemp("run_all_global")
    run_all.main(GLOBAL + ["--work_dir", str(root / "work"), "--output_dir",
                           str(root / "results"), "--device", "cpu"])
    return root


def _cfg():
    p = argparse.ArgumentParser()
    add_common_args(p)
    p.add_argument("--grl", type=int, default=0)
    p.add_argument("--ratios", type=int, nargs="*")
    args = p.parse_args(GLOBAL)
    return config_from_args(args, grl=bool(args.grl))


def test_run_all_global_feature_artifacts(run_all_global):
    cfg = _cfg()
    assert cfg.global_feature
    ckpt = CheckpointManager(str(run_all_global / "results"))
    for adv, pred in ((False, "emotion"), (True, "gender")):
        name = artifact_name(dataclasses.replace(cfg, adv=adv, pred=pred))
        sd = ckpt.restore(name, 1, "cpu")
        assert sd["dense1.weight"].shape == (128, 2 * cfg.hidden_size + N_GLOBAL)
    for r in (0, 20):
        name = cloak_artifact(dataclasses.replace(cfg, suppression_ratio=r))
        manifest = json.loads((run_all_global / "results" / name / "manifest_fold1.json")
                              .read_text())
        assert manifest["config"]["global_feature"] is True
        assert ckpt.restore(name, 1, "cpu")["gender_backbone.dense1.weight"].shape[1] == (
            2 * cfg.hidden_size + N_GLOBAL)
    fold = store.load_fold(str(run_all_global / "work" / "folds" / "synthetic" / "fold1.npz"))
    for split in (fold.training, fold.test):
        assert split.global_data.shape[1] == N_GLOBAL and np.abs(split.global_data).max() > 0


def test_run_all_global_feature_sweep_csv_is_the_in_process_sweep(run_all_global, tmp_path):
    cfg = _cfg()
    results = run_all_global / "results"
    ckpt = CheckpointManager(str(results))
    fold = store.load_fold(str(run_all_global / "work" / "folds" / "synthetic" / "fold1.npz"))
    kw = dict(hidden_size=cfg.hidden_size, feature_len=cfg.feature_len, global_dim=N_GLOBAL)
    model = S.SweepModel(Conv2dBiRNN(pred="emotion", **kw), Conv2dBiRNN(pred="gender", **kw),
                         cfg.win_len, cfg.feature_len)
    per_ratio = {}
    for r in (0, 20):
        model.load_cell(
            ckpt.restore(cloak_artifact(dataclasses.replace(cfg, suppression_ratio=r)), 1, "cpu"),
            ckpt.restore(artifact_name(dataclasses.replace(cfg, adv=False, pred="emotion")), 1,
                         "cpu"),
            ckpt.restore(artifact_name(dataclasses.replace(cfg, adv=True, pred="gender")), 1,
                         "cpu"))
        mask = S.eval_mask(model.noise.scales().detach()[0].numpy(), r)
        per_ratio[r] = [S.evaluate_cloaked_test(model, fold.test, mask, cfg.win_len,
                                                cfg.shift_len, noise_seed=cfg.seed,
                                                use_global=True)]
    S.rows_to_csv(S.sweep_to_rows(per_ratio, "synthetic"), str(tmp_path / "in_process.csv"))
    assert (results / "grl-0.1.csv").read_text() == (tmp_path / "in_process.csv").read_text()
