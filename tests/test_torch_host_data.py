"""The port's host data against the JAX package's, on the same seeded numpy
inputs: corpora parsers, windowing, normalization, class balancing, the
fold planner (scikit-learn's KFold restated in numpy), fold assembly,
combine mode, batching, the stores (written by one package, read by the
other) and the synthetic corpora."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from sklearn.model_selection import KFold

from sept_tpu.data import augment as jaugment
from sept_tpu.data import combine as jcombine
from sept_tpu.data import corpora as jcorpora
from sept_tpu.data import normalize as jnormalize
from sept_tpu.data import pipeline as jpipeline
from sept_tpu.data import splits as jsplits
from sept_tpu.data import store as jstore
from sept_tpu.data import synthetic as jsynthetic
from sept_tpu.data import windowing as jwindowing
from sept_tpu_torch.data import augment, combine, corpora, normalize, pipeline, splits, store
from sept_tpu_torch.data import synthetic, windowing

from _torch_helpers import assert_folds_equal

ROOT = Path(__file__).resolve().parents[1]


IEMOCAP_TEXT = (
    "% header\n"
    "[6.2901 - 8.2357]\tSes01F_impro01_F000\tneu\t[2.5, 2.5, 2.5]\n"
    "[10.01 - 11.39]\tSes01F_impro01_M001\texc\t[2.5, 2.5, 2.5]\n"
    "[12.0 - 13.0]\tSes01F_script01_F002\tang\t[1, 1, 1]\n"
    "[14.0 - 15.0]\tSes02M_impro03_M010\tfru\t[1, 1, 1]\n"
    "[16.0 - 17.5]\tSes02M_impro03_F011\tsad\t[1, 1, 1]\n"
)


@pytest.mark.parametrize("case", ["iemocap", "crema-d", "msp-improv", "msp-podcast"])
def test_corpus_parsers_match_jax(case):
    if case == "iemocap":
        ours = corpora.parse_iemocap_evaluation(IEMOCAP_TEXT)
        theirs = jcorpora.parse_iemocap_evaluation(IEMOCAP_TEXT)
        assert len(ours) == 3
    elif case == "crema-d":
        demo = {1001: "Male", 1002: "Female"}
        names = ["1001_DFA_ANG_XX", "1002_IEO_HAP_HI", "1002_IEO_DIS_MD", "1001_TIE_NEU_XX",
                 "1002_MTI_SAD_LO", "1001_WSI_FEA_XX"]
        ours = [corpora.parse_crema_d_filename(n, demo) for n in names]
        theirs = [jcorpora.parse_crema_d_filename(n, demo) for n in names]
    elif case == "msp-improv":
        names = ["MSP-IMPROV-S01A-F01-S-FM01", "MSP-IMPROV-S01A-F01-P-FM01",
                 "MSP-IMPROV-S05H-M03-T-MX02", "MSP-IMPROV-S02N-M01-R-MF01",
                 "MSP-IMPROV-S03X-F02-S-FM03"]
        ours = [corpora.parse_msp_improv_filename(n) for n in names]
        theirs = [jcorpora.parse_msp_improv_filename(n) for n in names]
    else:
        rows = [("a.wav", "N", "spk1", "Female", "Train"), ("b.wav", "X", "spk1", "Male", "Train"),
                ("c.wav", "A", "Unknown", "Male", "Train"), ("d.wav", "H", "spk2", "Male", "Test2"),
                ("e.wav", "S", "spk3", "Male", "Test1")]
        counts = {"spk1": 12, "spk3": 3}
        ours = [corpora.parse_msp_podcast_row(*r, speaker_counts=counts) for r in rows]
        theirs = [jcorpora.parse_msp_podcast_row(*r, speaker_counts=counts) for r in rows]
        ours += [corpora.parse_msp_podcast_row(*rows[-1])]
        theirs += [jcorpora.parse_msp_podcast_row(*rows[-1])]
    assert [u and dataclasses.astuple(u) for u in ours] == \
        [u and dataclasses.astuple(u) for u in theirs]
    assert any(u is not None for u in ours)
    assert corpora.EMO_LABELS == jcorpora.EMO_LABELS
    assert corpora.GENDER_LABELS == jcorpora.GENDER_LABELS


@pytest.mark.parametrize("t", [17, 50, 51, 149, 333])
@pytest.mark.parametrize("shift", [True, False])
def test_window_utterance_matches_jax(t, shift):
    data = np.random.default_rng(t).standard_normal((t, 12)).astype(np.float32)
    for win in (50, 64):
        ours = windowing.window_utterance(data, win, shift=shift)
        theirs = jwindowing.window_utterance(data, win, shift=shift)
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
        assert windowing.num_windows(t, win, win // 4, shift) == \
            jwindowing.num_windows(t, win, win // 4, shift)


@pytest.mark.parametrize("norm", ["znorm", "min_max", "l2"])
def test_norm_matches_jax(norm):
    rng = np.random.default_rng(3)
    frames = {f"s{i}": [rng.standard_normal((n, 8)).astype(np.float32) * (i + 1)
                        for n in (5, 9, 1)] for i in range(3)}
    ours, theirs = normalize.accumulate_stats(frames), jnormalize.accumulate_stats(frames)
    data = rng.standard_normal((4, 7, 8)).astype(np.float32)
    for spk in frames:
        for f in ("mean", "std", "min", "max"):
            assert np.array_equal(getattr(ours[spk], f), getattr(theirs[spk], f))
        if norm == "l2":
            for fn, st in ((normalize.apply_norm, ours), (jnormalize.apply_norm, theirs)):
                with pytest.raises(ValueError, match="unknown norm"):
                    fn(data, st[spk], norm)
            continue
        a = normalize.apply_norm(data, ours[spk], norm)
        b = jnormalize.apply_norm(data, theirs[spk], norm)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(normalize.apply_global_norm(data[0, 0], ours[spk]),
                              jnormalize.apply_global_norm(data[0, 0], theirs[spk]))


@pytest.mark.parametrize("seed", [0, 1, 8])
def test_balance_classes_takes_the_same_draws(seed):
    rng = np.random.default_rng(seed)
    n = 37
    windows = rng.standard_normal((n, 6, 4)).astype(np.float32)
    labels = rng.choice(4, n, p=[0.5, 0.25, 0.15, 0.1]).astype(np.int32)
    extra = {"gen": rng.integers(0, 2, n).astype(np.int32),
             "spk": np.array([f"s{i % 5}" for i in range(n)], object)}
    w1, l1, e1 = augment.balance_classes(windows, labels, np.random.default_rng(seed), extra=extra)
    w2, l2, e2 = jaugment.balance_classes(windows, labels, np.random.default_rng(seed),
                                          extra=extra)
    assert len(w1) == 4 * np.bincount(labels).max() > n
    assert np.array_equal(w1, w2) and np.array_equal(l1, l2)
    assert e1.keys() == e2.keys() and all(np.array_equal(e1[k], e2[k]) for k in e1)


@pytest.mark.parametrize("n", [10, 12, 91, 7])
@pytest.mark.parametrize("seed", [None, 8, 3])
def test_kfold_splits_match_sklearn(n, seed):
    for k in range(2, min(n, 10) + 1):
        kf = KFold(n_splits=k, shuffle=seed is not None, random_state=seed)
        ours = list(splits.kfold_splits(n, k, seed))
        theirs = list(kf.split(np.arange(n)))
        assert len(ours) == len(theirs) == k
        for (a, b), (c, d) in zip(ours, theirs):
            assert np.array_equal(a, c) and np.array_equal(b, d)
    for bad in (1, n + 1):
        with pytest.raises(ValueError):
            list(splits.kfold_splits(n, bad, seed))


@pytest.mark.parametrize("n_folds", range(2, 11))
@pytest.mark.parametrize("dataset", ["iemocap", "crema-d", "msp-improv"])
def test_plan_folds_match_jax(dataset, n_folds):
    for validate in (True, False):
        ours = splits.plan_folds(dataset, n_folds, validate)
        theirs = jsplits.plan_folds(dataset, n_folds, validate)
        assert [dataclasses.astuple(p) for p in ours] == [dataclasses.astuple(p) for p in theirs]


def test_plan_folds_without_sklearn():
    """The port plans its folds with scikit-learn blocked, as on a machine
    that does not have it, and gets JAX's plans."""
    code = (
        "import json, sys, dataclasses\n"
        "sys.modules['sklearn'] = None\n"
        "from sept_tpu_torch.data.splits import plan_folds\n"
        "print(json.dumps({d: [dataclasses.astuple(p) for p in plan_folds(d)]\n"
        "                  for d in ('iemocap', 'crema-d', 'msp-improv')}))\n"
        "assert 'sklearn' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout)
    want = {d: [dataclasses.astuple(p) for p in jsplits.plan_folds(d)]
            for d in ("iemocap", "crema-d", "msp-improv")}
    assert got == json.loads(json.dumps(want))


@pytest.mark.parametrize("dataset", ["iemocap", "crema-d", "msp-improv"])
def test_speaker_ids_for_matches_jax(dataset):
    for plan in splits.plan_folds(dataset):
        for attr in ("train", "validation", "adv_train", "adv_validation", "test"):
            idx = getattr(plan, attr)
            assert splits.speaker_ids_for(dataset, idx) == jsplits.speaker_ids_for(dataset, idx)
    with pytest.raises(ValueError):
        splits.speaker_ids_for("synthetic", [0])


def seeded_corpus(seed=5, n_spk=10, utts=5, feature_len=16, gemaps=True, dataset="synthetic",
                  speakers=None):
    """(port manifest, JAX manifest, store) of seeded feature matrices:
    mel1 and mfcc (D, T) with T of 20-130 frames, optionally gemaps."""
    rng = np.random.default_rng(seed)
    speakers = speakers or [f"spk{i}" for i in range(n_spk)]
    labels = list(corpora.EMO_LABELS)
    ours, theirs, feats = [], [], {}
    for i, spk in enumerate(speakers):
        for u in range(utts):
            uid = f"{dataset}_{spk}_{u}"
            rec = (uid, labels[int(rng.integers(0, 4))], "FM"[i % 2], spk, dataset)
            ours.append(corpora.Utterance(*rec))
            theirs.append(jcorpora.Utterance(*rec))
            t = int(rng.integers(20, 130))
            feats[uid] = {"mel1": rng.standard_normal((feature_len, t)).astype(np.float32) * 3,
                          "mfcc": rng.standard_normal((120, t)).astype(np.float32)}
            if gemaps:
                feats[uid]["gemaps"] = rng.standard_normal(88).astype(np.float32)
    return ours, theirs, feats


def synthetic_plan(pkg, speakers):
    return pkg.FoldPlan(fold=2, train=tuple(speakers[3:6]), validation=(speakers[6],),
                        adv_train=tuple(speakers[7:9]), adv_validation=(speakers[9],),
                        test=tuple(speakers[:3]))


@pytest.mark.parametrize("shift", [True, False])
@pytest.mark.parametrize("aug", ["emotion", "gender", None])
@pytest.mark.parametrize("gemaps", [True, False])
def test_assemble_fold_matches_jax(gemaps, aug, shift):
    ours_m, theirs_m, feats = seeded_corpus(gemaps=gemaps)
    spk = [f"spk{i}" for i in range(10)]
    kw = dict(feature_len=16, win_len=40, aug=aug, shift=shift, seed=3)
    ours = pipeline.assemble_fold(ours_m, feats, synthetic_plan(splits, spk), **kw)
    theirs = jpipeline.assemble_fold(theirs_m, feats, synthetic_plan(jsplits, spk), **kw)
    assert_folds_equal(ours, theirs)
    assert len(ours.training) and len(ours.test) == 15
    assert np.all(ours.training.global_data == 0.0) != gemaps


@pytest.mark.parametrize("feature_type,norm", [("mfcc", "znorm"), ("mel_spec", "min_max")])
def test_assemble_fold_on_a_named_corpus_matches_jax(feature_type, norm):
    """IEMOCAP's speaker table maps the plan's indices; the MFCC path keeps
    its first 40 coefficients."""
    ours_m, theirs_m, feats = seeded_corpus(dataset="iemocap", utts=3, feature_len=40,
                                            speakers=list(splits.IEMOCAP_SPEAKERS))
    plan = splits.plan_folds("iemocap")[1]
    kw = dict(dataset="iemocap", feature_type=feature_type, feature_len=40, win_len=32,
              norm=norm, seed=1)
    assert_folds_equal(pipeline.assemble_fold(ours_m, feats, plan, **kw),
                       jpipeline.assemble_fold(theirs_m, feats, jsplits.plan_folds("iemocap")[1],
                                               **kw))


def two_corpus_folds():
    out = {}
    for pkg, corpora_of, pipe in (("port", 0, pipeline), ("jax", 1, jpipeline)):
        folds = []
        for k, ds in enumerate(("corpus_a", "corpus_b")):
            spk = [f"{ds}{i}" for i in range(10)]
            m = seeded_corpus(seed=11 + k, dataset=ds, speakers=spk)
            plan = synthetic_plan(splits if pkg == "port" else jsplits, spk)
            folds.append(pipe.assemble_fold(m[corpora_of], m[2], plan, dataset=ds,
                                            feature_len=16, win_len=40))
        out[pkg] = folds
    return out


def test_combine_folds_matches_jax():
    folds = two_corpus_folds()
    assert folds["port"][0].test.windows.shape[1] != folds["port"][1].test.windows.shape[1]
    assert_folds_equal(combine.combine_folds(folds["port"]),
                       jcombine.combine_folds(folds["jax"]))
    with pytest.raises(ValueError, match="fold numbers differ"):
        combine.combine_folds([folds["port"][0], dataclasses.replace(folds["port"][1], fold=3)])


@pytest.mark.parametrize("shuffle,drop", [(True, False), (False, False), (True, True)])
def test_batch_iterator_matches_jax(shuffle, drop):
    fold = two_corpus_folds()["port"][0]
    ours = list(pipeline.batch_iterator(fold.training, 7, np.random.default_rng(4), shuffle, drop))
    theirs = list(jpipeline.batch_iterator(fold.training, 7, np.random.default_rng(4), shuffle,
                                           drop))
    assert len(ours) == len(theirs) > 1
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_stores_cross_over(tmp_path, writer):
    """A feature store, a fold and a manifest written by one package are
    read by the other, array for array; the manifests are the same bytes."""
    w, r = (store, jstore) if writer == "port" else (jstore, store)
    ours_m, theirs_m, feats = seeded_corpus(gemaps=True)
    fold = two_corpus_folds()[writer][0]
    w.save_feature_store(str(tmp_path / "data_16.npz"), feats)
    back = r.load_feature_store(str(tmp_path / "data_16.npz"))
    assert back.keys() == feats.keys()
    assert all(back[u].keys() == feats[u].keys()
               and all(np.array_equal(back[u][k], feats[u][k]) for k in feats[u]) for u in feats)
    w.save_fold(str(tmp_path / "fold2.npz"), fold)
    assert_folds_equal(r.load_fold(str(tmp_path / "fold2.npz")), fold)
    manifest = ours_m if writer == "port" else theirs_m
    for u in manifest[:3]:
        manifest.append(dataclasses.replace(u, utt_id=u.utt_id + "_w", path=f"/x/{u.utt_id}.wav"))
    w.save_manifest(str(tmp_path / "manifest.json"), manifest)
    assert [dataclasses.astuple(u) for u in r.load_manifest(str(tmp_path / "manifest.json"))] \
        == [dataclasses.astuple(u) for u in manifest]
    other = theirs_m if writer == "port" else ours_m
    for u in other[:3]:
        other.append(dataclasses.replace(u, utt_id=u.utt_id + "_w", path=f"/x/{u.utt_id}.wav"))
    r.save_manifest(str(tmp_path / "manifest_r.json"), other)
    assert (tmp_path / "manifest.json").read_bytes() == (tmp_path / "manifest_r.json").read_bytes()


@pytest.mark.parametrize("maker", ["make_corpus", "make_hard_corpus"])
def test_synthetic_corpora_are_bit_equal(maker):
    ours = getattr(synthetic, maker)(6, 3, seed=8)
    theirs = getattr(jsynthetic, maker)(6, 3, seed=8)
    assert [dataclasses.astuple(u) for u in ours.manifest] == \
        [dataclasses.astuple(u) for u in theirs.manifest]
    assert ours.waveforms.keys() == theirs.waveforms.keys()
    for u, w in ours.waveforms.items():
        assert w.dtype == theirs.waveforms[u].dtype and np.array_equal(w, theirs.waveforms[u])
    assert ours.sample_rate == theirs.sample_rate
