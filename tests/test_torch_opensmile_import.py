"""The port's openSMILE import vs the JAX package's, on the same files: the
counterparts of the seven cases of tests/test_opensmile_import.py, each
comparing the port's output (or its refusal) with JAX's exactly, and the
featurize CLI's ``--import_opensmile`` store against JAX's CLI store."""

import pickle

import numpy as np
import pytest

from sept_tpu.data import opensmile_import as J
from sept_tpu_torch.data import opensmile_import as T


def _csv_of(rows, n_feats, with_start_end=True):
    cols = ["file"] + (["start", "end"] if with_start_end else [])
    cols += [f"F{i}" for i in range(n_feats)]
    lines = [",".join(cols)]
    for path, vec in rows:
        meta = [path] + (["0.0", "2.5"] if with_start_end else [])
        lines.append(",".join(meta + [repr(float(v)) for v in vec]))
    return "\n".join(lines) + "\n"


def _assert_same(ours, theirs):
    assert ours.keys() == theirs.keys()
    for u in ours:
        assert ours[u].keys() == theirs[u].keys()
        for k in ours[u]:
            assert ours[u][k].dtype == theirs[u][k].dtype
            np.testing.assert_array_equal(ours[u][k], theirs[u][k])


def _gemaps_csv(tmp_path):
    rng = np.random.default_rng(0)
    vecs = {f"utt{i}": rng.standard_normal(88).astype(np.float32) for i in range(3)}
    path = tmp_path / "gemaps.csv"
    path.write_text(_csv_of([(f"/data/wav/{u}.wav", v) for u, v in vecs.items()], 88))
    return str(path), vecs


def _write_pickle(path, blob):
    with open(path, "wb") as f:
        pickle.dump(blob, f)
    return str(path)


def test_csv_roundtrip_gemaps(tmp_path):
    path, vecs = _gemaps_csv(tmp_path)
    ours = T.load_opensmile_file(path)
    _assert_same(ours, J.load_opensmile_file(path))
    for u, v in vecs.items():
        np.testing.assert_array_equal(ours[u]["gemaps"], v)
    stores = [{u: {"mfcc": np.zeros((120, 10)), "gemaps": np.zeros(88)} for u in vecs}
              for _ in range(2)]
    got = T.apply_opensmile(stores[0], ours)
    assert got == J.apply_opensmile(stores[1], J.load_opensmile_file(path))
    assert got == (3, [], {})
    _assert_same(stores[0], stores[1])


def test_csv_emobase_width_inference(tmp_path):
    vec = np.arange(988, dtype=np.float32)
    path = tmp_path / "emobase.csv"
    path.write_text(_csv_of([("a.wav", vec)], 988, with_start_end=False))
    ours = T.load_opensmile_file(str(path))
    _assert_same(ours, J.load_opensmile_file(str(path)))
    np.testing.assert_array_equal(ours["a"]["emobase"], vec)


@pytest.mark.parametrize("kind", ["csv", "pickle"])
def test_wrong_width_rejected(tmp_path, kind):
    if kind == "csv":
        path = tmp_path / "bad.csv"
        path.write_text(_csv_of([("a.wav", np.zeros(17))], 17))
        path = str(path)
    else:
        path = _write_pickle(tmp_path / "bad.pkl", {"u": {"gemaps": np.zeros(87)}})
    with pytest.raises(ValueError) as theirs:
        J.load_opensmile_file(path)
    with pytest.raises(ValueError, match="expected 88") as ours:
        T.load_opensmile_file(path)
    assert str(ours.value) == str(theirs.value)


def test_reference_pickle_roundtrip(tmp_path):
    """The reference's feature pickle imports directly; entries other than
    the functionals are ignored."""
    rng = np.random.default_rng(1)
    g = rng.standard_normal((1, 88)).astype(np.float64)  # DataFrame-shaped
    e = rng.standard_normal((1, 988)).astype(np.float64)
    path = _write_pickle(tmp_path / "data_128.pkl", {
        "Ses01F_impro01_F000": {"gemaps": g, "emobase": e, "mfcc": np.zeros((120, 50))}})
    ours = T.load_opensmile_file(path)
    _assert_same(ours, J.load_opensmile_file(path))
    got = ours["Ses01F_impro01_F000"]
    assert set(got) == {"gemaps", "emobase"}
    np.testing.assert_array_equal(got["gemaps"], g.ravel().astype(np.float32))


@pytest.mark.parametrize("case", ["unmatched", "partial"])
def test_coverage_reported(case):
    """Ids the store lacks come back as unmatched; store utterances the
    import does not cover come back per feature set."""
    ids = ("a",) if case == "unmatched" else ("a", "b", "c")
    imported = {"a": {"gemaps": np.ones(88, np.float32)}}
    if case == "unmatched":
        imported["zzz"] = {"gemaps": np.ones(88, np.float32)}
    stores = [{u: {"gemaps": np.zeros(88)} for u in ids} for _ in range(2)]
    got = T.apply_opensmile(stores[0], imported)
    assert got == J.apply_opensmile(stores[1], imported)
    assert got == ((1, ["zzz"], {}) if case == "unmatched" else (1, [], {"gemaps": ["b", "c"]}))
    _assert_same(stores[0], stores[1])


def test_featurize_cli_import_matches_jax(tmp_path, capsys):
    """``featurize --functionals 0 --import_opensmile`` on the synthetic
    corpus with a CSV covering one utterance: both CLIs write the same
    gemaps vector for it and print the partial-cover warning; an id the
    corpus lacks fails both."""
    from sept_tpu.cli import featurize as jfeaturize
    from sept_tpu.data import store as jstore
    from sept_tpu_torch.cli import featurize
    from sept_tpu_torch.data import store

    corpus = ["--dataset", "synthetic", "--n_speakers", "2", "--utts_per_speaker", "1",
              "--input_spec_size", "32", "--functionals", "0"]
    jfeaturize.main(corpus + ["--work_dir", str(tmp_path / "probe")])
    rel = "feature/mel_spec/synthetic/data_32.npz"
    ids = sorted(jstore.load_feature_store(str(tmp_path / "probe" / rel)))
    vec = np.arange(88, dtype=np.float32) / 7
    csv = tmp_path / "g.csv"
    csv.write_text(_csv_of([(f"/x/{ids[0]}.wav", vec)], 88))
    featurize.main(corpus + ["--work_dir", str(tmp_path / "ours"), "--device", "cpu",
                             "--import_opensmile", str(csv)])
    ours_out = capsys.readouterr().out
    jfeaturize.main(corpus + ["--work_dir", str(tmp_path / "theirs"),
                              "--import_opensmile", str(csv)])
    theirs_out = capsys.readouterr().out
    ours = store.load_feature_store(str(tmp_path / "ours" / rel))
    theirs = jstore.load_feature_store(str(tmp_path / "theirs" / rel))
    assert ours.keys() == theirs.keys()
    np.testing.assert_array_equal(ours[ids[0]]["gemaps"], vec)
    np.testing.assert_array_equal(theirs[ids[0]]["gemaps"], vec)
    assert all("gemaps" not in ours[u] and "gemaps" not in theirs[u] for u in ids[1:])
    for out in (ours_out, theirs_out):
        assert "WARNING" in out and "covers only 1/2" in out
    bad = tmp_path / "bad.csv"
    bad.write_text(_csv_of([("/x/nobody.wav", vec)], 88))
    for main, extra in ((featurize.main, ["--device", "cpu"]), (jfeaturize.main, [])):
        with pytest.raises(SystemExit):
            main(corpus + extra + ["--work_dir", str(tmp_path / "bad"),
                                   "--import_opensmile", str(bad)])
