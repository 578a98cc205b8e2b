"""The port's corpus walkers against the JAX package's on fabricated trees
in the four corpora's layouts: the same manifests, record for record."""

import dataclasses
import os

import numpy as np
import pytest

from sept_tpu.data import walkers as jwalkers
from sept_tpu_torch.data import walkers
from sept_tpu_torch.runtime.wavio import write_wav


def wav(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_wav(path, np.zeros(160, np.float32), 16000)


def iemocap_tree(root):
    lines = {1: [], 2: []}
    for s in (1, 2):
        for g, spk in (("F", f"Ses0{s}F"), ("M", f"Ses0{s}M")):
            for k, (kind, label) in enumerate((("impro01", "neu"), ("impro02", "exc"),
                                               ("script01", "ang"), ("impro03", "fru"),
                                               ("impro04", "sad"))):
                utt = f"{spk}_{kind}_{g}{k:03d}"
                if k != 4 or s == 1:  # a label whose wav is missing
                    wav(f"{root}/Session{s}/sentences/wav/{spk}_{kind}/{utt}.wav")
                lines[s].append(f"[{k}.0 - {k}.9]\t{utt}\t{label}\t[2.5, 2.5, 2.5]\n")
    for s, ls in lines.items():
        d = f"{root}/Session{s}/dialog/EmoEvaluation"
        os.makedirs(d, exist_ok=True)
        with open(f"{d}/Ses0{s}_all.txt", "w") as f:
            f.write("% header line\n\n" + "".join(ls))


def crema_tree(root, bom=False):
    emos = ("ANG", "NEU", "SAD", "HAP", "DIS", "FEA")
    for actor in (1001, 1002, 1076, 1090):
        for k, sent in enumerate(("DFA", "IEO", "TIE")):
            wav(f"{root}/{actor}_{sent}_{emos[(actor + k) % 6]}_XX.wav")
    wav(f"{root}/1076_MTI_SAD_XX.wav")
    wav(f"{root}/1091_DFA_ANG_XX.wav")  # no demographics row: skipped
    key = "﻿ActorID" if bom else "ActorID"
    with open(f"{root}/VideoDemographics.csv", "w", newline="") as f:
        f.write(f"{key},Age,Sex,Race,Ethnicity\n1001,51,Male,Caucasian,Not Hispanic\n"
                "1002,21,Female,Caucasian,Not Hispanic\n1076,25,Female,Asian,Not Hispanic\n"
                "1090,29,Male,African American,Not Hispanic\n")


def msp_improv_tree(root):
    for sess, spk in ((1, "F01"), (1, "M01"), (3, "M03")):
        for kind in ("S", "P", "R", "T"):
            for emo in ("A", "H", "N", "S", "X"):
                wav(f"{root}/Audio/session{sess}/S0{sess}{emo}/"
                    f"MSP-IMPROV-S0{sess}{emo}-{spk}-{kind}-FM01.wav")


def msp_podcast_tree(root):
    os.makedirs(f"{root}/Labels", exist_ok=True)
    rows = ["FileName,EmoClass,EmoAct,SpkrID,Gender,Split_Set"]
    for i in range(14):
        rows.append(f"MSP-PODCAST_{i:04d}.wav,{'NSHAX'[i % 5]},3.0,spk1,Female,Train")
    for i in range(11):
        rows.append(f"MSP-PODCAST_1{i:03d}.wav,{'SHAN'[i % 4]},3.0,spk2,Male,Development")
    rows += ["rare.wav,N,3.0,spk3,Male,Train", "t2.wav,A,3.0,spk1,Female,Test2",
             "unk.wav,H,3.0,Unknown,Unknown,Train"]
    with open(f"{root}/Labels/labels_concensus.csv", "w") as f:
        f.write("\n".join(rows) + "\n")
    for r in rows[1:-4]:
        wav(f"{root}/Audios/{r.split(',')[0]}")  # the last of spk2's files is missing


TREES = {"iemocap": iemocap_tree, "crema-d": crema_tree, "msp-improv": msp_improv_tree,
         "msp-podcast": msp_podcast_tree}


@pytest.mark.parametrize("dataset", sorted(TREES))
def test_manifests_match_jax(tmp_path, dataset):
    root = str(tmp_path)
    TREES[dataset](root)
    ours = walkers.walk_corpus(dataset, root)
    theirs = jwalkers.walk_corpus(dataset, root)
    assert len(ours) > 2
    assert [dataclasses.astuple(u) for u in ours] == [dataclasses.astuple(u) for u in theirs]
    assert all(os.path.isfile(u.path) and u.dataset == dataset for u in ours)


def test_crema_d_demographics_with_a_byte_order_mark(tmp_path):
    crema_tree(str(tmp_path), bom=True)
    ours, theirs = walkers.walk_crema_d(str(tmp_path)), jwalkers.walk_crema_d(str(tmp_path))
    assert [dataclasses.astuple(u) for u in ours] == [dataclasses.astuple(u) for u in theirs]
    assert "1076_MTI_SAD_XX" not in {u.utt_id for u in ours}


def test_unknown_corpus_raises(tmp_path):
    with pytest.raises(ValueError, match="unknown dataset"):
        walkers.walk_corpus("timit", str(tmp_path))
