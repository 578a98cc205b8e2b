"""Corpus directory walkers: filesystem -> manifest.

Counterpart of ``sept_tpu/data/walkers.py``, copied: manifest-building
equivalents of the reference's path traversals
(audio_feature_extraction.py:127-189, preprocess_adversary_data.py:230-350),
pointed at a corpus root the caller names:

- IEMOCAP: ``<root>/Session{1..5}/sentences/wav/**/*.wav`` for audio;
  labels from ``<root>/Session*/dialog/EmoEvaluation/*.txt``.
- CREMA-D: ``<root>/*.wav`` + ``<root>/VideoDemographics.csv``; the corrupt
  ``1076_MTI_SAD_XX.wav`` is skipped (audio_feature_extraction.py:160).
- MSP-IMPROV: ``<root>/Audio/session*/**/*.wav``, improvised-only.
- MSP-Podcast: ``<root>/Labels/labels_concensus.csv`` + ``<root>/Audios/``.
"""

from __future__ import annotations

import csv
import glob
import os

from sept_tpu_torch.data.corpora import (
    Utterance,
    parse_crema_d_filename,
    parse_iemocap_evaluation,
    parse_msp_improv_filename,
    parse_msp_podcast_row,
)

__all__ = ["walk_iemocap", "walk_crema_d", "walk_msp_improv",
           "walk_msp_podcast", "walk_corpus"]


def walk_iemocap(root: str) -> list[Utterance]:
    wav_by_id = {}
    for session in sorted(glob.glob(os.path.join(root, "Session*"))):
        for wav in glob.glob(os.path.join(session, "sentences", "wav", "**", "*.wav"),
                             recursive=True):
            wav_by_id[os.path.splitext(os.path.basename(wav))[0]] = wav
    out = []
    for txt in sorted(
        glob.glob(os.path.join(root, "Session*", "dialog", "EmoEvaluation", "*.txt"))
    ):
        with open(txt, errors="replace") as f:
            for u in parse_iemocap_evaluation(f.read()):
                if u.utt_id in wav_by_id:
                    out.append(
                        Utterance(u.utt_id, u.label, u.gender, u.speaker_id,
                                  "iemocap", wav_by_id[u.utt_id])
                    )
    return out


def walk_crema_d(root: str) -> list[Utterance]:
    demo = {}
    demo_csv = os.path.join(root, "VideoDemographics.csv")
    if os.path.exists(demo_csv):
        with open(demo_csv, newline="") as f:
            for row in csv.DictReader(f):
                key = row.get("ActorID") or row.get("﻿ActorID") or ""
                if key:
                    demo[int(key)] = row["Sex"]
    out = []
    for wav in sorted(glob.glob(os.path.join(root, "*.wav"))):
        stem = os.path.splitext(os.path.basename(wav))[0]
        if stem == "1076_MTI_SAD_XX":  # corrupt file skipped by the reference
            continue
        spk = int(stem.split("_")[0])
        if spk not in demo:
            continue
        u = parse_crema_d_filename(stem, demo)
        if u is not None:
            out.append(Utterance(u.utt_id, u.label, u.gender, u.speaker_id,
                                 "crema-d", wav))
    return out


def walk_msp_improv(root: str) -> list[Utterance]:
    out = []
    pattern = os.path.join(root, "Audio", "session*", "**", "*.wav")
    for wav in sorted(glob.glob(pattern, recursive=True)):
        stem = os.path.splitext(os.path.basename(wav))[0]
        u = parse_msp_improv_filename(stem)
        if u is not None:
            out.append(Utterance(u.utt_id, u.label, u.gender, u.speaker_id,
                                 "msp-improv", wav))
    return out


def walk_msp_podcast(root: str) -> list[Utterance]:
    """MSP-Podcast: ``<root>/Labels/labels_concensus.csv`` + ``<root>/Audios/``
    (the reference's intended-but-broken path, fixed: see
    :func:`sept_tpu_torch.data.corpora.parse_msp_podcast_row`)."""
    labels_csv = os.path.join(root, "Labels", "labels_concensus.csv")
    rows = []
    with open(labels_csv, newline="") as f:
        for row in csv.DictReader(f):
            rows.append(row)
    counts: dict = {}
    for row in rows:
        counts[row["SpkrID"]] = counts.get(row["SpkrID"], 0) + 1
    out = []
    for row in rows:
        name = row.get("FileName") or row.get("")
        u = parse_msp_podcast_row(
            name, row["EmoClass"], row["SpkrID"], row["Gender"],
            row["Split_Set"], speaker_counts=counts,
        )
        if u is None:
            continue
        wav = os.path.join(root, "Audios", name)
        if os.path.exists(wav):
            out.append(Utterance(u.utt_id, u.label, u.gender, u.speaker_id,
                                 "msp-podcast", wav))
    return out


def walk_corpus(dataset: str, root: str) -> list[Utterance]:
    if dataset == "iemocap":
        return walk_iemocap(root)
    if dataset == "crema-d":
        return walk_crema_d(root)
    if dataset == "msp-improv":
        return walk_msp_improv(root)
    if dataset == "msp-podcast":
        return walk_msp_podcast(root)
    raise ValueError(f"unknown dataset: {dataset!r}")
