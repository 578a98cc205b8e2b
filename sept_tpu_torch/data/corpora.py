"""Corpus manifests and label parsing.

Counterpart of ``sept_tpu/data/corpora.py``, copied (the port imports
nothing of ``sept_tpu``).  A *manifest* is a list of ``Utterance`` records;
the parsers map raw corpus metadata (file names, annotation text,
demographics tables) to the canonical (label, gender, speaker_id) triple
with the reference's rules:

- IEMOCAP: EmoEvaluation txt regex; improvised-only; ``exc`` mapped to
  ``hap``; 4 classes neu/hap/sad/ang; gender = last '_' field's first char;
  speaker = session prefix + gender.
- CREMA-D: ``<spk>_<sent>_<EMO>_<lvl>`` filename; labels ang/neu/sad/hap kept;
  gender from the VideoDemographics Sex column; the corrupt file
  1076_MTI_SAD_XX is skipped by the walker.
- MSP-IMPROV: ``...-<EMO>-<SPK>-<RT>-...`` dash fields; improvised only
  (recording types P and R dropped); N/S/H/A -> neu/sad/hap/ang.
- MSP-Podcast: one labels_concensus.csv row (see
  :func:`parse_msp_podcast_row`).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Iterable, Optional

__all__ = [
    "EMO_LABELS",
    "GENDER_LABELS",
    "Utterance",
    "parse_iemocap_evaluation",
    "parse_crema_d_filename",
    "parse_msp_improv_filename",
]

EMO_LABELS = {"neu": 0, "hap": 1, "sad": 2, "ang": 3}  # training_tools.py:9
GENDER_LABELS = {"F": 0, "M": 1}  # training_tools.py:10


@dataclasses.dataclass(frozen=True)
class Utterance:
    """One labeled utterance in a corpus manifest."""

    utt_id: str
    label: str  # neu / hap / sad / ang
    gender: str  # F / M
    speaker_id: str | int
    dataset: str
    path: Optional[str] = None  # wav path, when featurizing from audio

    @property
    def emo_id(self) -> int:
        return EMO_LABELS[self.label]

    @property
    def gender_id(self) -> int:
        return GENDER_LABELS[self.gender]


_IEMOCAP_LINE = re.compile(r"\[.+\]\n", re.IGNORECASE)
_IEMOCAP_KEEP = {"ang", "neu", "sad", "hap", "exc"}


def parse_iemocap_evaluation(file_content: str) -> list[Utterance]:
    """Parse one EmoEvaluation .txt (preprocess_adversary_data.py:326-350)."""
    out = []
    for line in _IEMOCAP_LINE.findall(file_content):
        if "Ses" not in line:
            continue
        fields = line.split("\t")
        utt_id, label = fields[-3], fields[-2]
        if label not in _IEMOCAP_KEEP:
            continue
        if label == "exc":
            label = "hap"
        if "impro" not in line:  # improvised sessions only (:340)
            continue
        gender = utt_id.split("_")[-1][0]
        speaker_id = utt_id.split("_")[0][:-1] + gender  # e.g. Ses01F (:347)
        out.append(Utterance(utt_id, label, gender, speaker_id, "iemocap"))
    return out


def parse_crema_d_filename(
    file_name: str, demographics: dict[int, str]
) -> Optional[Utterance]:
    """Parse a CREMA-D file stem like ``1001_DFA_ANG_XX``
    (preprocess_adversary_data.py:292-308).

    demographics: {speaker_id: 'Male'|'Female'} from VideoDemographics.csv.
    """
    parts = file_name.split("_")
    speaker_id = int(parts[0])
    label = parts[2].lower()
    if label not in ("ang", "neu", "sad", "hap"):
        return None
    gender = "M" if demographics[speaker_id] == "Male" else "F"
    return Utterance(file_name, label, gender, speaker_id, "crema-d")


_MSP_EMO = {"N": "neu", "S": "sad", "H": "hap", "A": "ang"}


def parse_msp_improv_filename(file_name: str) -> Optional[Utterance]:
    """Parse an MSP-IMPROV stem like ``MSP-IMPROV-S01A-F01-S-FM01``
    (preprocess_adversary_data.py:247-273)."""
    parts = file_name.split("-")
    recording_type = parts[-2][-1:]
    emotion = parts[-4][-1:]
    speaker_id = parts[-3]
    gender = speaker_id[:1]
    if recording_type in ("P", "R"):  # keep improvised data only (:255-258)
        return None
    if emotion not in _MSP_EMO:
        return None
    return Utterance(file_name, _MSP_EMO[emotion], gender, speaker_id, "msp-improv")


def manifest_speakers(manifest: Iterable[Utterance]) -> set:
    return {u.speaker_id for u in manifest}


def parse_msp_podcast_row(
    file_name: str,
    emo_class: str,
    speaker_id: str,
    gender: str,
    split_set: str,
    min_speaker_utts: int = 10,
    speaker_counts: Optional[dict] = None,
) -> Optional[Utterance]:
    """Parse one MSP-Podcast labels_concensus.csv row.

    The reference's MSP-Podcast paths are dead code with bugs (undefined
    variables at audio_feature_extraction.py:117-124, wrong call arity at
    preprocess_adversary_data.py:228 — SURVEY.md §2.6 item 11).  This is the
    *fixed* implementation of the behavior those paths intend
    (preprocess_adversary_data.py:190-228): keep N/S/H/A classes, drop
    Test2 rows, Unknown speakers/genders, and speakers with fewer than 10
    utterances (pass ``speaker_counts`` = {speaker_id: n} to enforce).
    """
    if "Test2" in split_set:
        return None
    if "Unknown" in str(speaker_id) or "Unknown" in str(gender):
        return None
    if speaker_counts is not None and speaker_counts.get(speaker_id, 0) < min_speaker_utts:
        return None
    if emo_class not in _MSP_EMO:
        return None
    return Utterance(
        file_name.rsplit(".", 1)[0],
        _MSP_EMO[emo_class],
        str(gender)[0],
        speaker_id,
        "msp-podcast",
    )
