"""Synthetic labeled speech corpus for tests, smoke runs and drills.

Counterpart of ``sept_tpu/data/synthetic.py``, copied: the same waves from
the same seed.  The reference's corpora (IEMOCAP, CREMA-D, MSP-IMPROV) are
licensed and cannot ship; this module fabricates a corpus whose waveforms
carry *learnable* emotion and gender signal:

- gender modulates fundamental frequency (F ~ 210 Hz, M ~ 120 Hz),
- emotion modulates both F0 offset and amplitude-modulation rate / noise
  level (rough arousal/valence proxy),

so a classifier trained on its features beats chance by a wide margin,
enough to drive featurize -> split -> train -> cloak -> evaluate end to end.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sept_tpu_torch.data.corpora import Utterance

__all__ = ["SyntheticCorpus", "make_corpus", "make_hard_corpus"]

_EMO_F0_OFFSET = {"neu": 0.0, "hap": 30.0, "sad": -25.0, "ang": 45.0}
_EMO_AM_RATE = {"neu": 2.0, "hap": 6.0, "sad": 1.0, "ang": 9.0}
_EMO_NOISE = {"neu": 0.02, "hap": 0.03, "sad": 0.01, "ang": 0.06}


@dataclasses.dataclass
class SyntheticCorpus:
    manifest: list[Utterance]
    waveforms: dict[str, np.ndarray]
    sample_rate: int = 16000

    def wave(self, utt_id: str) -> np.ndarray:
        return self.waveforms[utt_id]


def _synth_wave(
    rng: np.random.Generator,
    gender: str,
    label: str,
    duration_s: float,
    sr: int = 16000,
) -> np.ndarray:
    n = int(duration_s * sr)
    t = np.arange(n) / sr
    f0 = (210.0 if gender == "F" else 120.0) + _EMO_F0_OFFSET[label]
    f0 = f0 * (1.0 + 0.03 * rng.standard_normal())
    # harmonic stack with gender-dependent spectral tilt
    wave = np.zeros(n)
    tilt = 0.7 if gender == "F" else 0.55
    for h in range(1, 8):
        wave += (tilt**h) * np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi))
    am = 0.6 + 0.4 * np.sin(2 * np.pi * _EMO_AM_RATE[label] * t)
    wave = 0.25 * wave * am + _EMO_NOISE[label] * rng.standard_normal(n)
    return wave.astype(np.float32)


def make_corpus(
    n_speakers: int = 10,
    utts_per_speaker: int = 12,
    seed: int = 8,
    min_dur_s: float = 1.2,
    max_dur_s: float = 3.5,
    dataset: str = "synthetic",
) -> SyntheticCorpus:
    """Fabricate a speaker-tagged, emotion+gender-labeled corpus.

    Speakers alternate gender; utterance durations vary (so the test-split
    whole-utterance path and sliding-window eval get exercised).
    """
    rng = np.random.default_rng(seed)
    labels = list(_EMO_F0_OFFSET)
    manifest, waveforms = [], {}
    for spk in range(n_speakers):
        gender = "F" if spk % 2 == 0 else "M"
        speaker_id = f"spk{spk:02d}"
        for u in range(utts_per_speaker):
            label = labels[(spk + u) % len(labels)]
            utt_id = f"{speaker_id}_utt{u:03d}_{label}"
            dur = float(rng.uniform(min_dur_s, max_dur_s))
            waveforms[utt_id] = _synth_wave(rng, gender, label, dur)
            manifest.append(
                Utterance(utt_id, label, gender, speaker_id, dataset)
            )
    return SyntheticCorpus(manifest=manifest, waveforms=waveforms)


# ---------------------------------------------------------------------------
# Hard variant: the utility/privacy benchmark corpus
# ---------------------------------------------------------------------------

# emotion = temporal amplitude-modulation rate (Hz), with per-utterance
# jitter wide enough that neighboring classes overlap (sad/neu and hap/ang
# are confusable pairs -> clean emotion UAR lands well below 1.0)
_HARD_AM_RATE = {"neu": 2.2, "hap": 5.0, "sad": 1.0, "ang": 8.0}
_HARD_NOISE = {"neu": 0.020, "hap": 0.030, "sad": 0.012, "ang": 0.050}
# small emotion-dependent F0 offsets put SOME emotion signal in the same
# spectral band that carries gender, so suppressing that band costs utility
_HARD_F0_OFFSET = {"neu": 0.0, "hap": 8.0, "sad": -7.0, "ang": 10.0}


def _synth_wave_hard(
    rng: np.random.Generator,
    f0_base: float,
    label: str,
    duration_s: float,
    sr: int = 16000,
) -> np.ndarray:
    n = int(duration_s * sr)
    t = np.arange(n) / sr
    f0 = (f0_base + _HARD_F0_OFFSET[label]) * (1.0 + 0.02 * rng.standard_normal())
    # IDENTICAL spectral tilt for both genders: gender lives only in the
    # harmonic positions (the F0 band), nowhere else
    wave = np.zeros(n)
    for h in range(1, 8):
        wave += (0.62**h) * np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi))
    am_rate = _HARD_AM_RATE[label] * rng.uniform(0.72, 1.32)
    am_depth = rng.uniform(0.30, 0.50)
    am = (1.0 - am_depth) + am_depth * np.sin(
        2 * np.pi * am_rate * t + rng.uniform(0, 2 * np.pi)
    )
    gain = rng.uniform(0.18, 0.32)
    noise = _HARD_NOISE[label] * rng.uniform(0.7, 1.4)
    # the noise floor is AM-modulated too: high-frequency bins (above every
    # speaker's harmonics) carry the emotion AM-rate cue with NO gender
    # information — the separable subspace a good cloak should discover —
    # while the harmonic band carries both cues (the shared subspace)
    wave = gain * wave * am + noise * am * rng.standard_normal(n)
    return wave.astype(np.float32)


def make_hard_corpus(
    n_speakers: int = 20,
    utts_per_speaker: int = 16,
    seed: int = 8,
    min_dur_s: float = 1.5,
    max_dur_s: float = 3.0,
    dataset: str = "synthetic_hard",
) -> SyntheticCorpus:
    """The utility/privacy benchmark corpus: gender and emotion cues share
    spectral bands so privacy costs something.

    Design (vs :func:`make_corpus`, which is deliberately easy):

    - gender -> ONLY the F0 band position (per-speaker F0 ~ N(205, 15) F /
      N(125, 15) M, identical spectral tilt).  Localized: a cloak can learn
      to noise/suppress those mel bins away;
    - emotion -> broadband temporal AM rate + noise floor, with enough
      per-utterance jitter that clean UAR sits ~0.7-0.9, NOT 1.0 — plus
      small emotion F0 offsets riding the gender band, so killing that band
      trades away part of the emotion signal;
    - per-speaker F0 variation forces speaker-disjoint generalization.
    """
    rng = np.random.default_rng(seed)
    labels = list(_HARD_AM_RATE)
    manifest, waveforms = [], {}
    for spk in range(n_speakers):
        gender = "F" if spk % 2 == 0 else "M"
        f0_base = float(
            rng.normal(205.0, 15.0) if gender == "F" else rng.normal(125.0, 15.0)
        )
        speaker_id = f"spk{spk:02d}"
        for u in range(utts_per_speaker):
            label = labels[(spk + u) % len(labels)]
            utt_id = f"{speaker_id}_utt{u:03d}_{label}"
            dur = float(rng.uniform(min_dur_s, max_dur_s))
            waveforms[utt_id] = _synth_wave_hard(rng, f0_base, label, dur)
            manifest.append(
                Utterance(utt_id, label, gender, speaker_id, dataset)
            )
    return SyntheticCorpus(manifest=manifest, waveforms=waveforms)
