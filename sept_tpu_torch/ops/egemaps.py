"""88-dimensional acoustic functionals (the "gemaps" global feature).

Counterpart of ``sept_tpu/ops/egemaps.py``: an eGeMAPS-inspired 88-dim
per-utterance vector, the JAX package's stand-in for openSMILE's
eGeMAPSv02 functionals (the catalog is in that module's docstring; the
order here is the same).  The per-frame work (STFT, mel, band energies,
YIN pitch, LPC formants) runs as batched torch ops over a bucket of
utterances, (B, T, ...), and the reduction is the masked program of
:mod:`sept_tpu_torch.ops.functionals` over the same batch: a bucket is a
few hundred launches, none a frame or an utterance.  The JAX package runs
these as plain XLA ops (no Pallas kernel), and so does the port.

Precision: f32 throughout, TF32 off on the card (the entry points call
``sept_tpu_torch.device.f32_precision``): the LPC envelope's products
are the JAX package's ``Precision.HIGHEST`` dots.

:func:`functionals_reference` is the numpy oracle of :func:`_reduce`, as in
the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sept_tpu_torch.device import f32_precision, resolve_device
from sept_tpu_torch.ops import frontend as F
from sept_tpu_torch.ops import functionals as FN

__all__ = [
    "N_GEMAPS",
    "egemaps_functionals",
    "egemaps_functionals_batch",
    "egemaps_functionals_reference",
    "corpus_vectors",
    "functionals_reference",
    "lpc_formants",
    "yin_pitch",
]

N_GEMAPS = 88
_SR = 16000
_NFFT, _HOP, _NFREQ = FN.NFFT, FN.HOP, FN.NFREQ
_EPS = 1e-10
_LPC_ORDER = 14
_ENV_NF = 160  # 25 Hz grid over 0..4 kHz; parabolic interpolation refines peaks


def _freqs():
    return np.linspace(0, _SR / 2, _NFREQ)


@functools.lru_cache(maxsize=None)
def _band_matrix() -> np.ndarray:
    """13 octave-ish rectangular bands over the linear spectrum, (NFREQ, 13)."""
    edges = np.array([50, 150, 300, 500, 750, 1000, 1500, 2000, 2500, 3000, 4000, 5000,
                      6500, 8000], dtype=np.float64)
    f = _freqs()
    bands = np.zeros((_NFREQ, 13), dtype=np.float32)
    for b in range(13):
        bands[:, b] = ((f >= edges[b]) & (f < edges[b + 1])).astype(np.float32)
    return bands


@functools.lru_cache(maxsize=None)
def _env_grid(order: int = _LPC_ORDER, nf: int = _ENV_NF):
    """Frequency grid and the cos / sin tables that evaluate the LPC
    envelope |1/A(e^jw)|^2 as two (order + 1, nf) products."""
    f_env = np.linspace(0.0, 4000.0, nf)
    w = 2.0 * np.pi * f_env / _SR
    j = np.arange(order + 1)[:, None]
    return (f_env.astype(np.float32), np.cos(j * w[None, :]).astype(np.float32),
            np.sin(j * w[None, :]).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> dict:
    """The constant tables of :func:`_lld`, copied to ``device`` once."""
    f = _freqs()

    def band(sel):
        return sel.astype(np.float32)

    tabs = {
        "f": f.astype(np.float32), "bands": _band_matrix(),
        "mel_fb": F.melscale_fbanks(_NFREQ, 0.0, 8000.0, 26, _SR),
        "dct": F.create_dct(5, 26, "ortho"),
        "lo500": band(f < 500), "f500_1500": band((f >= 500) & (f < 1500)),
        "alpha_lo": band((f >= 50) & (f < 1000)), "alpha_hi": band((f >= 1000) & (f < 5000)),
        "ham_lo": band(f < 2000), "ham_hi": band((f >= 2000) & (f < 5000)),
        "window": F.hann_window(_NFFT),
        "bw": (0.99 ** np.arange(_LPC_ORDER + 1)).astype(np.float32),
    }
    tabs["f_env"], tabs["env_cos"], tabs["env_sin"] = _env_grid()
    return {k: torch.tensor(v, device=device) for k, v in tabs.items()}


def yin_pitch(frames: torch.Tensor, n_fft: int = _NFFT, sr: int = _SR,
              threshold: float = 0.15, voiced_thresh: float = 0.5):
    """YIN pitch of raw frames (..., n_fft), 50..500 Hz: the difference
    function over a fixed window W = n_fft - max_lag (the cross term from one
    FFT correlation at 2 * n_fft, the energies from a cumulative sum), the
    cumulative-mean-normalized difference d', the first local minimum of d'
    below ``threshold`` inside the lag band (else the band's minimum) with
    parabolic interpolation.  Returns (f0 in log2 semitones, voiced flag,
    pitch strength 1 - d'(tau*)), each (...)."""
    lead = frames.shape[:-1]
    frames = frames.reshape(-1, n_fft)
    dev = frames.device
    min_lag, max_lag = sr // 500, sr // 50  # 32 .. 320
    x = frames - FN.static_mean(frames, 1, keepdim=True)
    w = n_fft - max_lag  # 480 samples, 30 ms
    head = x * (torch.arange(n_fft, device=dev) < w).to(x.dtype)
    n2 = 2 * n_fft
    c = torch.fft.irfft(torch.conj(torch.fft.rfft(head, n=n2, dim=1))
                        * torch.fft.rfft(x, n=n2, dim=1), n=n2, dim=1)[:, : max_lag + 1]
    cs = torch.cumsum(torch.cat([x.new_zeros(x.shape[0], 1), x * x], 1), 1)
    taus = torch.arange(max_lag + 1, device=dev)
    e = cs[:, taus + w] - cs[:, taus]
    d = e[:, :1] + e - 2.0 * c  # d(0) = 0
    cum = torch.cumsum(d[:, 1:], 1)
    dp = torch.cat([torch.ones_like(d[:, :1]),
                    d[:, 1:] * taus[1:].to(d.dtype) / (cum + _EPS)], 1)
    # the first local minimum below the threshold, both neighbours >= it
    in_band = ((taus >= min_lag) & (taus < max_lag))[None, :]
    inf = torch.full_like(dp[:, :1], float("inf"))
    nxt = torch.cat([dp[:, 1:], inf], 1)
    prv = torch.cat([inf, dp[:, :-1]], 1)
    dips = (dp < threshold) & (nxt >= dp) & (prv >= dp) & in_band
    first_dip = torch.argmax(dips.to(torch.uint8), 1)
    global_min = torch.argmin(torch.where(in_band, dp, float("inf")), 1)
    tau0 = torch.where(dips.any(1), first_dip, global_min)
    y0 = dp.gather(1, torch.clamp(tau0 - 1, min=0)[:, None])[:, 0]
    y1 = dp.gather(1, tau0[:, None])[:, 0]
    y2 = dp.gather(1, torch.clamp(tau0 + 1, max=max_lag)[:, None])[:, 0]
    denom = y0 - 2.0 * y1 + y2
    curved = denom.abs() > _EPS
    delta = torch.clamp(0.5 * (y0 - y2) / torch.where(curved, denom, 1.0), -0.5, 0.5)
    tau_star = tau0.to(torch.float32) + torch.where(curved, delta, 0.0)
    f0 = torch.clamp(sr / torch.clamp(tau_star, min=1.0), 50.0, 500.0)
    strength = torch.clamp(1.0 - y1, 0.0, 1.0)
    voiced = (strength > voiced_thresh).to(torch.float32)
    f0_log = torch.log2(torch.clamp(f0, min=1.0)) * 12.0
    return f0_log.reshape(lead), voiced.reshape(lead), strength.reshape(lead)


def _lpc_env(frames: torch.Tensor, n_fft: int = _NFFT, order: int = _LPC_ORDER):
    """(N, _ENV_NF) LPC spectral envelope in dB of raw frames (N, n_fft):
    pre-emphasis and Hann window, the autocorrelation r[0..order] by one FFT,
    Levinson-Durbin over the static order (a 1e-5 white-noise ridge on r[0],
    k clamped to +-0.9995, the error floored at 1e-6), bandwidth expansion
    a_j * 0.99^j, and |1/A|^2 on the fixed grid by two f32 products."""
    tabs = _tables(frames.device)
    pre = torch.cat([frames[:, :1], frames[:, 1:] - 0.97 * frames[:, :-1]], 1)
    xw = pre * tabs["window"]
    spec_ac = torch.fft.rfft(xw, n=2 * n_fft, dim=1)
    r = torch.fft.irfft(spec_ac * torch.conj(spec_ac), n=2 * n_fft, dim=1)[:, : order + 1]
    r = r / (r[:, :1] + _EPS)
    r = torch.cat([r[:, :1] + 1e-5, r[:, 1:]], 1)
    rc = [r[:, i] for i in range(order + 1)]
    a = [None] + [torch.zeros_like(rc[0]) for _ in range(order)]
    err = rc[0]
    for i in range(1, order + 1):
        acc = torch.zeros_like(err)
        for j in range(1, i):
            acc = acc + a[j] * rc[i - j]
        k = torch.clamp((rc[i] - acc) / torch.clamp(err, min=1e-5), -0.9995, 0.9995)
        a = [None] + [a[j] - k * a[i - j] for j in range(1, i)] + [k] + a[i + 1:]
        err = torch.clamp(err * (1.0 - k * k), min=1e-6)
    coef = torch.stack([torch.ones_like(err)] + [-a[j] for j in range(1, order + 1)], 1)
    coef = coef * tabs["bw"]
    re = coef @ tabs["env_cos"]
    im = coef @ tabs["env_sin"]
    return -10.0 * torch.log10(re * re + im * im + _EPS)


def lpc_formants(frames: torch.Tensor, n_fft: int = _NFFT, sr: int = _SR,
                 order: int = _LPC_ORDER, lo: float = 200.0, hi: float = 3800.0):
    """F1 / F2 / F3 of raw frames (..., n_fft) by LPC envelope peak picking:
    the first three interior local maxima of :func:`_lpc_env` in [lo, hi]
    Hz, each refined by parabolic interpolation; a frame with fewer peaks
    takes 500 / 1500 / 2500 Hz at level 0.  Returns ((..., 3) frequencies in
    Hz, (..., 3) levels in dB relative to the frame's mean envelope)."""
    lead = frames.shape[:-1]
    frames = frames.reshape(-1, n_fft)
    f_env_np, _, _ = _env_grid(order)
    f_env = _tables(frames.device)["f_env"]
    df = float(f_env_np[1] - f_env_np[0])
    env_db = _lpc_env(frames, n_fft=n_fft, order=order)
    env_mean = FN.static_mean(env_db, 1)
    band = torch.as_tensor((f_env_np >= lo) & (f_env_np <= hi), device=frames.device)[1:-1]
    local_max = (env_db[:, 1:-1] > env_db[:, :-2]) & (env_db[:, 1:-1] >= env_db[:, 2:])
    peaks = torch.nn.functional.pad(local_max & band, (1, 1))
    cnt = torch.cumsum(peaks.to(torch.int32), 1)
    last = env_db.shape[1] - 1
    freqs, levels = [], []
    for i, default in enumerate((500.0, 1500.0, 2500.0)):
        sel = peaks & (cnt == i + 1)  # at most one a row
        has = sel.any(1)
        k = torch.argmax(sel.to(torch.uint8), 1)
        y0 = env_db.gather(1, torch.clamp(k - 1, min=0)[:, None])[:, 0]
        y1 = env_db.gather(1, k[:, None])[:, 0]
        y2 = env_db.gather(1, torch.clamp(k + 1, max=last)[:, None])[:, 0]
        denom = y0 - 2.0 * y1 + y2
        curved = denom.abs() > _EPS
        delta = torch.clamp(0.5 * (y0 - y2) / torch.where(curved, denom, 1.0), -0.5, 0.5)
        fk = f_env[k] + torch.where(curved, delta, 0.0) * df
        freqs.append(torch.where(has, fk, default))
        levels.append(torch.where(has, y1 - env_mean, 0.0))
    return (torch.stack(freqs, 1).reshape(*lead, 3),
            torch.stack(levels, 1).reshape(*lead, 3))


def _band_slope(db_spec, f, mask):
    """Per frame: the slope (dB/Hz) of a linear fit of the dB spectrum
    against frequency within ``mask``'s band."""
    n = mask.sum()
    fx = f * mask
    mx = fx.sum() / n
    centred = fx - mx * mask
    cov = (centred * db_spec * mask).sum(-1)
    return cov / ((centred ** 2).sum() + _EPS)


def _lld(waves: torch.Tensor, preamble=None, pitch=None) -> torch.Tensor:
    """Per-frame LLD tracks (B, T, 37) of padded waveforms (B, L) f32.
    ``preamble`` / ``pitch``: :func:`FN.lld_stft_preamble` and
    :func:`yin_pitch` of these waves, where the caller already has them (the
    combined extractor shares them with emobase)."""
    tabs = _tables(waves.device)
    f = tabs["f"]
    frames, spec = preamble if preamble is not None else FN.lld_stft_preamble(waves)
    energy = spec.sum(-1)
    loud = 10.0 * torch.log10(energy + _EPS)
    total = energy + _EPS
    centroid = (spec * f).sum(-1) / total
    spread = torch.sqrt((spec * (f - centroid[..., None]) ** 2).sum(-1) / total)
    cum = torch.cumsum(spec, -1)
    rolloff = f[torch.argmax((cum >= 0.85 * total[..., None]).to(torch.uint8), -1)]
    p = spec / total[..., None]
    entropy = -(p * torch.log(p + _EPS)).sum(-1)
    flux = torch.nn.functional.pad(
        torch.sqrt(((spec[:, 1:] - spec[:, :-1]) ** 2).sum(-1)), (1, 0))
    db_spec = 10.0 * torch.log10(spec + _EPS)
    slope0 = _band_slope(db_spec, f, tabs["lo500"])
    slope1 = _band_slope(db_spec, f, tabs["f500_1500"])
    alpha = 10.0 * torch.log10(((spec * tabs["alpha_lo"]).sum(-1) + _EPS)
                               / ((spec * tabs["alpha_hi"]).sum(-1) + _EPS))
    hamm = 10.0 * torch.log10(((spec * tabs["ham_lo"]).amax(-1) + _EPS)
                              / ((spec * tabs["ham_hi"]).amax(-1) + _EPS))
    mel_db = 10.0 * torch.log10(spec @ tabs["mel_fb"] + _EPS)
    mfcc = mel_db @ tabs["dct"]  # (B, T, 5)
    band_e = 10.0 * torch.log10(spec @ tabs["bands"] + _EPS)  # (B, T, 13)
    f0_log, voiced, strength = pitch if pitch is not None else yin_pitch(frames)
    bv = torch.clamp(strength, 1e-4, 0.9999)
    hnr = 10.0 * torch.log10(bv / (1.0 - bv))
    fmt_freq, fmt_level = lpc_formants(frames)
    formants = torch.stack([fmt_freq, fmt_level], -1).reshape(*fmt_freq.shape[:-1], 6)
    return torch.cat([
        torch.stack([f0_log, voiced, strength, loud, hnr, alpha, hamm, slope0, slope1,
                     centroid, spread, flux, rolloff, entropy], -1),
        mfcc[..., 1:5], band_e, formants], -1)


def _reduce(tracks: torch.Tensor, t: torch.Tensor, n_samples: torch.Tensor) -> torch.Tensor:
    """(B, t_pad, 37) padded LLD tracks, valid frame counts (B,) and sample
    counts (B,) -> (B, 88): :func:`functionals_reference` as masked
    reductions (percentiles as np.percentile, the F0 rise / fall and jitter
    over the voiced frames compacted, run statistics as total / runs)."""
    t_pad = tracks.shape[1]
    t = t.to(torch.int32)
    m = FN.frame_mask(t_pad, t)
    (f0, voiced, vprob, loud, hnr, alpha, hamm, s0, s1, cent, spread, flux, roll,
     ent) = tracks[..., :14].unbind(-1)
    vsel = (voiced > 0.5) & m
    tv = vsel.sum(-1)
    has_v = tv > 0
    fsel = torch.where(has_v[:, None], vsel, m)  # no voiced frame: all valid frames
    tf = torch.where(has_v, tv, t)

    def stats5(x, sel, n):
        s = FN.masked_sort(x, sel)
        return [FN.masked_mean(x, sel), FN.masked_std(x, sel)] + [
            FN.percentile_sorted(s, n, q) for q in (20.0, 50.0, 80.0)]

    out = []
    # F0 (8): over the voiced frames, the diffs over their compacted sequence
    st = stats5(f0, fsel, tf)
    f0c = f0.gather(-1, FN.compact_order(fsel, t_pad))
    rise, fall, jit_mu, jit_sd = FN.diff_stats(f0c, tf)
    out += st + [st[4] - st[2], rise, fall]
    out += [FN.masked_mean(vprob, m), FN.masked_std(vprob, m)]  # voicing (2)
    out += [jit_mu, jit_sd]  # jitter (2)
    # loudness (9)
    st = stats5(loud, m, t)
    l_rise, l_fall, sh_mu, sh_sd = FN.diff_stats(loud, t)
    c = (loud[:, 1:-1] > loud[:, :-2]) & (loud[:, 1:-1] > loud[:, 2:])
    peaks = (c & (torch.arange(t_pad - 2, device=t.device) < (t - 2)[:, None])).sum(-1)
    dur_s = n_samples.to(torch.float32) / _SR
    out += st + [st[4] - st[2], l_rise, l_fall,
                 peaks.to(torch.float32) / torch.clamp(dur_s, min=_EPS)]
    out += [sh_mu, sh_sd]  # shimmer (2)
    # HNR, alpha, hammarberg, the two slopes, centroid, spread, flux, rolloff
    # (18), then mfcc 1..4 and the 13 bands (34): mean and std of each
    pairs = torch.cat([torch.stack([hnr, alpha, hamm, s0, s1, cent, spread, flux, roll], 1),
                       tracks[..., 14:31].transpose(1, 2)], 1)  # (B, 26, T)
    mus, sds = FN.masked_mean(pairs, m[:, None]), FN.masked_std(pairs, m[:, None])
    out += list(torch.stack([mus, sds], -1).reshape(pairs.shape[0], -1).unbind(-1))
    # formants (6): means
    out += list(FN.masked_mean(tracks[..., 31:37].transpose(1, 2), m[:, None]).unbind(-1))
    # voiced / unvoiced segments (3)
    v_len, _ = FN.run_stats(voiced > 0.5, m)
    u_len, _ = FN.run_stats(voiced <= 0.5, m)
    out += [v_len, u_len, tv.to(torch.float32) / torch.clamp(t, min=1)]
    out += [torch.log(dur_s + _EPS), torch.log(t.to(torch.float32) + 1.0)]  # durations (2)
    out += [FN.masked_mean(ent, m), FN.masked_std(ent, m)]  # entropy (2)
    return torch.stack([v.to(torch.float32) for v in out], -1)


def _gemaps_batch(W: torch.Tensor, ts: torch.Tensor, ns: torch.Tensor) -> torch.Tensor:
    """(B, 88) of a staged chunk: waves (B, L) f32 or int16, frame counts
    and sample counts (B,)."""
    return _reduce(_lld(F.pcm_to_float(W)), ts, ns)


def corpus_vectors(waveforms: dict[str, np.ndarray], quantum: int, batch_size: int,
                   device, fn) -> list[dict[str, np.ndarray]]:
    """Run ``fn(W, ts, ns) -> tuple of (B, width) tensors`` on each staged
    chunk of a corpus (:func:`FN.chunked_wave_batches`) on ``device``; one
    {utt_id: vector} dict per output, only the vectors coming back."""
    dev = resolve_device(device)
    f32_precision()
    out: list[dict[str, np.ndarray]] = []
    with torch.no_grad():
        for ids, W, ts, ns in FN.chunked_wave_batches(waveforms, quantum, batch_size,
                                                      FN.n_frames):
            vecs = fn(*(torch.from_numpy(a).to(dev) for a in (W, ts, ns)))
            for i, v in enumerate(vecs):
                if len(out) <= i:
                    out.append({})
                v = v.cpu().numpy()
                out[i].update({u: v[row] for row, u in enumerate(ids)})
    return out


def egemaps_functionals_batch(waveforms: dict[str, np.ndarray], quantum: int = 8000,
                              batch_size: int = 64, device="cuda") -> dict[str, np.ndarray]:
    """Featurize a corpus to (88,) vectors on ``device``, bucketed by length
    (one batched program a chunk)."""
    out = corpus_vectors(waveforms, quantum, batch_size, device,
                         lambda W, ts, ns: (_gemaps_batch(W, ts, ns),))
    return out[0] if out else {}


def egemaps_functionals(wave: np.ndarray, device="cuda") -> np.ndarray:
    """(n_samples,) float32 waveform -> its (88,) vector on ``device``: the
    batch entry's row for one utterance."""
    return egemaps_functionals_batch({"_": np.asarray(wave, np.float32)}, device=device)["_"]


# ---------------------------------------------------------------------------
# numpy oracle of the reduction (the JAX package's round-1 implementation)


def _runs(mask: np.ndarray) -> list[int]:
    runs, count = [], 0
    for v in mask:
        if v:
            count += 1
        elif count:
            runs.append(count)
            count = 0
    if count:
        runs.append(count)
    return runs


def functionals_reference(tracks: np.ndarray, n_samples: int) -> np.ndarray:
    """Per-utterance numpy reduction of (T, 37) tracks to the 88-dim vector:
    the oracle that :func:`_reduce` is held against."""
    eps = _EPS
    (f0, voiced, vprob, loud, hnr, alpha, hamm, s0, s1, cent, spread, flux,
     roll, ent) = (tracks[:, i] for i in range(14))
    mfccs, bands, formants = tracks[:, 14:18], tracks[:, 18:31], tracks[:, 31:37]
    vmask = voiced > 0.5
    f0v = f0[vmask] if vmask.any() else f0

    def stats5(x):
        return [float(np.mean(x)), float(np.std(x)), float(np.percentile(x, 20)),
                float(np.percentile(x, 50)), float(np.percentile(x, 80))]

    def rise_fall(x):
        d = np.diff(x) if len(x) > 1 else np.zeros(1)
        rise, fall = d[d > 0], d[d < 0]
        return [float(np.mean(rise)) if len(rise) else 0.0,
                float(np.mean(fall)) if len(fall) else 0.0]

    out: list[float] = []
    st = stats5(f0v)
    out += st + [st[4] - st[2]] + rise_fall(f0v)
    out += [float(np.mean(vprob)), float(np.std(vprob))]
    dj = np.abs(np.diff(f0v)) if len(f0v) > 1 else np.zeros(1)
    out += [float(np.mean(dj)), float(np.std(dj))]
    st = stats5(loud)
    peaks = (int(np.sum((loud[1:-1] > loud[:-2]) & (loud[1:-1] > loud[2:])))
             if len(loud) > 2 else 0)
    dur_s = n_samples / _SR
    out += st + [st[4] - st[2]] + rise_fall(loud) + [peaks / max(dur_s, eps)]
    ds = np.abs(np.diff(loud)) if len(loud) > 1 else np.zeros(1)
    out += [float(np.mean(ds)), float(np.std(ds))]
    for x in (hnr, alpha, hamm, s0, s1, cent, spread, flux, roll):
        out += [float(np.mean(x)), float(np.std(x))]
    for i in range(4):
        out += [float(np.mean(mfccs[:, i])), float(np.std(mfccs[:, i]))]
    for i in range(13):
        out += [float(np.mean(bands[:, i])), float(np.std(bands[:, i]))]
    out += [float(np.mean(formants[:, i])) for i in range(6)]
    vruns, uruns = _runs(vmask), _runs(~vmask)
    out += [float(np.mean(vruns)) if vruns else 0.0,
            float(np.mean(uruns)) if uruns else 0.0, float(np.mean(vmask))]
    out += [float(np.log(dur_s + eps)), float(np.log(len(tracks) + 1))]
    out += [float(np.mean(ent)), float(np.std(ent))]
    assert len(out) == N_GEMAPS, len(out)
    return np.asarray(out, dtype=np.float32)


def egemaps_functionals_reference(wave: np.ndarray) -> np.ndarray:
    """The oracle of one utterance: :func:`_lld` on the CPU over the wave
    zero-padded to a multiple of 8000 samples, cut to its frames, then
    :func:`functionals_reference`."""
    pad = -(-len(wave) // 8000) * 8000
    padded = np.zeros(pad, np.float32)
    padded[:len(wave)] = wave
    with torch.no_grad():
        tracks = _lld(torch.from_numpy(padded)[None])[0].numpy()
    return functionals_reference(tracks[:FN.n_frames(len(wave))], len(wave))
