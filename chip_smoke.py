#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check its kernels.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, in order; any failure raises and exits non-zero with no result line:

1. build   compile every CUDA kernel of the path from sept_tpu_torch/csrc
           (one nvcc per source, all at once).
2. model   a full-width Conv2dBiRNN (hidden 64, 128 mels, win 200, shift 50,
           n_fft 800, emotion head) from seeded random weights, served through
           a CloakedPredictor with seeded noise parameters and a 40-percentile
           suppression mask.
3. serve   PredictionServer on 127.0.0.1: 8 float utterances of 2.5-6 s, a
           pcm16 batch, a /stream session, then 6 concurrent pcm16 requests
           (two seeds) under micro-batching on a second server.  The kernels' launch counts are
           set to 0 just before and read just after; every kernel of the path
           must have launched.  Probabilities must be finite, sum to 1, and
           the /metrics counters must match the requests sent.
4. cpu     the same requests answered by the port on the CPU (plain versions,
           same weights, same noise): probabilities within 1e-4.
5. kernels each kernel against its plain version on the card, on the tensors
           the main path gives it (mel 1e-3 dB; conv output 1e-4 and moments
           rel 1e-5; pooled 1e-4), then timed with CUDA events beside its
           plain version, a PyTorch yardstick and its roofline bound; then
           again at edge shapes (ragged tiles, odd sizes, n_fft 1600).
6. latency /predict round trips at 1 and 8 utterances (pcm16), beside the
           server's device-call time.
7. profile device time by kernel over predict calls of 1 and of 8 utterances,
           the device's busy share of the wall time (torch.profiler), and the
           f32 rate of the blocks 2-3 convolutions.

Output: a ``{"block1_eval": ...}`` line, a ``{"latency_ms": ...}`` line, a
``{"profile": ...}`` line, the card's ``name, power.limit`` from nvidia-smi,
a ``{"kernels": [...]}`` line, and last ``{"ok": true, "device": {...}}``.
Progress goes to stderr.
"""

import base64
import json
import re
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

SEED = 0
WIN, SHIFT, N_FFT, HOP, N_MELS, HIDDEN = 200, 50, 800, 160, 128, 64
PEAK_F32_FLOPS = 67e12   # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12     # H100 SXM HBM3
TOL = {"mel_db": 1e-3, "block1_conv_stats": 1e-4, "block1_norm_pool": 1e-4}
MOMENTS_RTOL = 1e-5
PROBS_ATOL = 1e-4


def log(msg):
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def speechlike(rng, n):
    """Two tones over a broadband noise floor: every mel band stays far above
    f32 rounding, so two summation orders agree to well under 1e-3 dB."""
    t = np.arange(n) / 16000.0
    w = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 400) * t)
         + 0.1 * np.sin(2 * np.pi * rng.uniform(800, 3000) * t)
         + 0.05 * rng.standard_normal(n))
    return w.astype(np.float32)


def build_weights(seed=SEED):
    """Seeded random state_dicts of the backbone and the cloak, and the mask."""
    from sept_tpu_torch.models import CloakNoise, Conv2dBiRNN

    torch.manual_seed(seed)
    model = Conv2dBiRNN(hidden_size=HIDDEN, feature_len=N_MELS, pred="emotion")
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for i in (1, 6, 11):
            bn = model.conv[i]
            bn.weight.copy_(1 + 0.1 * torch.randn(bn.weight.shape, generator=g))
            bn.bias.copy_(0.1 * torch.randn(bn.bias.shape, generator=g))
            bn.running_mean.copy_(0.1 * torch.randn(bn.running_mean.shape, generator=g))
            bn.running_var.copy_(1 + 0.5 * torch.rand(bn.running_var.shape, generator=g))
    noise = CloakNoise(win_len=WIN, n_feats=N_MELS, max_scale=5.0)
    with torch.no_grad():
        noise.locs.copy_(0.1 * torch.randn(noise.locs.shape, generator=g))
        noise.rhos.copy_(-3 + 4 * torch.rand(noise.rhos.shape, generator=g))
        scales = noise.scales()[0].numpy()
    # evaluation-direction suppression: zero the cells above the 40th percentile
    mask = np.where(scales > np.percentile(scales, 40), 0.0, 1.0).astype(np.float32)
    return model.state_dict(), noise.state_dict(), mask


def make_predictor(weights, device):
    from sept_tpu_torch.serve import CloakedPredictor

    sd, noise_sd, mask = weights
    return CloakedPredictor(sd, noise_state_dict=noise_sd, mask=mask, max_scale=5.0,
                            hidden_size=HIDDEN, feature_len=N_MELS, win_len=WIN,
                            shift_len=SHIFT, n_fft=N_FFT, device=device)


def make_requests(rng):
    """The main path's traffic: (name, waveforms, seed)."""
    floats = [speechlike(rng, int(rng.uniform(2.5, 6.0) * 16000)) for _ in range(8)]
    pcm = [(speechlike(rng, int(rng.uniform(2.5, 4.0) * 16000)) * 20000).astype(np.int16)
           for _ in range(4)]
    stream = (speechlike(rng, 3 * 16000) * 20000).astype(np.int16)
    concurrent = [((speechlike(rng, int(rng.uniform(2.5, 4.0) * 16000)) * 20000).astype(np.int16),
                   seed) for seed in (0, 0, 0, 0, 5, 5)]
    return floats, pcm, stream, concurrent


def post(url, body, method=None):
    req = urllib.request.Request(url, data=None if body is None else json.dumps(body).encode(),
                                 method=method)
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.load(r)


def check_probs(probs, n, what):
    p = np.asarray(probs, np.float64)
    require(p.shape == (n, 4), f"{what}: probs shape {p.shape}")
    require(np.isfinite(p).all(), f"{what}: non-finite probabilities")
    require(np.abs(p.sum(-1) - 1).max() < 1e-5, f"{what}: probabilities do not sum to 1")
    return p


class Serving:
    """A PredictionServer on 127.0.0.1 with its thread; stop() joins it."""

    def __init__(self, predictor, **kw):
        from sept_tpu_torch.serve import PredictionServer

        self.server = PredictionServer(predictor, host="127.0.0.1", port=0, **kw)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.server.port}"

    def stop(self):
        self.server.shutdown()
        self.thread.join(30)
        require(not self.thread.is_alive(), "server thread did not stop")


def serve_phase(predictor, reqs):
    """Drive the main path over HTTP; returns {request name: probs}."""
    floats, pcm, stream, concurrent = reqs
    answers = {}
    a = Serving(predictor)
    try:
        require(post(f"{a.base}/healthz", None)["cloaked"] is True, "healthz")
        out = post(f"{a.base}/predict", {"waveforms": [w.tolist() for w in floats], "seed": 1})
        answers["float8"] = check_probs(out["probs"], len(floats), "float8")
        out = post(f"{a.base}/predict", {"waveforms_pcm16": [
            base64.b64encode(w.astype("<i2").tobytes()).decode() for w in pcm], "seed": 2})
        answers["pcm16"] = check_probs(out["probs"], len(pcm), "pcm16")
        sid = post(f"{a.base}/stream", {"seed": 3})["session"]
        for lo in range(0, len(stream), 16000):
            out = post(f"{a.base}/stream/{sid}", {
                "pcm16": base64.b64encode(stream[lo:lo + 16000].tobytes()).decode()})
        require(out["samples"] == len(stream), "stream sample count")
        answers["stream"] = check_probs([out["probs"]], 1, "stream")
        require(post(f"{a.base}/stream/{sid}", None, method="DELETE") == {"closed": sid},
                "stream delete")
        m = post(f"{a.base}/metrics", None)
        n_pushes = -(-len(stream) // 16000)
        want = {"requests_total": 3 + n_pushes, "errors_total": 0,
                "device_calls_total": 2 + n_pushes,
                "waveforms_total": len(floats) + len(pcm) + n_pushes}
        require({k: m[k] for k in want} == want, f"/metrics {m} != {want}")
    finally:
        a.stop()

    b = Serving(predictor, batch_window_ms=300)
    results = {}
    bodies = [{"waveforms_pcm16": [base64.b64encode(w.astype("<i2").tobytes()).decode()],
               "seed": seed} for w, seed in concurrent]
    start = threading.Barrier(len(bodies))
    try:
        def fire(i):
            start.wait(60)  # all requests leave together, inside one batch window
            results[i] = post(f"{b.base}/predict", bodies[i])

        threads = [threading.Thread(target=fire, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        require(all(not t.is_alive() for t in threads) and len(results) == len(concurrent),
                "concurrent requests did not all finish")
        m = post(f"{b.base}/metrics", None)
        require(m["requests_total"] == len(concurrent) and m["errors_total"] == 0
                and m["waveforms_total"] == len(concurrent), f"/metrics {m}")
        require(m["device_calls_total"] < len(concurrent) and m["batched_requests_total"] >= 2,
                f"micro-batching did not coalesce: {m}")
    finally:
        b.stop()
    answers["concurrent"] = np.concatenate(
        [check_probs(results[i]["probs"], 1, f"concurrent {i}") for i in range(len(concurrent))])
    return answers


def reference_answers(predictor, reqs):
    """The same requests answered in-process (no HTTP)."""
    floats, pcm, stream, concurrent = reqs
    return {
        "float8": predictor.predict(floats, seed=1),
        "pcm16": predictor.predict(pcm, seed=2),
        "stream": predictor.predict([stream], seed=3),
        "concurrent": np.concatenate([predictor.predict([w], seed=s) for w, s in concurrent]),
    }


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes")


def kernel_phase(predictor, floats, launches):
    """Each kernel vs its plain version on the main path's tensors, timed."""
    import torch.nn.functional as tf

    from sept_tpu_torch.ops import conv_block1 as K
    from sept_tpu_torch.ops import mel as M

    dev = predictor.device
    buf, nf, max_t = predictor.bucket(floats)
    with torch.inference_mode():
        padded = torch.from_numpy(buf).to(dev)  # the float8 request: f32 rows
        flat, _ = predictor.windows(buf, nf, max_t, seed=1)
        conv, bn = predictor.model.conv[0], predictor.model.conv[1]
        w, b = conv.weight.detach(), conv.bias.detach()
        scale, shift = K.fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
        window, cos_m, sin_m, fb = M._tables(N_FFT, N_MELS, dev)

        mel_k = M.mel_db(padded, max_t, N_FFT, HOP, N_MELS)
        mel_p = M.mel_db_plain(padded, max_t, N_FFT, HOP, N_MELS)
        y_k, s_k = K.block1_conv_stats(flat, w, b)
        y_p, s_p = K.block1_conv_stats_plain(flat, w, b)
        pool_k = K.block1_norm_pool(y_p, scale, shift)
        pool_p = K.block1_norm_pool_plain(y_p, scale, shift)
        torch.cuda.synchronize()

        err = {
            "mel_db": float((mel_k - mel_p).abs().max()),
            "block1_conv_stats": float((y_k - y_p).abs().max()),
            "block1_norm_pool": float((pool_k - pool_p).abs().max()),
        }
        moments_rel = float(((s_k - s_p).abs() / s_p.abs().clamp(min=1e-6)).max())
        for name, e in err.items():
            log(f"{name}: max |kernel - plain| = {e:.3g} (tolerance {TOL[name]:g})")
            require(e <= TOL[name], f"{name} disagrees with its plain version: {e}")
        log(f"block1_conv_stats moments: max rel diff {moments_rel:.3g}")
        require(moments_rel <= MOMENTS_RTOL, f"moments disagree: {moments_rel}")

        def stft_chain():
            spec = torch.stft(padded, N_FFT, HOP, window=window, center=False,
                              return_complex=True)
            power = spec.real * spec.real + spec.imag * spec.imag
            return 10.0 * torch.log10(torch.clamp(power.transpose(1, 2) @ fb, min=M.AMIN))

        def cudnn_block(x):
            z = tf.conv2d(x, w, b, padding=2)
            z = tf.batch_norm(z, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                              training=False, eps=bn.eps)
            return tf.max_pool2d(torch.relu(z), 2)

        stft_err = float((stft_chain() - mel_k).abs().max())
        cudnn_err = float((cudnn_block(flat) - pool_k).abs().max())

        bsz, length = padded.shape
        n_freq = N_FFT // 2 + 1
        frames = bsz * max_t
        fb_nnz = int((fb != 0).sum())
        # the least work of the function, not of the kernel's dense DFT: a
        # real FFT (2.5 n log2 n, the usual count), window, power, the sparse
        # mel bank and the log; bytes: waves in, window and bank, dB out
        mel_bound = bound(
            frames * (2.5 * N_FFT * np.log2(N_FFT) + N_FFT + 3 * n_freq + 2 * fb_nnz
                      + N_MELS),
            4.0 * (bsz * length + N_FFT + fb_nnz + frames * N_MELS))
        n, _, h, wd = flat.shape
        c = w.shape[0]
        outs = n * c * h * wd
        k1_bound = bound(outs * (2 * 25 + 1 + 3),
                         4.0 * (n * h * wd + c * 26 + outs + 2 * c))
        k2_bound = bound(3.0 * outs, 4.0 * (outs + 2 * c + outs // 4))

        rows = [
            ("mel_db", "sept_tpu_torch/csrc/mel.cu",
             "sept_tpu/ops/pallas_frontend.py:54",
             lambda: M.mel_db(padded, max_t, N_FFT, HOP, N_MELS),
             lambda: M.mel_db_plain(padded, max_t, N_FFT, HOP, N_MELS),
             stft_chain, mel_bound),
            ("block1_conv_stats", "sept_tpu_torch/csrc/conv_block1.cu",
             "sept_tpu/ops/pallas_conv.py:120",
             lambda: K.block1_conv_stats(flat, w, b),
             lambda: K.block1_conv_stats_plain(flat, w, b),
             lambda: tf.conv2d(flat, w, b, padding=2), k1_bound),
            ("block1_norm_pool", "sept_tpu_torch/csrc/conv_block1.cu",
             "sept_tpu/ops/pallas_conv.py:155",
             lambda: K.block1_norm_pool(y_p, scale, shift),
             lambda: K.block1_norm_pool_plain(y_p, scale, shift),
             None, k2_bound),
        ]
        kernels = []
        for name, src, replaces, kern, plain, lib, (bound_ms, bound_by) in rows:
            kernels.append({
                "name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": launches[name], "max_abs_err": err[name],
                "ms": cuda_ms(kern), "plain_ms": cuda_ms(plain), "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None if lib is None else cuda_ms(lib),
            })
        kernels[1]["moments_max_rel_err"] = moments_rel
        block1 = {
            "shape": list(flat.shape),
            "kernels_ms": cuda_ms(lambda: K.block1_eval(
                flat, w, b, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)),
            "cudnn_chain_ms": cuda_ms(lambda: cudnn_block(flat)),
            "cudnn_chain_max_abs_diff": cudnn_err,
        }
        kernels[0]["bound_counts"] = "rFFT 2.5 n log2 n + sparse mel bank"
        kernels[0]["library"] = "torch.stft + matmul + log10"
        kernels[0]["library_max_abs_diff_db"] = stft_err
        kernels[1]["library"] = "F.conv2d (cuDNN, no moments)"
        shapes = {"mel_db": [list(padded.shape), max_t], "block1": list(flat.shape)}
    return kernels, block1, shapes


def edge_phase(device):
    """Each kernel against its plain version at shapes off the main path:
    ragged frame and pixel tiles, odd sizes, n_fft 1600, one row."""
    from sept_tpu_torch.ops import conv_block1 as K
    from sept_tpu_torch.ops import mel as M

    g = torch.Generator(device=device).manual_seed(SEED + 3)
    worst = {}
    with torch.inference_mode():
        for b, n_fft, t in ((1, 800, 37), (3, 1600, 70)):
            x = 0.3 * torch.randn(b, (t - 1) * HOP + n_fft + 77, device=device, generator=g)
            d = float((M.mel_db(x, t, n_fft, HOP, N_MELS)
                       - M.mel_db_plain(x, t, n_fft, HOP, N_MELS)).abs().max())
            worst["mel_db"] = max(worst.get("mel_db", 0.0), d)
        for b, h, w in ((1, 37, 29), (3, 64, 33)):
            x = torch.randn(b, 1, h, w, device=device, generator=g)
            wt = 0.2 * torch.randn(32, 1, 5, 5, device=device, generator=g)
            bias = 0.1 * torch.randn(32, device=device, generator=g)
            y_k, s_k = K.block1_conv_stats(x, wt, bias)
            y_p, s_p = K.block1_conv_stats_plain(x, wt, bias)
            rel = float(((s_k - s_p).abs() / s_p.abs().clamp(min=1e-6)).max())
            require(rel <= MOMENTS_RTOL, f"edge moments disagree: {rel}")
            worst["block1_conv_stats"] = max(worst.get("block1_conv_stats", 0.0),
                                             float((y_k - y_p).abs().max()))
            scale = 1 + 0.1 * torch.randn(32, device=device, generator=g)
            shift = 0.1 * torch.randn(32, device=device, generator=g)
            worst["block1_norm_pool"] = max(worst.get("block1_norm_pool", 0.0), float(
                (K.block1_norm_pool(y_p, scale, shift)
                 - K.block1_norm_pool_plain(y_p, scale, shift)).abs().max()))
    for name, e in worst.items():
        require(e <= TOL[name], f"{name} disagrees with its plain version at edge shapes: {e}")
    return worst


def latency_phase(predictor, rng):
    """/predict round trips (pcm16 wire format) at 1 and 8 utterances of 4 s,
    beside the server's own device-call time from /metrics."""
    out = {}
    for n in (1, 8):
        body = {"waveforms_pcm16": [
            base64.b64encode((speechlike(rng, 4 * 16000) * 20000).astype("<i2").tobytes()).decode()
            for _ in range(n)]}
        a = Serving(predictor)
        try:
            post(f"{a.base}/predict", body)  # warm
            ms = []
            for _ in range(7):
                t0 = time.perf_counter()
                check_probs(post(f"{a.base}/predict", body)["probs"], n, "latency")
                ms.append((time.perf_counter() - t0) * 1e3)
            device_call = post(f"{a.base}/metrics", None)["device_call_ms"]
        finally:
            a.stop()
        out[str(n)] = {"http_median": float(np.median(ms)), "http_min": float(min(ms)),
                       "http_max": float(max(ms)), "runs": len(ms), "utterance_s": 4.0,
                       "device_call_p50": device_call["p50"]}
    return out


def conv23_gflop(predictor, waves):
    """f32 operations of the blocks 2-3 convolutions (cuDNN) in one predict
    call: 2 * C_out * C_in * 5 * 5 per output pixel, SAME padding."""
    buf, nf, max_t = predictor.bucket(waves)
    with torch.inference_mode():
        n_win = predictor.windows(buf, nf, max_t)[0].shape[0]
    h, w, total = WIN // 2, N_MELS // 2, 0
    for i in (5, 10):
        co, ci, kh, kw = predictor.model.conv[i].weight.shape
        total += 2 * co * ci * kh * kw * h * w * n_win
        h, w = h // 2, w // 2
    return total / 1e9


def profile_phase(predictor, rng, n=8, reps=3):
    """Device time by kernel over ``reps`` predict calls of ``n`` 4 s pcm16
    utterances, the device's busy share of the wall time, and the rate of
    the blocks 2-3 convolutions."""
    from torch.profiler import ProfilerActivity, profile

    waves = [(speechlike(rng, 4 * 16000) * 20000).astype(np.int16) for _ in range(n)]
    predictor.predict(waves)  # warm
    gflop = conv23_gflop(predictor, waves)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            predictor.predict(waves, seed=1)
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    rows, host = [], []
    for evt in prof.key_averages():
        # device activities only (kernels, copies): an operator's own device
        # time repeats its kernels'
        if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            us = getattr(evt, "self_device_time_total", 0)
            if us > 0:
                rows.append((evt.key, us / 1e3 / reps, evt.count // reps))
        elif evt.self_cpu_time_total > 0:
            host.append((evt.key, evt.self_cpu_time_total / 1e3 / reps, evt.count // reps))
    rows.sort(key=lambda r: -r[1])
    host.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    # cuDNN's forward convolution kernels (xmma_fprop / implicit_convolve)
    conv_ms = sum(r[1] for r in rows if re.search(r"fprop|convolve", r[0]))
    conv23 = {"gflop_per_call": gflop, "device_ms_per_call": conv_ms or "not measured"}
    if conv_ms:
        conv23["tflop_per_s"] = gflop / conv_ms
        conv23["share_of_f32_peak"] = gflop * 1e9 / (conv_ms * 1e-3) / PEAK_F32_FLOPS
    return {"utterances": n, "utterance_s": 4.0, "wall_ms_per_call": wall_ms,
            "device_busy_ms_per_call": busy if rows else "not measured",
            "device_idle_share": 1 - busy / wall_ms if rows else "not measured",
            "blocks23_conv": conv23,
            "top": [{"kernel": k[:90], "ms": ms, "launches": c} for k, ms, c in rows[:12]],
            "host_top": [{"op": k[:60], "self_cpu_ms": ms, "calls": c}
                         for k, ms, c in host[:10]]}


def ptxas_summary(reports):
    lines = []
    for name, text in reports.items():
        fn = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                lines.append(f"{name}.cu {fn}: {line.split('ptxas info    :')[-1].strip()}")
    return lines


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a "
              "CUDA GPU", file=sys.stderr)
        return 1
    from sept_tpu_torch.ops import conv_block1, cuda_lib, mel

    t0 = time.perf_counter()
    log(f"device {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    reports = cuda_lib.build()
    for line in ptxas_summary(reports):
        log(f"ptxas {line}")
    log(f"build done in {time.perf_counter() - t0:.1f} s")

    weights = build_weights()
    gpu = make_predictor(weights, "cuda")
    reqs = make_requests(np.random.default_rng(SEED))

    counters = {"mel_db": mel.mel_db, "block1_conv_stats": conv_block1.block1_conv_stats,
                "block1_norm_pool": conv_block1.block1_norm_pool}
    for fn in counters.values():
        fn.launches = 0
    answers = serve_phase(gpu, reqs)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"served; kernel launches on the main path: {launches}")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} never launched on the main path")

    cpu = make_predictor(weights, "cpu")
    ref = reference_answers(cpu, reqs)
    for key, want in ref.items():
        diff = float(np.abs(answers[key] - want).max())
        log(f"{key}: max |gpu - cpu| probs = {diff:.3g}")
        require(diff <= PROBS_ATOL, f"{key}: GPU answers differ from the CPU port by {diff}")
    log(f"cpu reference done at {time.perf_counter() - t0:.1f} s")

    kernels, block1, shapes = kernel_phase(gpu, reqs[0], launches)
    log(f"kernel checks done at {time.perf_counter() - t0:.1f} s; shapes {shapes}")
    edges = edge_phase(gpu.device)
    log(f"edge-shape checks: max |kernel - plain| {edges}")
    latency = latency_phase(gpu, np.random.default_rng(SEED + 7))
    log(f"latency done at {time.perf_counter() - t0:.1f} s")
    prof = {str(n): profile_phase(gpu, np.random.default_rng(SEED + 8), n=n) for n in (1, 8)}
    log(f"profile done at {time.perf_counter() - t0:.1f} s")

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(json.dumps({"block1_eval": block1}))
    print(json.dumps({"latency_ms": latency}))
    print(json.dumps({"profile": prof}))
    print(smi)
    # last but one, so the end of the output always holds it
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
