#!/usr/bin/env python3
"""Time the bf16 mel kernel against variants of itself on one NVIDIA GPU.

    python3 mel_bf16_variants.py [--base DIR ...] [--rounds N] [--out FILE]

Builds ``sept_tpu_torch/csrc/mel.cu`` of this checkout, the same file of
each ``--base`` checkout (for example a ``git archive`` of the parent
commit unpacked under ``build/``) and copies of this checkout's file with
one part of the bf16 kernel cut out, each into its own library (one
``nvcc`` each, all started together), then times ``sept_mel_db_bf16`` of
every library on the same inputs at ``bench.py``'s ingest shape (1024 f32
waves of 40,800 samples, n_fft 800, hop 160, 128 mels -> 251 frames).

The cut variants say where the kernel's time goes; their outputs are
meaningless:

    no_dft_mma    the DFT's wgmma products removed
    no_mel_mma    the mel product's wgmma products removed
    no_copy       no table or bank copies (each stage's barrier completes
                  with 0 bytes expected)
    no_build      the windowed frame tile not built
    no_out        the dB not stored
    one_producer  one producer lane streams every stage, not four
    zero_acc      the DFT accumulators zeroed before each chunk's products
                  (with the scale-d 0 first product kept)
    skeleton      no_dft_mma + no_mel_mma + no_copy + no_build + no_out

Time: device time (CUDA events around 20 calls queued behind a sleep
kernel, as ``chip_smoke.py``'s ``device_ms``), in rounds that run the
libraries in order, then in reverse order.  Checks: this checkout's
output within the bf16 rule of ``mel_db_plain(..., bf16=True)`` (the
bounds of ``chip_smoke.py``), each base checkout's output against this
checkout's.  Prints one JSON line: per library its times, their median,
its max |diff| where it is checked, and whether ptxas warned that it
serialized wgmma (C7515 / C7520).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from sept_tpu_torch.ops import cuda_lib  # noqa: E402
from sept_tpu_torch.ops import mel as M  # noqa: E402

B, L, N_FFT, HOP, N_MELS = 1024, 40800, 800, 160, 128
BF16_MAX, BF16_P99 = 10 * np.log10(1 + 2.0 ** -7) + 1e-4, 1e-3
OUT_DIR = ROOT / "build" / "mel_bf16_variants"

DFT_MMA = ("          wgmma_ss<NA * 2>(acc, desc_sw128(a_slab + 32 * u), desc_sw128(b_tile + 32 * u),\n"
           "                           k > 0 || u > 0);", ";")
MEL_MMA = ("          wgmma_ss<32>(mel[h], desc_sw128(pt + 32 * q16),\n"
           "                       desc_sw128(fb + (2 * wg + h) * SUB_BYTES + 32 * q16), 1);", ";")
COPY = [("mbar_expect_tx(full + 8 * s, bytes);", "mbar_expect_tx(full + 8 * s, 0);"),
        ("bulk_copy(dst, src, bytes, full + 8 * s);", ";"),
        ("mbar_expect_tx(full + 8 * s, __popc(m) * SUB_BYTES);", "mbar_expect_tx(full + 8 * s, 0);"),
        ("bulk_copy(dst + ms * SUB_BYTES, src + ms * SUB_BYTES, SUB_BYTES, full + 8 * s);", ";")]
BUILD = ("build_tile_staged(cx, stage, seg_len, stage + SCRATCH_BYTES / 2 - k_pad, k_pad / 8, tid);",
         ";")
OUT = ("              *reinterpret_cast<float2*>(o) = make_float2(d0, d1);", ";")
CUTS = {
    "no_dft_mma": [DFT_MMA],
    "no_mel_mma": [MEL_MMA],
    "no_copy": COPY,
    "no_build": [BUILD],
    "no_out": [OUT],
    "one_producer": [("        if ((s & 3) == j) {", "        if (j == 0) {")],
    "zero_acc": [("  float acc[NA];\n",
                  "  float acc[NA];\n#pragma unroll\n  for (int i = 0; i < NA; ++i) acc[i] = 0.f;\n")],
    "skeleton": [DFT_MMA, MEL_MMA, *COPY, BUILD, OUT],
}


def sources(bases):
    """{name: source text}: this checkout's, each base's, each cut."""
    here = (ROOT / "sept_tpu_torch" / "csrc" / "mel.cu").read_text()
    out = {"this": here}
    for i, base in enumerate(bases):
        out[f"base{i}" if len(bases) > 1 else "base"] = (
            Path(base) / "sept_tpu_torch" / "csrc" / "mel.cu").read_text()
    for name, cuts in CUTS.items():
        s = here
        for old, new in cuts:
            if s.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} is not in mel.cu exactly once")
            s = s.replace(old, new)
        out[name] = s
    return out


def build_all(srcs):
    """Compile each source into OUT_DIR, all at once; {name: (lib path, ptxas log)}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in srcs.items():
        cu, so = OUT_DIR / f"mel_{name}.cu", OUT_DIR / f"libmel_{name}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen([cuda_lib._nvcc(), *cuda_lib._FLAGS, "-o", str(so),
                                             str(cu)],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    built = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {name} (exit {proc.returncode}):\n{log[-4000:]}")
        built[name] = (so, log)
    return built


def device_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = 1 << 25
    for _ in range(5):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()
        end.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
        cycles *= 2
    raise SystemExit("the device caught up with the host in every try: not measured")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", action="append", default=[],
                    help="another checkout whose mel.cu is timed beside this one")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")

    built = build_all(sources(args.base))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = 0.3 * torch.randn(B, L, device=dev, generator=gen)
    t = (L - N_FFT) // HOP + 1
    geometry = (ctypes.c_int * 5)()
    cuda_lib.load("mel").sept_mel_bf16_geometry(geometry)
    window, table, bank, masks = M._kernel_tables_bf16(N_FFT, N_MELS, tuple(geometry), dev)
    stream = torch.cuda.current_stream().cuda_stream
    calls, outs = {}, {}
    for name, (so, _) in built.items():
        lib = ctypes.CDLL(str(so))
        fn = lib.sept_mel_db_bf16
        fn.argtypes = cuda_lib._SIGNATURES["mel"]["sept_mel_db_bf16"][0]
        fn.restype = ctypes.c_int
        out = torch.empty(B, t, N_MELS, device=dev)
        calls[name] = (lambda fn=fn, out=out: fn(
            x.data_ptr(), window.data_ptr(), table.data_ptr(), bank.data_ptr(), masks.data_ptr(),
            out.data_ptr(), B, L, t, N_FFT, HOP, N_MELS, stream))
        err = calls[name]()
        if err:
            raise SystemExit(f"{name}: CUDA error {err}")
        outs[name] = out
    torch.cuda.synchronize()

    res = {name: {"ms": [], "serialized_wgmma": any(w in log for w in ("C7515", "C7520"))}
           for name, (_, log) in built.items()}
    plain = M.mel_db_plain(x, t, N_FFT, HOP, N_MELS, bf16=True)
    d = (outs["this"] - plain).abs().flatten()
    res["this"]["max_abs_err_vs_plain"] = float(d.max())
    res["this"]["p99_abs_err_vs_plain"] = float(np.percentile(d.cpu().numpy(), 99))
    if not (d.max() <= BF16_MAX and res["this"]["p99_abs_err_vs_plain"] <= BF16_P99):
        raise SystemExit(f"this checkout's kernel is off its plain version: {res['this']}")
    for name in res:
        if name.startswith("base"):
            res[name]["max_abs_diff_vs_this"] = float((outs[name] - outs["this"]).abs().max())

    names = list(calls)
    for _ in range(args.rounds):
        for order in (names, names[::-1]):
            for name in order:
                res[name]["ms"].append(device_ms(calls[name]))
    for r in res.values():
        r["median_ms"] = statistics.median(r["ms"])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    line = json.dumps({"shape": [B, L, t, N_FFT, HOP, N_MELS], "card": card.strip(),
                       "variants": res})
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
