#!/usr/bin/env python3
"""Time the floor + DCT kernel against variants of itself on one NVIDIA GPU.

    python3 floor_dct_variants.py [--base DIR ...] [--rounds N] [--out FILE]

Builds ``sept_tpu_torch/csrc/mfcc.cu`` of this checkout, the same file of
each ``--base`` checkout (for example a ``git archive`` of the parent
commit unpacked under ``build/``) and copies of this checkout's file with
one part of the kernel cut out, each into its own library (one ``nvcc``
each, all started together), then times ``sept_floor_dct`` of every
library on the same inputs at the featurize chunk's shape (61,632 rows of
128 mels -> 40 coefficients: the mfcc's 64 utterances x 963 frames), at
70,000 rows (more row tiles than the persistent grid's blocks) and at 4,000
and 1,001 rows (fewer row tiles than SMs).

The cut variants say where the kernel's time goes; their outputs are
meaningless:

    no_floor      the top_db floor not applied (no max)
    no_basis      the basis tile not laid out
    empty         the kernel returns once its barriers exist
    no_products   no mel or basis loads and no FMAs (the chunks still wait
                  for their copies)
    no_copy       no tensor copies (each stage's barrier completes with 0
                  bytes expected)
    no_out        the coefficients not stored
    unroll_1      the 4-mel step loop not unrolled (the kernel: by 4)
    unroll_2      ... unrolled by 2
    unroll_8      ... unrolled whole (8 steps a chunk)
    skeleton      no_products + no_copy + no_out

Time: device time (CUDA events around 20 calls queued behind a sleep
kernel, as ``chip_smoke.py``'s ``device_ms``), in rounds that run the
libraries in order, then in reverse order.  Checks: this checkout's output
within 1e-5 of max |plain| of ``floor_dct_plain`` (``chip_smoke.py``'s
rule), each base checkout's output against this checkout's.  Prints one
JSON line: per library and shape its times and their median, its max
|diff| where it is checked, and its registers (ptxas).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from sept_tpu_torch.ops import cuda_lib  # noqa: E402
from sept_tpu_torch.ops import mfcc as MF  # noqa: E402

SHAPES = ((61632, 128, 40), (70000, 128, 40), (4000, 128, 40), (1001, 128, 40))
RTOL = 1e-5
OUT_DIR = ROOT / "build" / "floor_dct_variants"

PRODUCTS = ("      for (int kq = 0; kq < KT / 4; ++kq) {",
            "      for (int kq = 0; kq < 0; ++kq) {")
COPY = [("            mbar_expect_tx(full + 8 * s, STAGE_BYTES);",
         "            mbar_expect_tx(full + 8 * s, 0);"),
        ("            tensor_copy(dst, &map, kc, r0, full + 8 * s);", "")]
OUT = [("        for (int e = lane; e < nv * n_mfcc / 4; e += 32) dst[e] = src[e];", ""),
       ("        for (int e = lane; e < nv * ct; e += 32) "
        "out[(r0 + e / ct) * n_mfcc + c0 + e % ct] = ob[e];", "")]
CUTS = {
    "no_floor": [(f"          m[i][{k}] = fmaxf(v.{c}, fl[i]);", f"          m[i][{k}] = v.{c};")
                 for k, c in enumerate("xyzw")],
    "no_basis": [("  for (int kb = warp; kb < nk; kb += FILL * CONSUMERS) {",
                  "  for (int kb = warp; kb < 0; kb += FILL * CONSUMERS) {")],
    "empty": [("  __syncthreads();\n\n  if (warp == CONSUMERS) {",
               "  __syncthreads();\n  if (n_tiles > 0) return;\n"
               "  if (warp == CONSUMERS) {")],
    "no_products": [PRODUCTS],
    "no_copy": COPY,
    "no_out": OUT,
    "unroll_1": [("#pragma unroll 4\n", "#pragma unroll 1\n")],
    "unroll_2": [("#pragma unroll 4\n", "#pragma unroll 2\n")],
    "unroll_8": [("#pragma unroll 4\n", "#pragma unroll\n")],
    "skeleton": [PRODUCTS, *COPY, *OUT],
}


def sources(bases):
    """{name: source text}: this checkout's, each base's, each cut."""
    here = (ROOT / "sept_tpu_torch" / "csrc" / "mfcc.cu").read_text()
    out = {"this": here}
    for i, base in enumerate(bases):
        out[f"base{i}" if len(bases) > 1 else "base"] = (
            Path(base) / "sept_tpu_torch" / "csrc" / "mfcc.cu").read_text()
    for name, cuts in CUTS.items():
        s = here
        for old, new in cuts:
            if s.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} is not in mfcc.cu exactly once")
            s = s.replace(old, new)
        out[name] = s
    return out


def build_all(srcs):
    """Compile each source into OUT_DIR, all at once; {name: (lib path, ptxas log)}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in srcs.items():
        cu, so = OUT_DIR / f"mfcc_{name}.cu", OUT_DIR / f"libmfcc_{name}.so"
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
                    help="another checkout whose mfcc.cu is timed beside this one")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")

    built = build_all(sources(args.base))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    res = {name: {"registers": [int(r) for r in re.findall(r"Used (\d+) registers", log)]}
           for name, (_, log) in built.items()}
    fns = {}
    for name, (so, _) in built.items():
        fn = ctypes.CDLL(str(so)).sept_floor_dct
        fn.argtypes = cuda_lib._SIGNATURES["mfcc"]["sept_floor_dct"][0]
        fn.restype = ctypes.c_int
        fns[name] = fn
    for rows, n_mels, n_mfcc in SHAPES:
        key = f"{rows}x{n_mels}->{n_mfcc}"
        mel = 20 * torch.randn(rows, n_mels, device=dev, generator=gen) - 40
        floor = 10 * torch.randn(rows, device=dev, generator=gen) - 60
        dct = MF.dct_basis(n_mfcc, n_mels, dev)
        calls, outs = {}, {}
        for name, fn in fns.items():
            out = torch.empty(rows, n_mfcc, device=dev)
            calls[name] = (lambda fn=fn, out=out: fn(
                mel.data_ptr(), floor.data_ptr(), dct.data_ptr(), out.data_ptr(), rows, n_mels,
                n_mfcc, stream))
            err = calls[name]()
            if err:
                raise SystemExit(f"{name}: CUDA error {err}")
            outs[name] = out
        torch.cuda.synchronize()
        plain = MF.floor_dct_plain(mel, floor, dct)
        scale = float(plain.abs().max())
        rel = float((outs["this"] - plain).abs().max()) / scale
        if not rel <= RTOL:
            raise SystemExit(f"this checkout's kernel is off its plain version at {key}: {rel}")
        for name in res:
            res[name][key] = {"ms": []}
            if name.startswith("base") or name == "this":
                res[name][key]["max_rel_diff_vs_plain"] = float(
                    (outs[name] - plain).abs().max()) / scale
        res["plain"] = res.get("plain", {})
        res["plain"][key] = {"ms": []}
        calls["plain"] = lambda: MF.floor_dct_plain(mel, floor, dct)
        names = list(calls)
        for _ in range(args.rounds):
            for order in (names, names[::-1]):
                for name in order:
                    res[name][key]["ms"].append(device_ms(calls[name]))
        for name in names:
            res[name][key]["median_ms"] = statistics.median(res[name][key]["ms"])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    line = json.dumps({"card": card.strip(), "variants": res})
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
