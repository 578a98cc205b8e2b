"""The port's WAV decoder (its own build of csrc/septio.cpp) against the JAX
package's native decoder, bit for bit, and its refusal to fall back."""

import os
import stat
import struct

import numpy as np
import pytest

from sept_tpu.runtime import wavio as jwavio
from sept_tpu_torch.runtime import wavio


def riff(fmt_tag, channels, rate, bits, payload, extensible=False):
    """A RIFF/WAVE file: a fmt chunk (optionally WAVE_FORMAT_EXTENSIBLE
    wrapping ``fmt_tag``) and a data chunk."""
    block = channels * bits // 8
    fmt = struct.pack("<HHIIHH", 0xFFFE if extensible else fmt_tag, channels, rate,
                      rate * block, block, bits)
    if extensible:
        fmt += struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", fmt_tag) + bytes(14)
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    body += b"data" + struct.pack("<I", len(payload)) + payload
    if len(payload) % 2:
        body += b"\0"
    return b"RIFF" + struct.pack("<I", len(body)) + body


def samples(rng, n, channels):
    t = np.arange(n) / 16000.0
    x = 0.4 * np.sin(2 * np.pi * 220 * t)[:, None] + 0.1 * rng.standard_normal((n, channels))
    return np.clip(x, -1, 1)


def encode(x, kind):
    if kind == "int16":
        return np.rint(x * 32767).astype("<i2").tobytes(), 1, 16
    if kind == "uint8":
        return np.rint(x * 127 + 128).astype(np.uint8).tobytes(), 1, 8
    if kind == "int24":
        v = np.rint(x * 8388607).astype("<i4").reshape(-1, 1).view(np.uint8)[:, :3]
        return v.tobytes(), 1, 24
    if kind == "int32":
        return np.rint(x * 2147483000).astype("<i4").tobytes(), 1, 32
    if kind == "float32":
        return x.astype("<f4").tobytes(), 3, 32
    return x.astype("<f8").tobytes(), 3, 64


CASES = [(kind, rate, ch) for kind in ("int16", "float32", "float64")
         for rate in (8000, 16000, 22050, 44100) for ch in (1, 2)]
CASES += [("uint8", 16000, 1), ("int24", 44100, 2), ("int32", 22050, 1)]


def write_case(path, rng, kind, rate, channels, seconds=0.7, extensible=False):
    payload, tag, bits = encode(samples(rng, int(seconds * rate), channels), kind)
    path.write_bytes(riff(tag, channels, rate, bits, payload, extensible))
    return str(path)


@pytest.mark.parametrize("kind,rate,channels", CASES)
def test_decode_is_bit_equal_to_jax(tmp_path, kind, rate, channels):
    assert jwavio.have_native()
    path = write_case(tmp_path / "a.wav", np.random.default_rng(rate + channels), kind, rate,
                      channels)
    for target in (16000, 8000):
        ours, sr = wavio.decode_wav(path, target)
        theirs, jsr = jwavio.decode_wav(path, target)
        assert sr == jsr == target
        assert ours.dtype == theirs.dtype == np.float32
        assert len(ours) == len(theirs) > 0 and np.array_equal(ours, theirs)
    short, _ = wavio.decode_wav(path, 16000, max_seconds=0.25)
    assert len(short) == 4000
    assert np.array_equal(short, jwavio.decode_wav(path, 16000, max_seconds=0.25)[0])


@pytest.mark.parametrize("n_threads", [1, 3, 8])
def test_decode_batch_is_bit_equal_to_jax(tmp_path, n_threads):
    """Mixed formats, rates and channel counts across threads; a malformed
    file and a missing one are rows of length 0 in both."""
    rng = np.random.default_rng(n_threads)
    paths = [write_case(tmp_path / f"{i}.wav", rng, *CASES[(5 * i) % len(CASES)],
                        seconds=0.2 + 0.1 * i) for i in range(11)]
    (tmp_path / "bad.wav").write_bytes(b"RIFF\x10\0\0\0WAVEjunkjunk")
    paths += [str(tmp_path / "bad.wav"), str(tmp_path / "missing.wav")]
    mat, lens = wavio.decode_batch(paths, max_seconds=2.0, n_threads=n_threads)
    jmat, jlens = jwavio.decode_batch(paths, max_seconds=2.0, n_threads=n_threads)
    assert np.array_equal(lens, jlens) and lens[-2:].tolist() == [0, 0] and (lens[:-2] > 0).all()
    assert mat.dtype == jmat.dtype and np.array_equal(mat, jmat)
    for i, p in enumerate(paths[:3]):
        assert np.array_equal(mat[i, :lens[i]], wavio.decode_wav(p, max_seconds=2.0)[0])


@pytest.mark.parametrize("case", ["not_riff", "truncated", "adpcm", "mulaw", "float16",
                                  "extensible_adpcm", "no_data"])
def test_refuses_what_jax_refuses(tmp_path, case):
    path = tmp_path / f"{case}.wav"
    pcm = np.zeros(800, "<i2").tobytes()
    data = {"not_riff": b"RIFX" + bytes(60),
            "truncated": riff(1, 1, 16000, 16, pcm)[:30],
            "adpcm": riff(2, 1, 16000, 4, pcm),
            "mulaw": riff(7, 1, 16000, 8, pcm),
            "float16": riff(3, 1, 16000, 16, pcm),
            "extensible_adpcm": riff(2, 1, 16000, 16, pcm, extensible=True),
            "no_data": riff(1, 1, 16000, 16, pcm)[:36]}[case]
    path.write_bytes(data)
    with pytest.raises(IOError):
        jwavio.decode_wav(str(path))
    with pytest.raises(IOError, match="septio failed to decode"):
        wavio.decode_wav(str(path))
    assert wavio.decode_batch([str(path)])[1].tolist() == [0]


def test_extensible_pcm_decodes_as_jax(tmp_path):
    path = write_case(tmp_path / "x.wav", np.random.default_rng(0), "int16", 22050, 2,
                      extensible=True)
    ours, theirs = wavio.decode_wav(path)[0], jwavio.decode_wav(path)[0]
    assert len(ours) > 0 and np.array_equal(ours, theirs)


@pytest.mark.parametrize("rate", [16000, 44100])
def test_write_wav_gives_the_same_bytes(tmp_path, rate):
    x = (1.3 * samples(np.random.default_rng(rate), 5000, 1)[:, 0]).astype(np.float32)
    wavio.write_wav(str(tmp_path / "ours.wav"), x, rate)
    jwavio.write_wav(str(tmp_path / "theirs.wav"), x, rate)
    assert (tmp_path / "ours.wav").read_bytes() == (tmp_path / "theirs.wav").read_bytes()
    back, sr = wavio.decode_wav(str(tmp_path / "ours.wav"), target_sr=rate)
    assert sr == rate and np.array_equal(wavio.narrow_pcm16(back),
                                         np.rint(np.clip(x, -1, 1) * 32767).astype(np.int16))


def test_narrow_pcm16_matches_jax():
    rng = np.random.default_rng(1)
    exact = (rng.integers(-32768, 32768, 300) / 32768.0).astype(np.float32)
    cases = [exact, exact + np.float32(1e-6), exact.astype(np.float64),
             np.ones(4, np.float32), exact.reshape(3, 100), exact.astype(np.int16)]
    for w in cases:
        ours, theirs = wavio.narrow_pcm16(w), jwavio.narrow_pcm16(w)
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
    assert wavio.narrow_pcm16(exact).dtype == np.int16


def test_builds_into_its_own_directory():
    """The port loads its own library, never the JAX package's."""
    path = wavio.build()
    assert path.parent.name == "torch_septio" and path.is_file()
    assert path.resolve() != (wavio._SRC.parents[1] / "build" / "libseptio.so").resolve()


def test_no_compiler_raises_and_does_not_fall_back(tmp_path, monkeypatch):
    monkeypatch.setattr(wavio, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(wavio.shutil, "which", lambda name: None)
    wav = tmp_path / "a.wav"
    wav.write_bytes(riff(1, 1, 16000, 16, np.zeros(160, "<i2").tobytes()))
    for call in (lambda: wavio.decode_wav(str(wav)), lambda: wavio.decode_batch([str(wav)]),
                 lambda: wavio.write_wav(str(tmp_path / "b.wav"), np.zeros(4, np.float32))):
        with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
            call()
    assert not (tmp_path / "b.wav").exists()


def test_failed_build_raises(tmp_path, monkeypatch):
    fake = tmp_path / "bin" / "c++"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'no such compiler' >&2\nexit 3\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(wavio, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(fake.parent) + os.pathsep + os.environ["PATH"])
    with pytest.raises(RuntimeError, match="building the WAV decoder failed.*exit 3"):
        wavio.decode_wav(str(tmp_path / "a.wav"))
    assert not list((tmp_path / "build").glob("*"))


def test_have_native_probes_the_build(tmp_path, monkeypatch):
    """True where the library builds and loads, as the JAX package's; False
    without a compiler, where the decoders still raise (no fallback)."""
    assert wavio.have_native() and jwavio.have_native()
    monkeypatch.setattr(wavio, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(wavio.shutil, "which", lambda name: None)
    assert wavio.have_native() is False
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        wavio.decode_batch([str(tmp_path / "a.wav")])
