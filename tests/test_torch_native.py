"""The port's native host libraries (`llark_tpu_torch/native/`) against the
JAX package's, on the CPU.

Both packages build the same C++ sources with the same g++ flags on this
host, so the parse, the resample and peak normalisation must be BITWISE
equal; the numpy routes the port keeps match the native ones within 1e-4 in
the interior, as the JAX package states. The tar loader must yield the JAX
reader's samples in its order, with native on and off; gzipped shards go to
the Python reader, corrupt ones are skipped with a warning, and a failed
build raises with the compiler's message instead of falling back.
"""

import gzip
import io
import logging
import os
import struct
import tarfile

import numpy as np
import pytest

from llark_tpu.audio import io as jio
from llark_tpu.data import webdataset as jwds
from llark_tpu.native import build as jbuild
from llark_tpu_torch.audio import io as tio
from llark_tpu_torch.data import webdataset as twds
from llark_tpu_torch.native import build as nbuild
from llark_tpu_torch.native import tarloader


@pytest.fixture(autouse=True, scope="module")
def _reference_native_library():
    """The JAX package builds its library next to its source on first use;
    a worker that loads it while another worker's g++ is still writing it
    falls back to numpy for good. Load it again once the file is whole."""
    if jbuild.load_library() is None:
        jbuild._tried = False
        assert jbuild.load_library() is not None, "the JAX package's native build failed"


def _wav(channels: np.ndarray, sr: int, fmt: int, bits: int) -> bytes:
    """A RIFF/WAVE file of `channels` [T, C] float samples in PCM 16/24/32
    (fmt 1) or float32 (fmt 3)."""
    x = np.clip(channels, -1.0, 1.0)
    if fmt == 3:
        data = x.astype("<f4").tobytes()
    elif bits == 24:
        v = (x * 8388607.0).astype(np.int32).reshape(-1)
        data = np.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF], 1).astype(np.uint8).tobytes()
    else:
        scale, dt = {16: (32767.0, "<i2"), 32: (2147483647.0, "<i4")}[bits]
        data = (x.astype(np.float64) * scale).astype(dt).tobytes()
    n_ch = x.shape[1]
    block = n_ch * bits // 8
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, fmt, n_ch, sr, sr * block, block, bits)
    return hdr + b"data" + struct.pack("<I", len(data)) + data


@pytest.mark.parametrize("pair", [(22050, 44100), (44100, 48000), (48000, 16000),
                                  (44100, 44100)])
def test_native_resample_is_bitwise_the_reference(pair):
    x = (0.3 * np.random.RandomState(1).randn(30000)).astype(np.float32)
    before = nbuild.calls["resample"]
    got, want = tio.resample(x, *pair), jio.resample(x, *pair)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert nbuild.calls["resample"] == before + (pair[0] != pair[1])
    if pair[0] != pair[1]:
        # the numpy route, in the interior (the edges handle the boundary otherwise)
        ref = tio._resample_numpy(x, *pair)
        n = len(ref)
        np.testing.assert_allclose(ref[n // 8: -n // 8], got[n // 8: -n // 8], rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", ["pcm16", "pcm24", "pcm32", "float32"])
def test_native_parse_is_bitwise_the_reference(kind):
    fmt, bits = {"pcm16": (1, 16), "pcm24": (1, 24), "pcm32": (1, 32), "float32": (3, 32)}[kind]
    stereo = 0.4 * np.random.RandomState(2).randn(4000, 2).astype(np.float32)
    data = _wav(stereo, 32000, fmt, bits)
    before = nbuild.calls["parse_wav"]
    (got, sr), (want, jsr) = tio.parse_wav_bytes(data), jio.parse_wav_bytes(data)
    assert nbuild.calls["parse_wav"] == before + 1
    assert sr == jsr == 32000 and got.shape == want.shape == (4000,)
    np.testing.assert_array_equal(got, want)
    # the numpy parser reads the same file alike, to float32 rounding
    np.testing.assert_allclose(tio._parse_wav_numpy(data)[0], got, rtol=0, atol=1e-6)


def test_read_wav_goes_through_the_native_library(tmp_path):
    path = str(tmp_path / "a.wav")
    tio.write_wav(path, 0.3 * np.random.RandomState(3).randn(22050, 2), 44100)
    before = dict(nbuild.calls)
    got, sr = tio.read_wav(path, 48000)
    want, _ = jio.read_wav(path, 48000)
    assert sr == 48000
    np.testing.assert_array_equal(got, want)
    assert nbuild.calls["parse_wav"] == before.get("parse_wav", 0) + 1
    assert nbuild.calls["resample"] == before.get("resample", 0) + 1


def test_peak_normalize_equal_and_never_mutates():
    x = (0.2 * np.random.RandomState(4).randn(5000)).astype(np.float32)
    keep = x.copy()
    got, want = tio.peak_normalize(x), jio.peak_normalize(x)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(x, keep)
    assert np.abs(got).max() == 1.0
    silent = np.zeros(10, np.float32)
    np.testing.assert_array_equal(tio.peak_normalize(silent), silent)


def test_native_wav_rejects_zero_bits():
    """bits < 8 surfaces as a ValueError, not a SIGFPE in the parser."""
    hdr = b"RIFF" + struct.pack("<I", 36) + b"WAVE"
    hdr += b"fmt " + struct.pack("<I", 16)
    hdr += struct.pack("<HHIIHH", 1, 1, 8000, 8000, 1, 4)  # bits = 4
    hdr += b"data" + struct.pack("<I", 8) + b"\x00" * 8
    with pytest.raises(ValueError):
        tio.parse_wav_bytes(hdr)


def test_wav_parser_fuzz_never_crashes_and_agrees(tmp_path):
    """Truncated, bit-flipped and random buffers raise or return, never
    kill the process, and give the JAX package's answer."""
    rng = np.random.RandomState(0)
    path = str(tmp_path / "x.wav")
    tio.write_wav(path, rng.randn(2000).astype(np.float32) * 0.5, 8000)
    valid = open(path, "rb").read()
    cases = [valid[:n] for n in (0, 3, 11, 44, 100)]
    for _ in range(30):
        buf = bytearray(valid)
        for _ in range(8):  # random bit flips, RIFF/WAVE magic kept
            i = rng.randint(12, len(buf))
            buf[i] ^= 1 << rng.randint(8)
        cases.append(bytes(buf))
    for _ in range(20):
        cases.append(b"RIFF" + rng.bytes(60) + b"WAVE" + rng.bytes(200))
        cases.append(rng.bytes(rng.randint(1, 400)))
    for bits in (0, 1, 4, 64, 255):
        h = b"RIFF" + struct.pack("<I", 36) + b"WAVE" + b"fmt " + struct.pack("<I", 16)
        h += struct.pack("<HHIIHH", 1, 1, 8000, 8000, 1, bits)
        cases.append(h + b"data" + struct.pack("<I", 4) + b"\x00" * 4)
    for data in cases:
        outcome = []
        for parse in (tio.parse_wav_bytes, jio.parse_wav_bytes):
            try:
                x, sr = parse(data)
                outcome.append((x, sr))
            except (ValueError, struct.error, IndexError) as e:
                outcome.append(type(e))
        got, want = outcome
        if isinstance(want, tuple):
            assert isinstance(got, tuple) and got[1] == want[1]
            np.testing.assert_array_equal(got[0], want[0])
        else:
            assert got is want


def test_failed_build_raises_with_the_compilers_message(tmp_path, monkeypatch):
    monkeypatch.setattr(nbuild, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(nbuild, "_libs", {})
    monkeypatch.setattr(nbuild, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+.*No such file"):
        nbuild.load_library()
    monkeypatch.setattr(nbuild, "CXX", "g++")
    monkeypatch.setattr(nbuild, "CXX_FLAGS", nbuild.CXX_FLAGS + ("-fno-such-option",))
    with pytest.raises(RuntimeError, match="fno-such-option"):
        nbuild.load("audioproc.cpp")
    assert os.listdir(tmp_path) == []  # nothing half-built left behind
    # and the audio path raises with it: no quiet numpy fallback
    with pytest.raises(RuntimeError, match="native build of audioproc.cpp failed"):
        tio.resample(np.zeros(100, np.float32), 44100, 48000)


def test_build_goes_to_the_build_dir_under_a_hashed_name():
    path = nbuild.lib_path("audioproc.cpp")
    assert os.path.dirname(path) == nbuild.BUILD_DIR
    assert os.path.basename(os.path.dirname(path)) == "_build"
    assert nbuild.BUILD_DIR.endswith(os.path.join("llark_tpu_torch", "_build"))
    assert path != nbuild.lib_path("tarloader.cpp")
    nbuild.load("tarloader.cpp")
    assert os.path.exists(nbuild.lib_path("tarloader.cpp"))


# ---------------------------------------------------------------------------
# the tar loader
# ---------------------------------------------------------------------------


def _shards(tmp_path, n_shards=3, per_shard=4):
    rng = np.random.RandomState(5)
    w = twds.TarShardWriter(str(tmp_path / "s-%05d.tar"), max_count=per_shard)
    for i in range(n_shards * per_shard):
        w.write({"__key__": f"dir/track{i:03d}-start30_000", "json": {"i": i, "q": "x" * i},
                 "audio_encoding.pyd": rng.randn(3, 5).astype(np.float32),
                 "enc.npy": rng.randn(2).astype(np.float32), "note.txt": f"t{i}"})
    w.close()
    return w.written_paths


def _same(got, want):
    assert [s["__key__"] for s in got] == [s["__key__"] for s in want]
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(b[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k]


@pytest.mark.parametrize("use_native", [True, False])
def test_tar_reader_yields_the_reference_samples_in_order(tmp_path, use_native):
    paths = _shards(tmp_path)
    before = nbuild.calls["tar_samples"]
    got = list(twds.TarShardReader(paths, use_native=use_native))
    want = list(jwds.TarShardReader(paths, use_native=False))
    _same(got, want)
    _same(list(jwds.TarShardReader(paths)), want)  # the JAX native loader too
    assert len(got) == 12
    assert nbuild.calls["tar_samples"] == before + (12 if use_native else 0)


def test_use_native_false_is_accepted_and_the_env_switch_holds(tmp_path, monkeypatch):
    """Fault 8: the port's reader lacked the reference's `use_native`."""
    paths = _shards(tmp_path, 1, 3)
    assert twds.TarShardReader(paths, "warn", use_native=False).use_native is False
    assert twds.TarShardReader(paths).use_native is True
    assert twds.TarShardReader(paths, handler="raise", use_native=True).handler == "raise"
    monkeypatch.setenv("LLARK_TPU_NO_NATIVE_TAR", "1")
    before = nbuild.calls["tar_samples"]
    reader = twds.TarShardReader(paths)
    assert reader.use_native is False
    assert len(list(reader)) == 3 and nbuild.calls["tar_samples"] == before


def test_gzipped_shard_goes_to_the_python_reader(tmp_path, caplog):
    paths = _shards(tmp_path, 1, 2)
    gz = tmp_path / "s.tar.gz"
    gz.write_bytes(gzip.compress(open(paths[0], "rb").read()))
    assert not twds.TarShardReader._native_parsable(str(gz))
    assert twds.TarShardReader._native_parsable(paths[0])
    assert not twds.TarShardReader._native_parsable(str(tmp_path / "missing.tar"))
    with caplog.at_level(logging.WARNING):
        got = list(twds.TarShardReader([paths[0], str(gz)]))
    assert "Python reader" in caplog.text
    _same(got, list(jwds.TarShardReader([paths[0], str(gz)])))
    assert len(got) == 4 and got[2]["json"]["i"] == 0


def test_corrupt_shards_and_members_are_skipped_with_a_warning(tmp_path, caplog):
    paths = _shards(tmp_path, 2, 3)
    garbage = tmp_path / "garbage.tar"
    garbage.write_bytes(np.random.RandomState(6).bytes(3000))
    # a shard whose third header's checksum no longer checks out
    broken = tmp_path / "broken.tar"
    raw = bytearray(open(paths[0], "rb").read())
    with tarfile.open(paths[0]) as tf:
        offsets = [m.offset for m in tf.getmembers()]
    raw[offsets[2] + 10] ^= 0x55
    broken.write_bytes(bytes(raw))
    # a member that does not decode
    bad_member = tmp_path / "member.tar"
    with tarfile.open(bad_member, "w") as tf:
        for name, payload in (("k.json", b"{not json"), ("k.txt", b"fine")):
            info = tarfile.TarInfo(name)
            info.size = len(payload)
            tf.addfile(info, io.BytesIO(payload))
    for shards in ([str(broken), paths[1]], [str(bad_member), paths[1]],
                   [paths[0], str(garbage), paths[1]]):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            got = list(twds.TarShardReader(shards))
        want = list(jwds.TarShardReader(shards, use_native=False))
        _same(got, want)
        assert "corrupt" in caplog.text or "Python reader" in caplog.text
    assert len(list(twds.TarShardReader([paths[0], str(garbage), paths[1]]))) == 6
    with pytest.raises(tarfile.TarError):
        list(twds.TarShardReader([str(garbage)], handler="raise"))


def test_iter_samples_gives_raw_bytes(tmp_path):
    paths = _shards(tmp_path, 2, 2)
    raw = list(tarloader.iter_samples(paths))
    assert [r["__key__"] for r in raw] == [f"dir/track{i:03d}-start30_000" for i in range(4)]
    assert raw[1]["note.txt"] == b"t1"
