"""The port's storage seam (llark_tpu_torch/storage.py) and its callers
over fsspec's memory:// filesystem, beside the JAX package's.

Mirrors tests/test_storage.py case by case: each case runs the port's
function and, where the JAX package has it, the JAX package's on the same
inputs, and they must agree (memory:// takes the code path gs:// takes,
without a bucket or the network). Then what the port adds: its checkpoint
manager on a remote directory, tar shards written by one package and read
by the other, and a remote URL without fsspec raising as in the JAX
package.
"""

import builtins
import json

import numpy as np
import pytest
import torch

from llark_tpu import storage as jstorage
from llark_tpu.audio.io import read_wav as jread_wav
from llark_tpu.data import webdataset as jwds
from llark_tpu.data.records import RecordShardReader as JReader
from llark_tpu.data.records import iter_jsonl_records as jiter
from llark_tpu.inference.from_encodings import _load_npy as jload_npy
from llark_tpu.preprocessing import pipeline_cli as jpipeline_cli
from llark_tpu.train.checkpoint import load_projector_weights as jload
from llark_tpu_torch import storage
from llark_tpu_torch.audio.io import read_wav, write_wav
from llark_tpu_torch.data import webdataset as twds
from llark_tpu_torch.data.records import RecordShardReader, iter_jsonl_records
from llark_tpu_torch.encoders.extract_cli import _save_npy, list_shard
from llark_tpu_torch.inference.from_encodings import _load_npy
from llark_tpu_torch.preprocessing import pipeline_cli
from llark_tpu_torch.train.checkpoint import CheckpointManager, load_projector_weights
from llark_tpu_torch.train.state import TrainState

fsspec = pytest.importorskip("fsspec")


@pytest.fixture(autouse=True)
def _clean_memfs():
    fs = fsspec.filesystem("memory")
    for p in list(fs.store):
        fs.rm(p)
    yield


@pytest.mark.parametrize("path", ["gs://bucket/x", "memory://x", "/local/path",
                                  "relative/path.tar", "file:///local/path", "s3://b/k.npy"])
def test_is_remote(path):
    assert storage.is_remote(path) == jstorage.is_remote(path)
    assert storage.strip_file_scheme(path) == jstorage.strip_file_scheme(path)
    assert storage.is_remote(path) == ("://" in path and not path.startswith("file://"))


def test_roundtrip_bytes_exists_glob():
    storage.write_bytes("memory://bkt/a/one.npy", b"111")
    jstorage.write_bytes("memory://bkt/a/two.npy", b"222")
    assert storage.exists("memory://bkt/a/one.npy")
    assert not storage.exists("memory://bkt/a/three.npy")
    assert storage.read_bytes("memory://bkt/a/two.npy") == b"222"
    got = storage.fs_glob("memory://bkt/a/*.npy")
    assert got == jstorage.fs_glob("memory://bkt/a/*.npy")
    assert [g.rsplit("/", 1)[1] for g in got] == ["one.npy", "two.npy"]
    assert all(g.startswith("memory://") for g in got)
    assert storage.listdir("memory://bkt/a") == jstorage.listdir("memory://bkt/a") == [
        "one.npy", "two.npy"]


def test_join_and_local_paths(tmp_path):
    for base, parts in (("memory://b/", ("x", "y.wav")), (str(tmp_path), ("sub", "f.txt")),
                        ("file://" + str(tmp_path), ("g.txt",))):
        assert storage.join(base, *parts) == jstorage.join(base, *parts)
    p = storage.join(str(tmp_path), "sub", "f.txt")
    storage.write_bytes(p, b"hi")
    assert storage.read_bytes(p) == b"hi"
    assert storage.fs_glob(str(tmp_path / "sub" / "*.txt")) == [p]


def test_local_input_output_staging():
    storage.write_bytes("memory://bkt/in.wav", b"RIFFdata")
    with storage.local_input("memory://bkt/in.wav") as lp:
        assert open(lp, "rb").read() == b"RIFFdata"
    with storage.local_output("memory://bkt/out.bin") as lp:
        open(lp, "wb").write(b"payload")
    assert storage.read_bytes("memory://bkt/out.bin") == b"payload"


def test_wav_roundtrip_remote():
    x = np.sin(np.arange(4410) / 20).astype(np.float32)
    write_wav("memory://bkt/clip.wav", x, 44100)
    y, sr = read_wav("memory://bkt/clip.wav", target_sr=44100)
    assert sr == 44100
    np.testing.assert_allclose(y, x, atol=1e-3)
    np.testing.assert_array_equal(y, jread_wav("memory://bkt/clip.wav", target_sr=44100)[0])


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_tar_shards_remote_write_read(writer):
    Writer = twds.TarShardWriter if writer == "port" else jwds.TarShardWriter
    with Writer("memory://bkt/shard-%05d.tar", max_count=2) as w:
        for i in range(5):
            w.write({
                "__key__": f"k{i}",
                "json": {"id": i},
                "audio_encoding.pyd": np.full((3, 4), i, np.float32),
            })
    paths = storage.fs_glob("memory://bkt/shard-*.tar")
    assert len(paths) == 3  # 2 + 2 + 1
    # remote shards take the Python streaming reader, never the native
    # local-file loader
    for Reader in (twds.TarShardReader, jwds.TarShardReader):
        samples = list(Reader(paths))
        assert [s["json"]["id"] for s in samples] == list(range(5))
        np.testing.assert_array_equal(
            samples[3]["audio_encoding.pyd"], np.full((3, 4), 3, np.float32)
        )


def test_jsonl_records_remote():
    rows = [{"id": i, "text": f"t{i}"} for i in range(3)]
    storage.write_bytes(
        "memory://bkt/r.jsonl", "".join(json.dumps(r) + "\n" for r in rows).encode()
    )
    assert list(iter_jsonl_records("memory://bkt/r.jsonl")) == rows == list(
        jiter("memory://bkt/r.jsonl"))


def test_record_reader_skips_missing_remote():
    rec = {"id": 1, "json": {"response": []}, "audio_encoding": [0.0, 1.0]}
    storage.write_bytes("memory://bkt/ok.jsonl", (json.dumps(rec) + "\n").encode())
    paths = ["memory://bkt/missing.jsonl", "memory://bkt/ok.jsonl"]
    got = list(RecordShardReader(paths))
    assert len(got) == 1 == len(list(JReader(paths)))


def test_checkpoint_dir_normalization(tmp_path):
    local = storage.normalize_checkpoint_dir(str(tmp_path / "ck"))
    assert local.startswith("/") and (tmp_path / "ck").is_dir()
    assert local == jstorage.normalize_checkpoint_dir(str(tmp_path / "ck"))
    # remote URLs pass through unmangled; abspath-ing one would corrupt it
    # into /cwd/gs:/...
    assert storage.normalize_checkpoint_dir("gs://bkt/ck/") == "gs://bkt/ck" == \
        jstorage.normalize_checkpoint_dir("gs://bkt/ck/")


def test_projector_sidesave_remote():
    with storage.fopen("memory://bkt/proj.npz", "wb") as f:
        np.savez(f, **{"mm_projector.kernel": np.ones((2, 3), np.float32)})
    w = load_projector_weights("memory://bkt/proj.npz")
    np.testing.assert_array_equal(w["mm_projector.kernel"], np.ones((2, 3)))
    np.testing.assert_array_equal(w["mm_projector.kernel"],
                                  jload("memory://bkt/proj.npz")["mm_projector.kernel"])


def test_npy_save_load_remote():
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    _save_npy("memory://bkt/e/x.npy", arr)
    np.testing.assert_array_equal(_load_npy("memory://bkt/e/x.npy"), arr)
    got = storage.fs_glob("memory://bkt/e/*.npy")
    # fsspec's canonical memory:// form is memory:///rooted/path; globbed
    # URLs must stay loadable whatever the canonical spelling
    assert len(got) == 1 and got[0].startswith("memory://")
    np.testing.assert_array_equal(_load_npy(got[0]), jload_npy(got[0]))
    # the extraction CLI's shard list skips a file whose .npy the remote
    # output directory already holds
    for name in ("x.wav", "y.wav"):
        storage.write_bytes(f"memory://bkt/w/{name}", b"RIFF")
    assert list_shard("memory://bkt/w", 1, 0, True, "memory://bkt/e") == ["y.wav"]


def test_pipeline_annotate_remote():
    """pipeline_cli annotate: remote jsonl in/out + remote audio dir, the
    rows equal to the JAX package's CLI on the same files."""
    t = np.arange(44100) / 44100.0
    wav = (0.5 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    write_wav("memory://bkt/audio/42.wav", wav, 44100)
    storage.write_bytes("memory://bkt/rows.jsonl", b'{"id": "42"}\n')
    out = {}
    for name, cli in (("port", pipeline_cli), ("reference", jpipeline_cli)):
        cli.main([
            "annotate",
            "--input-jsonl", "memory://bkt/rows.jsonl",
            "--audio-dir", "memory://bkt/audio",
            "--output", f"memory://bkt/{name}.jsonl",
            "--workers", "1",
        ])
        out[name] = [json.loads(l) for l in
                     storage.read_bytes(f"memory://bkt/{name}.jsonl").splitlines()]
    assert len(out["port"]) == 1 and out["port"][0]["id"] == "42"
    assert "tempo_in_beats_per_minute_madmom" in out["port"][0]
    assert out["port"] == out["reference"]


def test_checkpoint_manager_on_a_remote_directory():
    """Save (under a temporary name, moved into place), list, keep the last
    `save_total_limit`, restore in place, side-save the projector."""
    gen = torch.Generator().manual_seed(0)
    params = {"embed": torch.randn(4, 3, generator=gen),
              "mm_projector": {"kernel": torch.randn(3, 2, generator=gen),
                               "bias": torch.zeros(2)}}
    mgr = CheckpointManager("memory://bkt/run/", save_total_limit=2, save_projector=True)
    assert mgr.directory == "memory://bkt/run" and mgr.latest_step() is None
    for step in (1, 2, 3):
        opt = {"mu": [torch.full((4, 3), float(step))], "nu": [torch.ones(4, 3)], "count": step}
        mgr.save(step, TrainState(params, opt, step), {"seen": step})
    assert mgr.steps() == [2, 3]
    assert sorted(storage.listdir("memory://bkt/run")) == ["checkpoint-2", "checkpoint-3",
                                                           "mm_projector"]
    live = TrainState({"embed": torch.zeros(4, 3),
                       "mm_projector": {"kernel": torch.zeros(3, 2), "bias": torch.ones(2)}},
                      {"mu": [torch.zeros(4, 3)], "nu": [torch.zeros(4, 3)], "count": 0})
    state, data_state = mgr.restore(live)
    assert state.step == 3 and data_state == {"seen": 3}
    assert torch.equal(state.params["embed"], params["embed"])
    assert torch.equal(state.opt_state["mu"][0], torch.full((4, 3), 3.0))
    side = load_projector_weights("memory://bkt/run/mm_projector/checkpoint-3.npz")
    np.testing.assert_array_equal(side["mm_projector.kernel"],
                                  params["mm_projector"]["kernel"].numpy())


def test_remote_url_without_fsspec_raises_as_the_reference(monkeypatch):
    real_import = builtins.__import__

    def no_fsspec(name, *args, **kw):
        if name.split(".")[0] == "fsspec":
            raise ImportError("No module named 'fsspec'")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_fsspec)
    for mod in (storage, jstorage):
        with pytest.raises(ImportError, match="fsspec"):
            mod.fopen("memory://bkt/x.bin")
        with pytest.raises(ImportError, match="fsspec"):
            mod.exists("memory://bkt/x.bin")
    assert storage.exists("/nonexistent/local/path") is False  # local paths need no fsspec
