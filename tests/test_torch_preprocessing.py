"""The port's preprocessing layer against the JAX package's, on the CPU:
`preprocessing/{jsonify,jsonify_cli,wavcaps_filters,pipeline_cli,
pack_webdataset}.py`, `dataset_utils/{__init__,midi}.py`.

Each jsonifier reads the same small dataset layout (the fixtures of
tests/test_preprocessing.py, plus one for each dataset they leave out) and
must give EQUAL records; the MIDI parser and the note formatters equal
results; `pipeline_cli` convert, crop, annotate and crop-annotations with
one worker must write the same files and JSONL as the JAX CLI; and
`pack_webdataset`'s shards must read back to equal samples.
"""

import csv
import json
import os
import struct

import numpy as np
import pytest

from llark_tpu import dataset_utils as jdu
from llark_tpu.audio import synthbench as jsb
from llark_tpu.data import webdataset as jwds
from llark_tpu.dataset_utils import midi as jmidi
from llark_tpu.native import build as jbuild
from llark_tpu.preprocessing import jsonify as jjs
from llark_tpu.preprocessing import jsonify_cli as jjs_cli
from llark_tpu.preprocessing import pack_webdataset as jpack
from llark_tpu.preprocessing import pipeline_cli as jpipe
from llark_tpu.preprocessing import wavcaps_filters as jwf
from llark_tpu_torch import dataset_utils as tdu
from llark_tpu_torch.audio import io as tio
from llark_tpu_torch.data import webdataset as twds
from llark_tpu_torch.dataset_utils import midi as tmidi
from llark_tpu_torch.preprocessing import get_jsonifier
from llark_tpu_torch.preprocessing import jsonify as tjs
from llark_tpu_torch.preprocessing import jsonify_cli as tjs_cli
from llark_tpu_torch.preprocessing import pack_webdataset as tpack
from llark_tpu_torch.preprocessing import pipeline_cli as tpipe
from llark_tpu_torch.preprocessing import wavcaps_filters as twf


@pytest.fixture(autouse=True, scope="module")
def _reference_native_library():
    """The JAX package builds its library next to its source on first use;
    a worker that loads it while another worker's g++ is still writing it
    falls back to numpy for good. Load it again once the file is whole."""
    if jbuild.load_library() is None:
        jbuild._tried = False
        assert jbuild.load_library() is not None, "the JAX package's native build failed"


# ---------------------------------------------------------------------------
# MIDI
# ---------------------------------------------------------------------------


def _varlen(x):
    out = [x & 0x7F]
    x >>= 7
    while x:
        out.append(0x80 | (x & 0x7F))
        x >>= 7
    return bytes(reversed(out))


def make_midi(notes, tempo_us=500000, division=480, program=40, channel=0):
    """notes: [(pitch, start_tick, end_tick)]"""
    events = [(0, bytes([0xFF, 0x51, 0x03]) + tempo_us.to_bytes(3, "big"))]
    events.append((0, bytes([0xC0 | channel, program])))
    for pitch, s, e in notes:
        events.append((s, bytes([0x90 | channel, pitch, 100])))
        events.append((e, bytes([0x80 | channel, pitch, 0])))
    events.sort(key=lambda x: x[0])
    track = b""
    last = 0
    for tick, payload in events:
        track += _varlen(tick - last) + payload
        last = tick
    track += _varlen(0) + bytes([0xFF, 0x2F, 0x00])
    header = b"MThd" + struct.pack(">IHHH", 6, 0, 1, division)
    return header + b"MTrk" + struct.pack(">I", len(track)) + track


MIDIS = {
    "violin": make_midi([(60, 0, 480), (64, 480, 960), (67, 240, 1500)], program=40),
    "piano_slow": make_midi([(48, 0, 960), (72, 100, 200)], tempo_us=800000, program=0),
    "drums": make_midi([(38, 0, 120), (42, 240, 360), (1, 480, 600)], program=0, channel=9),
    "pizzicato": make_midi([(55, 0, 240)], program=45),
}


@pytest.mark.parametrize("name", sorted(MIDIS))
def test_midi_parse_and_formatters_equal_the_reference(name):
    data = MIDIS[name]
    notes = tmidi.parse_midi(data)
    assert notes == jmidi.parse_midi(data) and notes
    for kw in ({}, {"one_indexed_programs": True, "pizzicato_to_violin": True}):
        assert tmidi.get_formatted_notes_list(notes, **kw) == jmidi.get_formatted_notes_list(notes, **kw)
    assert tmidi.format_slakh_notes_list(notes) == jmidi.format_slakh_notes_list(notes)


def test_midi_labels_and_tables_equal_the_reference():
    assert tmidi.GM_PROGRAMS == jmidi.GM_PROGRAMS
    for p in (0, 40, 45, 127):
        assert tmidi.program_to_family(p) == jmidi.program_to_family(p)
        for kw in ({}, {"one_indexed": True}, {"pizzicato_to_violin": True}):
            assert tmidi.program_to_instrument(p, **kw) == jmidi.program_to_instrument(p, **kw)
    for pitch in (0, 21, 60, 69, 127):
        assert tmidi.pitch_to_note_label(pitch) == jmidi.pitch_to_note_label(pitch)
    with pytest.raises(Exception):
        tmidi.parse_midi(b"not a midi file")


def test_dataset_utils_equal_the_reference(tmp_path):
    assert sorted(tdu.DATASET_INFO) == sorted(jdu.DATASET_INFO)
    for name, info in tdu.DATASET_INFO.items():
        ref = jdu.DATASET_INFO[name]
        assert (info.id_col, info.id_to_filename) == (ref.id_col, ref.id_to_filename)
        assert info.filename_for("a/b.mp3") == ref.filename_for("a/b.mp3")
    for key in ("track1-start30.000-end60.000", "x-start30_000-end60_000", "dir/plain_id", "a.b"):
        assert tdu.parse_cropped_id(key) == jdu.parse_cropped_id(key)
        assert tdu.wds_key_to_example_id(key) == jdu.wds_key_to_example_id(key)
        assert tdu.example_id_to_wds_key(key) == jdu.example_id_to_wds_key(key)
        assert tdu.wds_key_to_original_id(key) == jdu.wds_key_to_original_id(key)
    assert tdu.get_cropped_uri("a/t.wav", 30.0, 60.0) == jdu.get_cropped_uri("a/t.wav", 30.0, 60.0)
    row = {"id": "x", "audio": [1], "audio_sample_rate": 3, "k": 1}
    assert tdu.format_example_for_model(row) == jdu.format_example_for_model(row)
    (tmp_path / "a.jsonl").write_text('{"id": 1}\n\n{"id": 2}\n')
    (tmp_path / "b.jsonl").write_text('{"id": 3}\n')
    for pattern in (str(tmp_path / "a.jsonl"), str(tmp_path / "*.jsonl")):
        assert tdu.read_jsonl_data(pattern) == jdu.read_jsonl_data(pattern)


def test_wavcaps_filters_equal_the_reference():
    assert twf.MUSIC_KEYWORDS == jwf.MUSIC_KEYWORDS
    assert twf.NON_MUSIC_KEYWORDS == jwf.NON_MUSIC_KEYWORDS
    for caption in ("an orchestra performs a symphony", "a man speaking about cars",
                    "random noise", "two words", "", None):
        assert twf.keyword_filter(caption) == jwf.keyword_filter(caption)
        assert twf.length_filter(caption) == jwf.length_filter(caption)


# ---------------------------------------------------------------------------
# jsonifiers
# ---------------------------------------------------------------------------


def _write_csv(path, fieldnames, rows, **kw):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fieldnames, **kw)
        w.writeheader()
        w.writerows(rows)


def _dataset(root, name):
    """A small raw layout of each dataset, as its jsonifier reads it."""
    d = root / name
    os.makedirs(d)
    if name == "musiccaps":
        _write_csv(d / "musiccaps-public.csv",
                   ["ytid", "start_s", "end_s", "caption", "aspect_list", "is_audioset_eval"],
                   [dict(ytid="abc", start_s=10, end_s=20, caption="piano jazz",
                         aspect_list="['piano']", is_audioset_eval="False"),
                    dict(ytid="xyz", start_s=0, end_s="", caption="rock", aspect_list="[]",
                         is_audioset_eval="True")])
    elif name in ("giantsteps-key", "giantsteps-tempo"):
        os.makedirs(d / "annotations" / "key")
        os.makedirs(d / "annotations" / "tempo")
        (d / "annotations" / "key" / "123.LOFI.key").write_text("d minor\n")
        (d / "annotations" / "key" / "77.LOFI.key").write_text("Eb major")
        (d / "annotations" / "tempo" / "123.LOFI.bpm").write_text("128")
        (d / "annotations" / "tempo" / "77.LOFI.bpm").write_text("fast")
    elif name == "mtg-jamendo":
        (d / "raw.tsv").write_text(
            "TRACK_ID\tARTIST_ID\tALBUM_ID\tPATH\tDURATION\tTAGS\n"
            "track_1\ta1\tal1\t00/1.mp3\t200.0\tgenre---rock\tmood---happy\n"
            "short\n"
            "track_2\ta2\tal2\t00/2.mp3\t31.5\tinstrument---piano\n")
    elif name == "wavcaps":
        blob = {"data": [
            {"id": "1.wav", "caption": "a jazz band plays a lively tune", "duration": 30},
            {"id": "2.wav", "caption": "a dog barking near traffic", "duration": 5},
            {"id": "3.wav", "caption": "music", "duration": 5},
            {"file_name": "4.wav", "caption": "slow piano melody with strings"}]}
        (d / "as.json").write_text(json.dumps(blob))
        (d / "bbc.json").write_text(json.dumps([{"id": "5", "caption": "a rock song with drums"}]))
    elif name == "musicnet":
        os.makedirs(d / "musicnet_midis" / "Bach")
        os.makedirs(d / "train_data")
        (d / "musicnet_midis" / "Bach" / "2186_vs6_1.mid").write_bytes(MIDIS["violin"])
        (d / "musicnet_midis" / "Bach" / "2200_x.mid").write_bytes(MIDIS["pizzicato"])
        (d / "musicnet_midis" / "Bach" / "3000_test.mid").write_bytes(MIDIS["piano_slow"])
        (d / "musicnet_midis" / "Bach" / "2300_bad.mid").write_bytes(b"junk")
        for i in ("2186", "2200", "2300"):
            (d / "train_data" / f"{i}.wav").write_bytes(b"")
        _write_csv(d / "musicnet_metadata.csv", ["id", "composer", "ensemble"],
                   [{"id": "2186", "composer": "Bach", "ensemble": "Solo Violin"}])
    elif name == "fma":
        _write_csv(d / "genres.csv", ["genre_id", "title"], [{"genre_id": "21", "title": "Hip-Hop"}])
        with open(d / "tracks.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["", "set", "set", "track", "track", "artist", "album", "track"])
            w.writerow(["track_id", "split", "subset", "title", "genres", "name", "title",
                        "language_code"])
            w.writerow(["", "", "", "", "", "", "", ""])
            w.writerow(["2", "training", "small", "Food <b>!</b>", "[21, 99]", "AWOL",
                        "AWOL &amp; Co", "en"])
            w.writerow(["5", "test", "small", "Other", "[]", "X", "Y", ""])
    elif name == "magnatagatune":
        _write_csv(d / "clip_info_final.csv",
                   ["clip_id", "mp3_path", "title", "artist", "album"],
                   [{"clip_id": "2", "mp3_path": "f/a-b-0-29.mp3", "title": "t", "artist": "a",
                     "album": "b"},
                    {"clip_id": "6", "mp3_path": "0/x-y-30-59.mp3", "title": "u", "artist": "v",
                     "album": "w"},
                    {"clip_id": "9", "mp3_path": "", "title": "", "artist": "", "album": ""}],
                   delimiter="\t")
    elif name == "yt8m-musictextclips":
        _write_csv(d / "clips.csv", ["video_id", "start", "end", "text"],
                   [{"video_id": "v1", "start": "1.5", "end": "11.5", "text": "an upbeat song"},
                    {"video_id": "v2", "start": "", "end": "10", "text": "calm guitar"}])
    elif name == "slakh":
        for track, midi in (("Track00001", MIDIS["violin"]), ("Track00002", MIDIS["drums"]),
                            ("Track00003", b"junk")):
            os.makedirs(d / "train" / track)
            (d / "train" / track / "all_src.mid").write_bytes(midi)
        os.makedirs(d / "train" / "Track00004")
    elif name == "fsl10k":
        os.makedirs(d / "ac_analysis")
        (d / "ac_analysis" / "1234_analysis.json").write_text(
            json.dumps({"tempo": 120, "key": "C major", "loop": True, "list": [1], "d": {}}))
        (d / "ac_analysis" / "555_analysis.json").write_text(json.dumps({"tempo": 90}))
        (d / "metadata.json").write_text(json.dumps(
            {"1234": {"name": "loop", "tags": ["drum"], "description": "a <b>beat</b> &amp; more"}}))
    return str(d)


DATASETS = sorted(jjs._JSONIFIERS)


@pytest.mark.parametrize("name", DATASETS)
def test_jsonifier_gives_the_reference_records(tmp_path, name):
    assert sorted(tjs._JSONIFIERS) == DATASETS
    src = _dataset(tmp_path, name)
    records = 0
    for split in ("train", "test"):
        got = get_jsonifier(name, src, split)
        want = jjs.get_jsonifier(name, src, split)
        got.load_raw_data()
        want.load_raw_data()
        assert got.data == want.data
        out = got.export_to_json(str(tmp_path / "out" / f"{name}-{split}.jsonl"))
        ref = want.export_to_json(str(tmp_path / "ref" / f"{name}-{split}.jsonl"))
        assert open(out).read() == open(ref).read()
        records += len(got.data)
    assert records, f"{name}: the fixture gave no record"


def test_jsonify_cli_and_the_registry_equal_the_reference(tmp_path, capsys):
    src = _dataset(tmp_path, "giantsteps-key")
    tjs_cli.main(["--dataset", "giantsteps-key", "--input-dir", src,
                  "--output", str(tmp_path / "t.jsonl")])
    jjs_cli.main(["--dataset", "giantsteps-key", "--input-dir", src,
                  "--output", str(tmp_path / "j.jsonl")])
    assert (tmp_path / "t.jsonl").read_text() == (tmp_path / "j.jsonl").read_text()
    assert "2 rows" in capsys.readouterr().out
    with pytest.raises(KeyError):
        get_jsonifier("no-such-dataset", src)
    assert tjs.extract_text_from_html("a <i>b</i> &amp; c") == jjs.extract_text_from_html(
        "a <i>b</i> &amp; c")


# ---------------------------------------------------------------------------
# pipeline_cli and pack_webdataset
# ---------------------------------------------------------------------------


def _tree(directory):
    """{relative name: bytes} of every file under `directory`."""
    out = {}
    for root, _, files in os.walk(directory):
        for f in files:
            path = os.path.join(root, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, directory)] = fh.read()
    return out


def _pipeline(pipe, root, ann_in=None):
    """convert, crop, annotate and crop-annotations of one package's CLI over
    the WAVs in root/wavs, one worker each."""
    wavs = str(root / "wavs")
    pipe.main(["convert", "--input-dir", wavs, "--output-dir", str(root / "conv"),
               "--sample-rate", "22050", "--workers", "1"])
    pipe.main(["crop", "--input-dir", wavs, "--output-dir", str(root / "crops"),
               "--workers", "1"])
    if ann_in is None:
        pipe.main(["annotate", "--input-jsonl", str(root / "rows.jsonl"), "--audio-dir", wavs,
                   "--output", str(root / "ann.jsonl"), "--workers", "1"])
        ann_in = str(root / "ann.jsonl")
    pipe.main(["crop-annotations", "--annotations-file", ann_in,
               "--audio-dir", str(root / "crops"), "--output", str(root / "cropped.jsonl"),
               "--max-crop-duration", "4"])


def _pipeline_inputs(root):
    os.makedirs(root / "wavs")
    rows = []
    for i, family in enumerate(("additive", "pluck")):
        audio, _ = jsb.make_clip(20 + i, 6.0, sr=22050, family=family)
        tio.write_wav(str(root / "wavs" / f"clip{i}.wav"), audio, 22050)
        rows.append({"id": f"clip{i}", "family": family})
    rows.append({"id": "missing"})
    (root / "rows.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))


@pytest.fixture(scope="module")
def jax_pipeline(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_pipeline")
    _pipeline_inputs(root)
    _pipeline(jpipe, root)
    return root


def test_pipeline_cli_writes_the_reference_files(jax_pipeline, tmp_path):
    _pipeline_inputs(tmp_path)
    # annotate is timed on its own below: crop-annotations reads the JAX
    # CLI's annotations here, so each stage is held on the same input
    _pipeline(tpipe, tmp_path, ann_in=str(jax_pipeline / "ann.jsonl"))
    for stage in ("conv", "crops"):
        got, want = _tree(tmp_path / stage), _tree(jax_pipeline / stage)
        assert sorted(got) == sorted(want) and got == want, stage
    assert sorted(_tree(tmp_path / "crops")) == ["clip0-start0.000-end6.000.wav",
                                                 "clip1-start0.000-end6.000.wav"]
    got = (tmp_path / "cropped.jsonl").read_text()
    assert got == (jax_pipeline / "cropped.jsonl").read_text()
    rows = [json.loads(line) for line in got.splitlines()]
    assert [r["id"] for r in rows] == ["clip0-start0.000-end6.000", "clip1-start0.000-end6.000"]
    assert all(r["end_secs"] == 4.0 for r in rows)


def test_pipeline_annotate_writes_the_reference_jsonl(jax_pipeline, tmp_path):
    out = tmp_path / "ann.jsonl"
    tpipe.main(["annotate", "--input-jsonl", str(jax_pipeline / "rows.jsonl"),
                "--audio-dir", str(jax_pipeline / "wavs"), "--output", str(out),
                "--workers", "1"])
    got = out.read_text()
    assert got == (jax_pipeline / "ann.jsonl").read_text()
    rows = [json.loads(line) for line in got.splitlines()]
    assert [r["id"] for r in rows] == ["clip0", "clip1"]  # "missing" skipped
    assert {"key", "chords", "downbeats_madmom", "tempo_in_beats_per_minute_librosa"} <= set(rows[0])


def test_crop_helpers_equal_the_reference():
    files = ["/a/track-1-start30.000-end60.000.wav", "/a/bad.wav", "b/x-start0.000-end6.500.wav"]
    assert tpipe.parse_cropped_filenames(files) == jpipe.parse_cropped_filenames(files)
    row = {"id": "x",
           "downbeats_madmom": [{"time": t, "beat_number": 1} for t in (31.0, 50.0, 58.0)],
           "downbeats_librosa": [{"time": 29.0}, {"time": 40.0}],
           "chords": [{"start_time": 25.0, "end_time": 40.0, "chord": "F major"}],
           "notes": json.dumps({"Violin": [{"start": 30.0, "end": 59.0, "pitch": "C4"}]})}
    for max_crop in (None, 25.0):
        assert tpipe.crop_annotation_row(row, 30.0, 60.0, max_crop) == jpipe.crop_annotation_row(
            row, 30.0, 60.0, max_crop)
    assert tpipe.MAX_ANNOTATE_SECONDS == jpipe.MAX_ANNOTATE_SECONDS


@pytest.mark.parametrize("use_native", [True, False])
def test_pack_webdataset_round_trips(tmp_path, use_native):
    enc_dir = tmp_path / "encs"
    os.makedirs(enc_dir)
    rng = np.random.RandomState(9)
    rows = []
    for i in range(5):
        key = f"track{i}-start{30 * i}.000-end{30 * i + 30}.000"
        np.save(enc_dir / f"{key}.npy", rng.randn(4, 8).astype(np.float32))
        rows.append({"id": key, "response": [{"question": f"q{i}?", "answer": "a."}]})
    rows.append({"id": "no-encoding", "response": [{"question": "q", "answer": "a"}]})
    rows.append({"id": "track0-start0.000-end30.000", "response": []})
    qa = tmp_path / "qa.jsonl"
    qa.write_text("".join(json.dumps(r) + "\n" for r in rows) + "\n")
    for pack, name in ((tpack, "t"), (jpack, "j")):
        pack.main(["--instruct-jsonl", str(qa), "--encodings-dir", str(enc_dir),
                   "--output-pattern", str(tmp_path / name / "s-%05d.tar"), "--max-count", "2"])
    got_paths = sorted(str(tmp_path / "t" / f) for f in os.listdir(tmp_path / "t"))
    want_paths = sorted(str(tmp_path / "j" / f) for f in os.listdir(tmp_path / "j"))
    assert len(got_paths) == len(want_paths) == 3
    for g, w in zip(got_paths, want_paths):
        assert open(g, "rb").read() == open(w, "rb").read()
    got = list(twds.TarShardReader(got_paths, use_native=use_native))
    want = list(jwds.TarShardReader(want_paths, use_native=False))
    assert [s["__key__"] for s in got] == [s["__key__"] for s in want] == [
        tdu.example_id_to_wds_key(r["id"]) for r in rows[:5]]
    for a, b in zip(got, want):
        assert a["json"] == b["json"]
        np.testing.assert_array_equal(a["audio_encoding.pyd"], b["audio_encoding.pyd"])
