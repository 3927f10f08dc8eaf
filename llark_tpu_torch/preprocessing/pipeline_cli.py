"""Audio preprocessing CLIs: convert, crop, annotate, crop-annotations
(counterpart of llark_tpu/preprocessing/pipeline_cli.py). Every stage
runs on the host, in a `multiprocessing.Pool`; `annotate` runs the DSP
annotators and never touches a device, so forked workers stay safe.

Reference parity (semantics and file-naming contracts):
  convert ............ scripts/preprocessing/convert_audio_to_wav.py
  crop ............... scripts/preprocessing/crop_audio.py:102-194
  annotate ........... scripts/preprocessing/annotate_dataset.py:202-226
  crop-annotations ... scripts/preprocessing/crop_annotations.py

Usage:
  python -m llark_tpu_torch.preprocessing.pipeline_cli convert --input-dir A --output-dir B
  python -m llark_tpu_torch.preprocessing.pipeline_cli crop --input-dir A --output-dir B [--multicrop]
  python -m llark_tpu_torch.preprocessing.pipeline_cli annotate --input-jsonl x.jsonl \
      --audio-dir A --output y.jsonl [--id-col id] [--id-to-filename '{id}.wav']
  python -m llark_tpu_torch.preprocessing.pipeline_cli crop-annotations \
      --annotations-file y.jsonl --audio-dir B/ --output z.jsonl [--max-crop-duration 25]
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
from multiprocessing import Pool
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from llark_tpu_torch import storage

from llark_tpu_torch.audio.annotate import annotate_elem
from llark_tpu_torch.audio.io import (
    DEFAULT_SR,
    convert_to_wav,
    crop_multi,
    crop_single,
    make_start_end_str,
    read_wav,
    write_wav,
)

log = logging.getLogger(__name__)

MAX_ANNOTATE_SECONDS = 360.0  # reference annotate_dataset.py:105-110


def _convert_one(args: Tuple[str, str, int]) -> Optional[str]:
    src, out_dir, sr = args
    base = os.path.splitext(os.path.basename(src))[0]
    dst = os.path.join(out_dir, base + ".wav")
    try:
        return convert_to_wav(src, dst, sr)
    except Exception as e:  # noqa: BLE001 — per-file skip-and-warn
        log.warning("convert failed for %s: %s", src, e)
        return None


def cmd_convert(ns):
    if not storage.is_remote(ns.output_dir):
        os.makedirs(ns.output_dir, exist_ok=True)
    if storage.is_remote(ns.input_dir):
        files = storage.fs_glob(storage.join(ns.input_dir, "*"))
    else:
        files = sorted(
            f
            for f in glob.glob(os.path.join(ns.input_dir, "*"))
            if os.path.isfile(f)
        )
    with Pool(ns.workers) as pool:
        results = pool.map(
            _convert_one, [(f, ns.output_dir, ns.sample_rate) for f in files]
        )
    ok = sum(1 for r in results if r)
    print(f"converted {ok}/{len(files)} files -> {ns.output_dir}")


def _crop_one(args) -> List[str]:
    src, out_dir, multicrop, seed = args
    base = os.path.splitext(os.path.basename(src))[0]
    try:
        samples, sr = read_wav(src)
    except Exception as e:  # noqa: BLE001
        log.warning("crop failed for %s: %s", src, e)
        return []
    outs = []
    if multicrop:
        crops = crop_multi(samples, sr)
    else:
        rng = np.random.RandomState(seed)
        crops = [crop_single(samples, sr, rng)]
    for audio, start, end in crops:
        name = base + make_start_end_str(start, end) + ".wav"
        path = os.path.join(out_dir, name)
        write_wav(path, audio, sr)
        outs.append(path)
    return outs


def cmd_crop(ns):
    if not storage.is_remote(ns.output_dir):
        os.makedirs(ns.output_dir, exist_ok=True)
    files = storage.fs_glob(storage.join(ns.input_dir, "*.wav"))
    with Pool(ns.workers) as pool:
        results = pool.map(
            _crop_one,
            [(f, ns.output_dir, ns.multicrop, i) for i, f in enumerate(files)],
        )
    n = sum(len(r) for r in results)
    print(f"wrote {n} crops from {len(files)} files -> {ns.output_dir}")


def _annotate_one(args) -> Optional[Dict[str, Any]]:
    row, audio_dir, id_col, id_to_filename = args
    fname = id_to_filename.format(id=row[id_col])
    path = storage.join(audio_dir, fname)
    if not storage.exists(path):
        log.warning("missing audio for %s; skipping", row.get(id_col))
        return None
    try:
        samples, sr = read_wav(path, duration=MAX_ANNOTATE_SECONDS)
        elem = dict(row)
        elem["audio"] = samples
        elem["audio_sample_rate"] = sr
        elem = annotate_elem(elem)
        elem.pop("audio")
        elem.pop("audio_sample_rate")
        return elem
    except Exception as e:  # noqa: BLE001
        log.warning("annotation failed for %s: %s", path, e)
        return None


def cmd_annotate(ns):
    with storage.fopen(ns.input_jsonl, "rb") as f:
        rows = [json.loads(line) for line in f if line.strip()]
    tasks = [(r, ns.audio_dir, ns.id_col, ns.id_to_filename) for r in rows]
    with Pool(ns.workers) as pool:
        results = pool.map(_annotate_one, tasks)
    results = [r for r in results if r is not None]
    storage.makedirs_for(ns.output)
    with storage.fopen(ns.output, "wb") as fb:
        for r in results:
            fb.write((json.dumps(r) + "\n").encode())
    print(f"annotated {len(results)}/{len(rows)} rows -> {ns.output}")


# ---------------------------------------------------------------------------
# crop-annotations (reference crop_annotations.py:38-162)
# ---------------------------------------------------------------------------


def parse_cropped_filenames(filenames) -> List[Tuple[str, float, float]]:
    parsed = []
    for f in filenames:
        base = os.path.basename(f).rsplit(".", 1)[0]
        try:
            id_, start_str, end_str = base.rsplit("-", 2)
            parsed.append(
                (id_, float(start_str.replace("start", "")), float(end_str.replace("end", "")))
            )
        except ValueError:
            log.warning("error parsing filename %s; skipping", f)
    return parsed


def crop_time_events(
    events: List[Dict[str, Any]], start: float, end: float
) -> List[Dict[str, Any]]:
    """Fixed-time events ({'time': t, ...}): filter to window, renormalize."""
    out = []
    for x in events:
        if start <= x["time"] <= end:
            y = dict(x)
            y["time"] = x["time"] - start
            out.append(y)
    return out


def crop_span_events(
    events: List[Dict[str, Any]],
    start: float,
    end: float,
    start_key: str = "start_time",
    end_key: str = "end_time",
) -> List[Dict[str, Any]]:
    """Span events ({'start_time','end_time',...}): clip to window."""
    out = []
    for x in events:
        if x[end_key] >= start and x[start_key] <= end:
            y = dict(x)
            y[start_key] = max(x[start_key] - start, 0.0)
            y[end_key] = min(x[end_key] - start, end - start)
            out.append(y)
    return out


def crop_midi_notes(
    notes_by_inst: Dict[str, List[Dict[str, Any]]], start: float, end: float
) -> Dict[str, List[Dict[str, Any]]]:
    return {
        inst: crop_span_events(notes, start, end, "start", "end")
        for inst, notes in notes_by_inst.items()
    }


def crop_annotation_row(
    row: Dict[str, Any], start: float, end: float, max_crop_duration: Optional[float]
) -> Dict[str, Any]:
    if max_crop_duration:
        end = min(end, start + max_crop_duration)
    out = dict(row)
    out["start_secs"], out["end_secs"] = start, end
    if "downbeats_madmom" in out and isinstance(out["downbeats_madmom"], list):
        out["downbeats_madmom"] = crop_time_events(out["downbeats_madmom"], start, end)
    if "downbeats_librosa" in out and isinstance(out["downbeats_librosa"], list):
        out["downbeats_librosa"] = crop_time_events(out["downbeats_librosa"], start, end)
    if "chords" in out and isinstance(out["chords"], list):
        out["chords"] = crop_span_events(out["chords"], start, end)
    if "notes" in out and out["notes"]:
        notes = out["notes"]
        if isinstance(notes, str):
            notes = json.loads(notes)
        out["notes"] = crop_midi_notes(notes, start, end)
    return out


def cmd_crop_annotations(ns):
    with storage.fopen(ns.annotations_file, "rb") as f:
        rows = [json.loads(line) for line in f if line.strip()]
    by_id = {str(r[ns.id_col]): r for r in rows}
    crop_files = storage.fs_glob(storage.join(ns.audio_dir, "*.wav"))
    out_rows = []
    for id_, start, end in parse_cropped_filenames(crop_files):
        row = by_id.get(str(id_))
        if row is None:
            continue
        cropped = crop_annotation_row(row, start, end, ns.max_crop_duration)
        # re-key to the per-crop id (matching the crop WAV / encoding
        # filenames) so downstream joins — instruct rows, pack_webdataset's
        # encoding lookup — resolve, and multicrop rows stay distinct
        cropped["source_id"] = str(id_)
        cropped[ns.id_col] = f"{id_}{make_start_end_str(start, end)}"
        out_rows.append(cropped)
    storage.makedirs_for(ns.output)
    with storage.fopen(ns.output, "wb") as fb:
        for r in out_rows:
            fb.write((json.dumps(r) + "\n").encode())
    print(f"wrote {len(out_rows)} cropped annotation rows -> {ns.output}")


def main(argv=None):
    p = argparse.ArgumentParser("llark_tpu_torch.preprocessing")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("convert")
    c.add_argument("--input-dir", required=True)
    c.add_argument("--output-dir", required=True)
    c.add_argument("--sample-rate", type=int, default=DEFAULT_SR)
    c.add_argument("--workers", type=int, default=os.cpu_count())
    c.set_defaults(fn=cmd_convert)

    c = sub.add_parser("crop")
    c.add_argument("--input-dir", required=True)
    c.add_argument("--output-dir", required=True)
    c.add_argument("--multicrop", action="store_true")
    c.add_argument("--workers", type=int, default=os.cpu_count())
    c.set_defaults(fn=cmd_crop)

    c = sub.add_parser("annotate")
    c.add_argument("--input-jsonl", required=True)
    c.add_argument("--audio-dir", required=True)
    c.add_argument("--output", required=True)
    c.add_argument("--id-col", default="id")
    c.add_argument("--id-to-filename", default="{id}.wav")
    c.add_argument("--workers", type=int, default=os.cpu_count())
    c.set_defaults(fn=cmd_annotate)

    c = sub.add_parser("crop-annotations")
    c.add_argument("--annotations-file", required=True)
    c.add_argument("--audio-dir", required=True)
    c.add_argument("--output", required=True)
    c.add_argument("--id-col", default="id")
    c.add_argument("--max-crop-duration", type=float, default=25.0)
    c.set_defaults(fn=cmd_crop_annotations)

    ns = p.parse_args(argv)
    ns.fn(ns)


if __name__ == "__main__":
    main()
