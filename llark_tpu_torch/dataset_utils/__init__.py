"""Dataset metadata registry + crop-id and packing helpers (counterpart of
llark_tpu/dataset_utils/__init__.py).

Parity target: m2t/dataset_utils/__init__.py — `DatasetInfo` (id_col,
id_to_filename, caption_prompts), the DATASET_INFO map, crop-id helpers,
and the WDS packing helpers the reference shipped without a packing
script (SURVEY.md §3.4; our packer lives in pack_webdataset.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Callable, Dict, List, Optional, Sequence

from llark_tpu_torch.audio.io import make_start_end_str  # noqa: F401 (re-export)


def read_jsonl_data(path: str) -> List[Dict[str, Any]]:
    import glob as _glob

    files = sorted(_glob.glob(path)) if any(c in path for c in "*?[") else [path]
    rows: List[Dict[str, Any]] = []
    for f in files:
        with open(f) as fh:
            rows.extend(json.loads(line) for line in fh if line.strip())
    return rows


@dataclasses.dataclass
class DatasetInfo:
    """Per-dataset metadata used by cropping/packing/inference."""

    name: str
    id_col: str = "id"
    # format string mapping an example id to its audio filename
    id_to_filename: str = "{id}.wav"
    caption_prompts: Optional[Sequence[str]] = None
    # normalize the id column (e.g. strip extensions, zero-pad)
    preprocess_id: Callable[[Any], str] = staticmethod(lambda x: str(x))

    def filename_for(self, example_id: Any) -> str:
        return self.id_to_filename.format(id=self.preprocess_id(example_id))

    def preprocess_id_col(self, rows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        for r in rows:
            if self.id_col in r:
                r[self.id_col] = self.preprocess_id(r[self.id_col])
        return rows


def _strip_ext(x: Any) -> str:
    return os.path.splitext(str(x))[0]


DATASET_INFO: Dict[str, DatasetInfo] = {
    "musiccaps": DatasetInfo("musiccaps", id_col="ytid"),
    "mtg-jamendo": DatasetInfo(
        "mtg-jamendo", id_col="TRACK_ID", preprocess_id=_strip_ext
    ),
    "fma": DatasetInfo("fma", id_col="track_id", id_to_filename="{id}.wav"),
    "fsl10k": DatasetInfo("fsl10k", id_col="id", preprocess_id=_strip_ext),
    "wavcaps": DatasetInfo("wavcaps", id_col="id", preprocess_id=_strip_ext),
    "giantsteps-key": DatasetInfo("giantsteps-key", id_col="id", preprocess_id=_strip_ext),
    "giantsteps-tempo": DatasetInfo(
        "giantsteps-tempo", id_col="id", preprocess_id=_strip_ext
    ),
    "magnatagatune": DatasetInfo("magnatagatune", id_col="clip_id"),
    "yt8m-musictextclips": DatasetInfo("yt8m-musictextclips", id_col="video_id"),
    "musicnet": DatasetInfo("musicnet", id_col="id"),
    "slakh": DatasetInfo("slakh", id_col="id"),
}


# ---------------------------------------------------------------------------
# crop-id helpers (reference m2t/dataset_utils/__init__.py:58-96)
# ---------------------------------------------------------------------------

_CROP_RE = re.compile(r"^(?P<id>.*)-start(?P<start>[\d.]+)-end(?P<end>[\d.]+)$")


def get_cropped_uri(uri: str, start: float, end: float) -> str:
    base, ext = os.path.splitext(uri)
    return base + make_start_end_str(start, end) + ext


def parse_cropped_id(key: str) -> Dict[str, Any]:
    """'{id}-start{...}-end{...}' -> {id, start, end} (or just {id})."""
    m = _CROP_RE.match(key)
    if not m:
        return {"id": key}
    return {
        "id": m.group("id"),
        "start": float(m.group("start")),
        "end": float(m.group("end")),
    }


def wds_key_to_example_id(key: str) -> str:
    """WDS sample key -> original (uncropped) example id. Accepts both raw
    crop ids ('x-start30.000-end60.000') and packer-encoded tar keys
    ('x-start30_000-end60_000')."""
    return parse_cropped_id(os.path.basename(wds_key_to_original_id(key)))["id"]


def example_id_to_wds_key(example_id: str) -> str:
    """Example id -> webdataset-friendly tar key. Tar readers treat
    everything after the FIRST dot as the field extension, so dots inside
    ids (crop windows like '-start30.000-end60.000') must be encoded;
    mirrors the reference's underscore encoding whose inverse lives at
    m2t/dataset_utils/__init__.py:58-73."""
    return str(example_id).replace(".", "_")


_START_US = re.compile(r"start(\d+)_(\d+)")
_END_US = re.compile(r"end(\d+)_(\d+)")


def wds_key_to_original_id(key: str) -> str:
    """Inverse of example_id_to_wds_key for crop-window keys: restores
    'start30_000' -> 'start30.000' and 'end60_000' -> 'end60.000'
    (reference: m2t/dataset_utils/__init__.py:58-73; we deliberately skip
    its blanket '_'->'.' pass, which corrupts ids with real underscores)."""
    key = _START_US.sub(r"start\1.\2", key)
    return _END_US.sub(r"end\1.\2", key)


def format_example_for_model(
    row: Dict[str, Any],
    drop_cols: Sequence[str] = ("audio", "audio_sample_rate"),
) -> Dict[str, Any]:
    """Strip heavy columns before packing (reference :234-272)."""
    return {k: v for k, v in row.items() if k not in drop_cols}
