"""Dataset helpers (counterpart of llark_tpu/dataset_utils/__init__.py, of
which the port so far needs only the WebDataset key decoding that the
evaluation CLI uses; the rest of that module imports the audio stack)."""

from __future__ import annotations

import re

_START_US = re.compile(r"start(\d+)_(\d+)")
_END_US = re.compile(r"end(\d+)_(\d+)")


def wds_key_to_original_id(key: str) -> str:
    """Inverse of the packer's dot -> underscore key encoding for crop-window
    keys: restores 'start30_000' -> 'start30.000' and 'end60_000' ->
    'end60.000' (reference: m2t/dataset_utils/__init__.py:58-73; its blanket
    '_'->'.' pass is skipped on purpose, since it corrupts ids with real
    underscores)."""
    key = _START_US.sub(r"start\1.\2", key)
    return _END_US.sub(r"end\1.\2", key)
