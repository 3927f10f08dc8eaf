"""API credentials (parity: m2t/keys.py:15-17; counterpart of llark_tpu/keys.py).

The reference shipped placeholder module-level constants; here credentials
resolve from the environment so they never land in source control. Import
sites call the getters lazily, at point of use.
"""

from __future__ import annotations

import os
from typing import Optional


def openai_api_key() -> Optional[str]:
    return os.environ.get("OPENAI_API_KEY")


def openai_organization() -> Optional[str]:
    return os.environ.get("OPENAI_ORGANIZATION")


def hugging_face_hub_token() -> Optional[str]:
    return os.environ.get("HUGGING_FACE_HUB_TOKEN") or os.environ.get("HF_TOKEN")
