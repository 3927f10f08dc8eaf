"""Model layer: functional decoder + multimodal fusion on torch tensors."""

import dataclasses

from llark_tpu_torch.special_tokens import (
    DEFAULT_AUDIO_END_TOKEN,
    DEFAULT_AUDIO_PATCH_TOKEN,
    DEFAULT_AUDIO_START_TOKEN,
)


@dataclasses.dataclass
class AudioEncoderConfig:
    """Audio special-token configuration (reference: m2t/models/__init__.py:23-29;
    the reference's `audio_patch_token = str = ...` typo is fixed here)."""

    use_audio_start_end: bool = True
    audio_start_token: str = DEFAULT_AUDIO_START_TOKEN
    audio_end_token: str = DEFAULT_AUDIO_END_TOKEN
    audio_patch_token: str = DEFAULT_AUDIO_PATCH_TOKEN
