"""Special-token strings, the same values as the JAX package's
(reference contract: m2t/special_tokens.py:17-25)."""

IGNORE_INDEX = -100

DEFAULT_PAD_TOKEN = "[PAD]"
DEFAULT_EOS_TOKEN = "</s>"
DEFAULT_BOS_TOKEN = "<s>"
DEFAULT_UNK_TOKEN = "<unk>"

# Placeholder written into prompts; expanded at preprocessing time.
DEFAULT_AUDIO_TOKEN = "<audio>"
# One per audio frame after expansion.
DEFAULT_AUDIO_PATCH_TOKEN = "<audio_patch>"
DEFAULT_AUDIO_START_TOKEN = "<audio_start>"
DEFAULT_AUDIO_END_TOKEN = "<audio_end>"
