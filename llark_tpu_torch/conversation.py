"""`###`-separated chat formatting of the default `conv_v1_2` template
(reference: m2t/llava/conversation.py:237-271, m2t/data_modules.py:92-109).

Only what the serving path needs: the prompt is rendered as header +
'### Role: value\\n' turns + a dangling '### '.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from llark_tpu_torch.special_tokens import DEFAULT_AUDIO_TOKEN

BEGIN_SIGNAL = "### "
END_SIGNAL = "\n"

DEFAULT_SYSTEM = (
    "A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's questions."
)
DEFAULT_ROLES = ("Human", "Assistant")

# header prepended to every formatted conversation (system + blank line)
DEFAULT_CONVERSATION_HEADER = f"{DEFAULT_SYSTEM}\n\n"

# the token sequence at which generation prompts are cut
# (reference: m2t/tokenizer.py:41-58)
PROMPT_END_TEXT = "\n### Assistant:"


def role_for(speaker: str) -> str:
    """Map dataset speaker tags ('human'/'gpt') to display roles."""
    s = speaker.lower()
    if s == "human":
        return DEFAULT_ROLES[0]
    if s == "gpt":
        return DEFAULT_ROLES[1]
    return "unknown"


def format_turn(speaker: str, value: str) -> str:
    """Render one turn as '### Role: value\\n'."""
    return BEGIN_SIGNAL + role_for(speaker) + ": " + value + END_SIGNAL


def format_conversation(
    turns: Sequence[Dict[str, str]],
    header: str = DEFAULT_CONVERSATION_HEADER,
) -> Tuple[str, List[str]]:
    """Format `{"from": ..., "value": ...}` turns into one string.

    Returns (full_conversation, per-turn formatted strings); the
    conversation ends with a dangling '### '."""
    rendered = [format_turn(t["from"], t["value"]) for t in turns]
    conversation = header + "".join(rendered) + BEGIN_SIGNAL
    return conversation, rendered


def concat_audio_token_and_prompt(prompt: str, audio_first: bool) -> str:
    """Place the `<audio>` placeholder before or after the prompt text
    (reference: m2t/data_modules.py:287-292)."""
    if audio_first:
        return "\n".join((DEFAULT_AUDIO_TOKEN, prompt))
    return "\n".join((prompt, DEFAULT_AUDIO_TOKEN))
