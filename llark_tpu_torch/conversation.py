"""Conversation templates and `###`-separated chat formatting (counterpart
of llark_tpu/conversation.py).

Behavior parity with the reference's templates (reference:
m2t/llava/conversation.py:22-78 SeparatorStyle SINGLE/TWO/MPT and the
named templates; m2t/data_modules.py:92-109
`sentences_to_formatted_conversation`). `conv_v1_2` (SINGLE, "###") is
the default used by training and inference; the TWO (vicuna) and MPT
(ChatML-style) templates are provided for checkpoint interop.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Tuple

from llark_tpu_torch.special_tokens import DEFAULT_AUDIO_TOKEN

BEGIN_SIGNAL = "### "
END_SIGNAL = "\n"

DEFAULT_SYSTEM = (
    "A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's questions."
)

DEFAULT_ROLES = ("Human", "Assistant")


class SeparatorStyle(enum.Enum):
    SINGLE = enum.auto()  # system + sep, then "role: msg" + sep per turn
    TWO = enum.auto()  # alternating sep / sep2 (vicuna v1)
    MPT = enum.auto()  # ChatML-style: role token + msg + sep, no ": "


@dataclasses.dataclass(frozen=True)
class Conversation:
    """A conversation template: system header + role-tagged turns."""

    system: str = DEFAULT_SYSTEM
    roles: Tuple[str, str] = DEFAULT_ROLES
    sep: str = "###"
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep2: Optional[str] = None

    @property
    def header(self) -> str:
        """Header prepended to every formatted conversation (system + blank line)."""
        return f"{self.system}\n\n"

    def role_for(self, speaker: str) -> str:
        """Map dataset speaker tags ('human'/'gpt') to display roles."""
        s = speaker.lower()
        if s == "human":
            return self.roles[0]
        if s == "gpt":
            return self.roles[1]
        return "unknown"

    def get_prompt(self, messages: Sequence[Tuple[str, Optional[str]]]) -> str:
        """Render (role, message) pairs; message=None leaves a generation
        slot after the role tag (reference conversation.py:45-78)."""
        if self.sep_style == SeparatorStyle.SINGLE:
            out = self.system + self.sep
            for role, message in messages:
                out += f"{role}: {message}{self.sep}" if message else f"{role}:"
            return out
        if self.sep_style == SeparatorStyle.TWO:
            seps = (self.sep, self.sep2 or self.sep)
            out = self.system + seps[0]
            for i, (role, message) in enumerate(messages):
                out += f"{role}: {message}{seps[i % 2]}" if message else f"{role}:"
            return out
        if self.sep_style == SeparatorStyle.MPT:
            out = self.system + self.sep
            for role, message in messages:
                out += f"{role}{message}{self.sep}" if message else role
            return out
        raise ValueError(f"invalid separator style: {self.sep_style}")


# the training/inference default (reference conv_v1_2, conversation.py:237-271)
default_conversation = Conversation()

conv_vicuna_v1 = Conversation(
    system=(
        "A chat between a curious user and an artificial intelligence "
        "assistant. The assistant gives helpful, detailed, and polite "
        "answers to the user's questions."
    ),
    roles=("USER", "ASSISTANT"),
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_mpt = Conversation(
    system=(
        "<|im_start|>system\n"
        "- You are a helpful assistant for music understanding.\n"
        "- You can describe, analyze, and answer questions about the audio "
        "the user provides."
    ),
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
)

CONVERSATION_TEMPLATES: Dict[str, Conversation] = {
    "v1_2": default_conversation,
    "vicuna_v1": conv_vicuna_v1,
    "mpt": conv_mpt,
}

# Header constant used by data preprocessing and prompt construction
# (reference: m2t/data_modules.py:46).
DEFAULT_CONVERSATION_HEADER = default_conversation.header

# The token sequence at which generation prompts are cut
# (reference: m2t/tokenizer.py:41-58).
PROMPT_END_TEXT = "\n### Assistant:"


def format_turn(speaker: str, value: str, conv: Conversation = default_conversation) -> str:
    """Render one turn as '### Role: value\\n'."""
    return BEGIN_SIGNAL + conv.role_for(speaker) + ": " + value + END_SIGNAL


def format_conversation(
    turns: Sequence[Dict[str, str]],
    header: str = DEFAULT_CONVERSATION_HEADER,
    conv: Conversation = default_conversation,
) -> Tuple[str, List[str]]:
    """Format a list of `{"from": ..., "value": ...}` turns into one string.

    Returns (full_conversation, per-turn formatted strings). The final
    conversation ends with a dangling '### ' so generation continues from the
    assistant role boundary (reference: m2t/data_modules.py:92-109).
    """
    rendered = [format_turn(t["from"], t["value"], conv) for t in turns]
    conversation = header + "".join(rendered) + BEGIN_SIGNAL
    return conversation, rendered


def concat_audio_token_and_prompt(prompt: str, audio_first: bool) -> str:
    """Place the `<audio>` placeholder before or after the prompt text
    (reference: m2t/data_modules.py:287-292)."""
    if audio_first:
        return "\n".join((DEFAULT_AUDIO_TOKEN, prompt))
    return "\n".join((prompt, DEFAULT_AUDIO_TOKEN))
