"""Instruction-tuning data generation (reference: m2t/instruct/; counterpart
of llark_tpu/instruct/). Host-only: nothing here imports torch."""

import dataclasses
from typing import Any


@dataclasses.dataclass
class FewShotExample:
    """One (user, assistant) exchange used as an in-context example
    (reference: m2t/instruct/fewshot_examples/__init__.py:18-21)."""

    user: Any
    assistant: Any
