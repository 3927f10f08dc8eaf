"""Evaluation utilities; the harness (llark_tpu/evaluation/harness.py) is to come."""

from llark_tpu_torch.evaluation.utils import (  # noqa: F401
    VALID_KEYS,
    acc_at_k,
    map_keys_to_giantsteps,
    strip_completion,
)
