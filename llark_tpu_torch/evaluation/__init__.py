"""Evaluation utilities and the scripted harness over inference CSVs
(`python -m llark_tpu_torch.evaluation.harness`)."""

from llark_tpu_torch.evaluation.utils import (  # noqa: F401
    VALID_KEYS,
    acc_at_k,
    map_keys_to_giantsteps,
    strip_completion,
)
