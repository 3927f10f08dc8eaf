"""Shard URL handling: brace expansion, task-probability sampling, per-host
splitting.

Reference semantics: m2t/data_modules.py:430-463 (braceexpand URLs,
`repeat_shards` with task_sample_probs, `_REPEATS = 1024 * len(urls)`),
wds.split_by_node (m2t/data_modules.py:489-495): per-process splitting
keys off the torch.distributed rank and world size when a process group
is up (one process otherwise). No external deps: brace expansion is
implemented here.
here.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

log = logging.getLogger(__name__)

_BRACE_RE = re.compile(r"\{([^{}]*)\}")


def _expand_one(pattern: str) -> List[str]:
    m = _BRACE_RE.search(pattern)
    if not m:
        return [pattern]
    body = m.group(1)
    prefix, suffix = pattern[: m.start()], pattern[m.end() :]
    options: List[str] = []
    rng = re.fullmatch(r"(\d+)\.\.(\d+)", body)
    if rng:
        a, b = rng.group(1), rng.group(2)
        width = len(a) if a.startswith("0") or len(a) == len(b) else 0
        for i in range(int(a), int(b) + 1):
            options.append(str(i).zfill(width))
    elif "," in body:
        options = body.split(",")
    else:
        return [pattern]  # not an expandable brace
    out: List[str] = []
    for opt in options:
        out.extend(_expand_one(prefix + opt + suffix))
    return out


def braceexpand(pattern: str) -> List[str]:
    """Shell-style {a,b} and {000..123} expansion."""
    return _expand_one(pattern)


def expand_url_to_file_list(url: str) -> List[str]:
    """Comma-separated patterns, each brace-expanded
    (reference: m2t/data_modules.py:436-438)."""
    return [f for wildcard in url.split(",") for f in braceexpand(wildcard)]


def shard_sample_probs(
    urls: Sequence[str], task_sample_probs: Optional[Dict[str, float]]
) -> Optional[np.ndarray]:
    """Per-shard sampling probability by task-substring match
    (reference: m2t/data_modules.py:441-458)."""
    if task_sample_probs is None:
        return None

    def prob(shard: str) -> Optional[float]:
        for k, p in task_sample_probs.items():
            if k in shard:
                return p
        return None

    raw = [prob(u) for u in urls]
    if all(r is None for r in raw):
        # shards aren't named by task (e.g. 'train-000.tar'): task weighting
        # simply doesn't apply — sample uniformly rather than erroring on
        # the registry's default probs (reference errors only when the user
        # EXPLICITLY opted into task sampling, m2t/data_modules.py:441-458)
        log.warning(
            "no shard name matches any task in %s; sampling uniformly",
            sorted(task_sample_probs),
        )
        return None
    missing = [u for u, r in zip(urls, raw) if r is None]
    if missing:
        raise ValueError(
            f"{len(missing)} shard(s) match no task probability "
            f"(e.g. {missing[0]!r}) while others do — name every shard by "
            "task or pass --apply_task_sample_probs False"
        )
    p = np.asarray(raw, np.float64)
    return p / p.sum()


def repeat_shards(
    urls: List[str],
    task_sample_probs: Optional[Dict[str, float]] = None,
    seed: int = 936629,  # SHARD_SHUFFLE_SEED, reference m2t/data_modules.py:45
    repeats: Optional[int] = None,
) -> List[str]:
    """Sample an epoch-spanning shard sequence with task weighting."""
    probs = shard_sample_probs(urls, task_sample_probs)
    n = repeats if repeats is not None else 1024 * len(urls)
    rng = np.random.RandomState(seed)
    return rng.choice(urls, size=n, replace=True, p=probs).tolist()


def split_by_host(
    urls: Sequence[str],
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> List[str]:
    """Deterministic per-reader shard assignment (replaces
    wds.split_by_node). By default the reader is this rank's batch shard:
    its coordinate over the ("data", "fsdp") axes of the mesh it made
    (`parallel/mesh.py` current_batch_shard), so ranks that differ only in
    "tensor" or "expert" read the same rows and batch shards disjoint ones.
    Without a mesh, the rank in the default process group, if one is up."""
    if process_index is None or process_count is None:
        from llark_tpu_torch.parallel.mesh import current_batch_shard

        process_index, process_count = current_batch_shard()
    return [u for i, u in enumerate(urls) if i % process_count == process_index]
