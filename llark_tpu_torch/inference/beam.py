"""Beam search over the KV-cached decoder (counterpart of
llark_tpu/inference/beam.py).

Beams ride the batch axis: [B*K] rows of one dense KV cache. Each step is
one decode over all rows (the flash-decode kernel where the config routes
there), a top-K over the [B, K*V] joint scores, and a gather of every
cache tensor by parent along the row axis (int8 caches' scales too). Two
[B, K] integer arrays (token, parent) reach the host a step; liveness is
mirrored there from them, and sequences are rebuilt from the parent
pointers.

Finished beams stay in the pool with frozen scores by proposing exactly
one zero-logprob continuation (their own pad, the eos id), which keeps
the shapes fixed.

Ties: the JAX package's `lax.top_k` puts the lower index first among equal
values, and `torch.topk` promises no order. `_top_k` sorts stably in
descending order, so equal scores (a dead beam's frozen rows, or exact
ties) order by index as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.device import resolve_device
from llark_tpu_torch.generate import Generator, decode_step, prefill
from llark_tpu_torch.models.decoder import CACHE_TENSORS, Params

_NEG_INF = -1e30


@dataclasses.dataclass
class BeamSearchConfig:
    num_beams: int = 4
    max_new_tokens: int = 256
    eos_token_id: Optional[int] = None
    length_penalty: float = 0.0  # 0 = pure logprob; > 0 favours longer outputs
    stop_text: str = "###"


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest values of each row of x and their indices, equal
    values in index order (`lax.top_k`'s order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def gather_beams(cache: Params, gidx: torch.Tensor) -> Params:
    """Every cache tensor [L, B*K, ...] gathered by row index `gidx` along
    axis 1 (a copy of the whole cache); the scalar index stays."""
    return {
        name: leaf.index_select(1, gidx) if name in CACHE_TENSORS else leaf
        for name, leaf in cache.items()
    }


def beam_step(
    cfg: ModelConfig,
    k: int,
    eos_id: int,
    params: Params,
    tokens: torch.Tensor,  # [B, K]
    cache: Params,
    write_pos: torch.Tensor,  # [B]
    scores: torch.Tensor,  # [B, K] fp32
    alive: torch.Tensor,  # [B, K] bool
):
    """One beam step (llark_tpu/inference/beam.py:44-75) -> (tokens,
    parents, scores, alive, cache), each [B, K] but the cache."""
    b = tokens.shape[0]
    logits, cache = decode_step(cfg, params, tokens.reshape(b * k), cache,
                                write_pos.repeat_interleave(k))
    v = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1).reshape(b, k, v)
    # dead beams propose exactly one frozen-score child: their pad token
    # (the eos id) at log-prob 0, everything else "minus infinity"
    dead = torch.full((v,), _NEG_INF, dtype=torch.float32, device=logp.device)
    if 0 <= eos_id < v:
        dead[eos_id] = 0.0
    cont = torch.where(alive[..., None], logp, dead)
    total = scores[..., None] + cont  # [B, K, V]
    new_scores, idx = _top_k(total.reshape(b, k * v), k)
    parent = idx // v  # [B, K] in [0, K)
    tok = idx % v
    gidx = (torch.arange(b, device=idx.device)[:, None] * k + parent).reshape(-1)
    cache = gather_beams(cache, gidx)
    new_alive = alive.gather(1, parent) & (tok != eos_id)
    return tok, parent, new_scores, new_alive, cache


class BeamSearcher:
    """Beam-search counterpart of `generate.Generator` (same call shape;
    llark_tpu/inference/beam.py:78-203)."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: Params,
        audio_patch_id: int,
        beam_cfg: Optional[BeamSearchConfig] = None,
        max_cache_len: int = 2048,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embed'].device}, the searcher on {self.device}"
            )
        self.cfg = cfg
        self.params = params
        self.beam_cfg = beam_cfg or BeamSearchConfig()
        if self.beam_cfg.num_beams < 1:
            raise ValueError("num_beams must be >= 1")
        self.audio_patch_id = audio_patch_id
        self.max_cache_len = max_cache_len

    def _tensor(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(self.device)

    @torch.inference_mode()
    def generate(
        self,
        input_ids: np.ndarray,  # [B, S] right-padded
        prompt_lengths: np.ndarray,  # [B]
        audio_encodings: Optional[np.ndarray] = None,
        audio_frame_counts: Optional[np.ndarray] = None,
        tokenizer=None,
        return_all_beams: bool = False,
        rng=None,  # taken for Generator's call shape; beam search is deterministic
    ):
        """Best beam per row (token list without the prompt), or all K
        (tokens, score) pairs per row with return_all_beams=True."""
        bc = self.beam_cfg
        k = bc.num_beams
        b, s = np.shape(input_ids)
        if s + bc.max_new_tokens > self.max_cache_len:
            raise ValueError("prompt + max_new_tokens exceeds cache length")
        eos = bc.eos_token_id
        if eos is None and tokenizer is not None:
            eos = getattr(tokenizer, "eos_token_id", None)
        # -1: a sentinel that matches no token, so beams never finish early
        eos = -1 if eos is None else int(eos)

        if audio_encodings is None:
            audio_encodings = np.zeros((b, 1, self.cfg.mm_hidden_size), np.float32)
            audio_frame_counts = np.zeros((b,), np.int32)
        if audio_frame_counts is None:
            audio_frame_counts = np.full((b,), np.shape(audio_encodings)[1], np.int32)
        prompt_lengths = np.asarray(prompt_lengths, np.int32)

        logits, cache = prefill(
            self.cfg, self.params, self._tensor(input_ids, torch.int64),
            self._tensor(prompt_lengths, torch.int32),
            self._tensor(audio_encodings, torch.float32),
            self._tensor(audio_frame_counts, torch.int32), self.audio_patch_id,
            self.max_cache_len,
        )
        # expand to K beams: the first step takes each row's top-K tokens
        scores, tokens = _top_k(torch.log_softmax(logits.float(), dim=-1), k)  # [B, K]
        cache = {name: leaf.repeat_interleave(k, dim=1) if name in CACHE_TENSORS else leaf
                 for name, leaf in cache.items()}
        alive = tokens != eos

        tok_np = tokens.cpu().numpy()
        alive_np = tok_np != eos  # host mirror: no extra read a step
        steps_tok: List[np.ndarray] = [tok_np]  # [B, K] per step
        steps_parent: List[np.ndarray] = []  # parents of the step t >= 1 choices
        write_pos = self._tensor(prompt_lengths, torch.int64)

        for t in range(1, bc.max_new_tokens):
            if not alive_np.any():
                break
            tokens, parent, scores, alive, cache = beam_step(
                self.cfg, k, eos, self.params, tokens, cache, write_pos + (t - 1), scores, alive
            )
            tok_np, parent_np = tokens.cpu().numpy(), parent.cpu().numpy()
            alive_np = np.take_along_axis(alive_np, parent_np, axis=1) & (tok_np != eos)
            steps_tok.append(tok_np)
            steps_parent.append(parent_np)

        scores_np = scores.cpu().numpy()  # [B, K]

        # backtrace through the parent pointers on the host
        n_steps = len(steps_tok)
        all_rows: List[List[Tuple[List[int], float]]] = []
        for i in range(b):
            beams: List[Tuple[List[int], float]] = []
            for j in range(k):
                seq = []
                bj = j
                for t in range(n_steps - 1, 0, -1):
                    seq.append(int(steps_tok[t][i, bj]))
                    bj = int(steps_parent[t - 1][i, bj])
                seq.append(int(steps_tok[0][i, bj]))
                seq.reverse()
                # trim at eos and any trailing pad continuation
                if eos in seq:
                    seq = seq[: seq.index(eos)]
                score = float(scores_np[i, j])
                if bc.length_penalty > 0.0 and seq:
                    score = score / (len(seq) ** bc.length_penalty)
                beams.append((seq, score))
            beams.sort(key=lambda p: -p[1])
            all_rows.append(beams)

        if bc.stop_text and tokenizer is not None:
            all_rows = [
                [(Generator._trim_stop(seq, tokenizer, bc.stop_text), sc) for seq, sc in row]
                for row in all_rows
            ]
        if return_all_beams:
            return all_rows
        return [row[0][0] for row in all_rows]
