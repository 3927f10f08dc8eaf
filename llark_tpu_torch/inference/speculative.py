"""Speculative decoding: draft-and-verify generation (counterpart of
llark_tpu/inference/speculative.py).

Single-stream decode reads every weight once per emitted token. Verifying
`gamma` draft tokens in ONE forward over [last, d_1..d_gamma] reads the
weights once for up to gamma+1 emitted tokens; on the card the forward
also costs the host about as much as one decode step, so the host's
dispatch cost spreads over the accepted tokens too.

Two draft sources:

  * model draft -- a small decoder (e.g. the MPT-1B ablation
    architecture) proposes `gamma` greedy tokens per round from its own
    KV cache;
  * n-gram draft ("prompt lookup") -- no weights: propose the
    continuation of the most recent earlier occurrence of the current
    k-gram tail in (prompt + generated) tokens.

Verification is "sample-and-match": at each of the gamma+1 positions the
TARGET's token is sampled (argmax at temperature 0); proposals are
accepted while they equal the target's token, and the first mismatching
position emits the target's token. Greedy speculative output is therefore
the plain greedy decode's wherever the verify window's logits and a
single-token step's logits pick the same argmax: always up to rounding,
which differs between the window's and the step's product shapes. At
fp32 the gaps between top logits dwarf it (tested); at bf16 near ties
flip (`check_spec_dtype`). Sampled tokens draw their noise from a
`torch.Generator`, so they are not JAX's stream.

Cache consistency (why rollback is free): the decoder's ragged decode
path (models/decoder.py `_cache_step` with `cache_positions`) writes row
i's S tokens at [pos_i, pos_i + S) -- in a paged cache through the row's
block table, so a window may cross into the row's next block -- and each
query attends [0, its own position]. A rejected proposal's K/V is
overwritten by the next round's writes before any query reaches its
position, and re-feeding an already-consumed token at its position
rewrites the same values. The caches are written in place, where the JAX
package donates buffers between its programs.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.device import resolve_device
from llark_tpu_torch.generate import GenerationConfig, Generator, _sample, decode_n, prefill
from llark_tpu_torch.models.decoder import Params, decoder_forward, embed_tokens, torch_dtype

_GREEDY = GenerationConfig(temperature=0.0)


def check_spec_dtype(cfg: ModelConfig, allow_divergent: bool) -> None:
    """Refuse speculation below fp32 unless the caller opts in.

    Below fp32 the (gamma+1)-token verify forward and the one-token decode
    forward may round their products differently and flip near-tie
    argmaxes, so speculative greedy text can differ from plain greedy
    decode: on an NVIDIA H100 80GB HBM3 at 700 W, 1 and 2 of 16 bf16
    streams left plain decode's tokens in n-gram serving (chip_smoke.py
    phase 19, modes (a) and (b)). Every emitted token is still the argmax
    (or a sample) of the target's own logits, but whether the text may
    change is the operator's decision. fp32 runs equal plain greedy decode
    (tested)."""
    if allow_divergent or torch_dtype(cfg.dtype) == torch.float32:
        return
    raise ValueError(
        f"speculative decoding at dtype={cfg.dtype} can emit different text than "
        "plain greedy decode (bf16 products may round differently between the "
        "verify and decode shapes and flip near-tie argmaxes; measured on an H100: "
        "up to 2 of 16 streams diverged). Pass "
        "allow_divergent_spec=True (--allow-divergent-spec) to accept this, or run "
        "with dtype=float32 for speculation equal to greedy decode."
    )


def ngram_propose(history: Sequence[int], gamma: int, max_k: int = 3) -> List[int]:
    """Prompt-lookup draft: the continuation of the most recent earlier
    occurrence of the longest matching tail k-gram (k = max_k..1).
    Falls back to repeating the last token; wrong proposals only cost
    acceptance, never correctness."""
    h = np.asarray(history, np.int64)
    n = len(h)
    for k in range(min(max_k, n - 1), 0, -1):
        tail = h[n - k :]
        windows = np.lib.stride_tricks.sliding_window_view(h, k)  # [n-k+1, k]
        hits = np.flatnonzero(np.all(windows[:-1] == tail, axis=1))
        if hits.size:
            start = int(hits[-1]) + k
            out = list(map(int, h[start : start + gamma]))
            while len(out) < gamma:
                out.append(int(h[-1]))
            return out
    return [int(h[-1])] * gamma


def simulate_ngram_acceptance(
    tokens: Sequence[int], prompt_len: int, gamma: int = 4, max_k: int = 3
) -> Tuple[float, int]:
    """Replay n-gram drafting over an already generated sequence and
    report (acceptance_rate, rounds): the share of proposed tokens that
    WOULD have been accepted had this output been decoded speculatively.
    Host only."""
    seq = list(map(int, tokens))
    pos = prompt_len + 1  # the first output token is emitted by prefill
    accepted = proposed = rounds = 0
    while pos < len(seq):
        props = ngram_propose(seq[:pos], gamma, max_k)
        m = 0
        while m < gamma and pos + m < len(seq) and props[m] == seq[pos + m]:
            m += 1
        accepted += m
        proposed += gamma
        rounds += 1
        pos += m + 1  # the round's mismatch position emits the target token
    return (accepted / proposed if proposed else 0.0), rounds


def verify(
    cfg: ModelConfig,
    gen_cfg: GenerationConfig,
    params: Params,
    tokens_in: torch.Tensor,  # [B, gamma+1]: last emitted token, then proposals
    proposals: torch.Tensor,  # [B, gamma]
    cache: Params,
    write_positions: torch.Tensor,  # [B] cache position of tokens_in[:, 0]
    generator: Optional[torch.Generator],
) -> Tuple[torch.Tensor, torch.Tensor, Params]:
    """One target forward over the window (llark_tpu/inference/
    speculative.py:130-160) -> (target_tokens [B, gamma+1], n_emit [B],
    cache). target_tokens[:, j] is the target's token after input j; a
    row emits target_tokens[:, :n_emit], n_emit = accepted + 1."""
    gamma = proposals.shape[1]
    logits, cache = decoder_forward(
        cfg, params, inputs_embeds=embed_tokens(cfg, params, tokens_in), kv_cache=cache,
        cache_positions=write_positions,
    )  # [B, gamma+1, V]
    target = torch.stack(
        [_sample(logits[:, j], gen_cfg, generator) for j in range(gamma + 1)], dim=1
    )
    matches = (proposals.long() == target[:, :gamma]).long()
    n_emit = matches.cumprod(dim=1).sum(dim=1) + 1
    return target, n_emit, cache


def draft_propose(
    cfg: ModelConfig,
    params: Params,
    last2: torch.Tensor,  # [B, 2]: the last two emitted tokens
    cache: Params,
    positions2: torch.Tensor,  # [B] cache position of last2[:, 0]
    gamma: int,
) -> Tuple[torch.Tensor, Params]:
    """The draft's proposals (llark_tpu/inference/speculative.py:163-191):
    consume the last two emitted tokens (the second is new to the draft,
    the first an idempotent rewrite) for d_1, then gamma - 1 greedy decode
    steps -> (proposals [B, gamma], cache)."""
    logits, cache = decoder_forward(
        cfg, params, inputs_embeds=embed_tokens(cfg, params, last2), kv_cache=cache,
        cache_positions=positions2,
    )
    d1 = torch.argmax(logits[:, -1], dim=-1)
    if gamma == 1:
        return d1[:, None], cache
    # consumes d_1..d_{gamma-1}, each at its own position, and samples
    # d_2..d_gamma; d_gamma itself is consumed next round through last2
    rest, _, cache = decode_n(cfg, _GREEDY, params, d1, cache, positions2 + 2, gamma - 1, None)
    return torch.cat([d1[:, None], rest], dim=1), cache


def make_fused_rounds_fn(
    cfg: ModelConfig,
    draft_cfg: ModelConfig,
    gen_cfg: GenerationConfig,
    gamma: int,
    rounds: int,
    max_pos: int,
):
    """R complete speculative rounds (draft-propose -> target-verify ->
    accept -> advance) with no host read until they end
    (llark_tpu/inference/speculative.py:194-315, where they are one jitted
    scan). Every per-row quantity stays a tensor on the device, as in
    `decode_n`, so the host enqueues R rounds back to back and reads their
    tokens once.

    Returns fused(t_params, d_params, t_cache, d_cache, prev_tok, last_tok,
    pos, generator) -> (tokens [B, R, gamma+1], n_emit [B, R], t_cache,
    d_cache, prev_tok, last_tok, pos). Rows the host has finished keep
    rolling; their positions clamp at `max_pos`, so their writes stay in
    bounds and in the never-attended tail."""

    def fused(t_params, d_params, t_cache, d_cache, prev_tok, last_tok, pos, generator):
        toks, n_emits = [], []
        for _ in range(rounds):
            last2 = torch.stack([prev_tok, last_tok], dim=1)
            proposals, d_cache = draft_propose(draft_cfg, d_params, last2, d_cache, pos - 1, gamma)
            tokens_in = torch.cat([last_tok[:, None], proposals], dim=1)
            target, n_emit, t_cache = verify(
                cfg, gen_cfg, t_params, tokens_in, proposals, t_cache, pos, generator
            )
            new_last = target.gather(1, (n_emit - 1)[:, None])[:, 0]
            new_prev = torch.where(
                n_emit >= 2, target.gather(1, (n_emit - 2).clamp_min(0)[:, None])[:, 0], last_tok
            )
            prev_tok, last_tok = new_prev, new_last
            pos = torch.clamp(pos + n_emit, max=max_pos)
            toks.append(target)
            n_emits.append(n_emit)
        return (torch.stack(toks, dim=1), torch.stack(n_emits, dim=1), t_cache, d_cache,
                prev_tok, last_tok, pos)

    return fused


class SpeculativeGenerator:
    """Drop-in alternative to `generate.Generator` with draft-and-verify
    decoding (llark_tpu/inference/speculative.py:318-564). Greedy output is
    plain greedy decode's (see the module docstring); sampled output is
    drawn from the target's distribution (sample-and-match).

    draft_cfg/draft_params absent => n-gram prompt-lookup drafting. Both
    models live on `device`; the draft may share the target's tensors."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: Params,
        audio_patch_id: int,
        gen_cfg: Optional[GenerationConfig] = None,
        max_cache_len: int = 2048,
        draft_cfg: Optional[ModelConfig] = None,
        draft_params: Optional[Params] = None,
        gamma: int = 4,
        ngram_max_k: int = 3,
        fused_rounds: int = 4,
        allow_divergent: bool = False,
        device: Union[str, torch.device] = "cuda",
    ):
        if (draft_cfg is None) != (draft_params is None):
            raise ValueError("draft_cfg and draft_params must be given together")
        check_spec_dtype(cfg, allow_divergent)
        self.device = resolve_device(device)
        for name, tree in (("params", params), ("draft_params", draft_params)):
            if tree is not None and tree["embed"].device.type != self.device.type:
                raise ValueError(
                    f"{name} live on {tree['embed'].device}, the generator on {self.device}"
                )
        self.cfg = cfg
        self.params = params
        self.gen_cfg = gen_cfg or GenerationConfig()
        self.audio_patch_id = audio_patch_id
        self.max_cache_len = max_cache_len
        self.gamma = int(gamma)
        self.ngram_max_k = int(ngram_max_k)
        if self.gamma < 1:
            raise ValueError("gamma must be >= 1")
        self.draft_cfg = draft_cfg
        self.draft_params = draft_params
        # R > 0 with a model draft: R full rounds per host read (n-gram
        # proposals come from the host, so they keep the per-round loop)
        self.fused_rounds = int(fused_rounds) if draft_cfg is not None else 0
        self.last_acceptance_rate = 0.0
        if self.fused_rounds > 0:
            self._fused = make_fused_rounds_fn(
                cfg, draft_cfg, self.gen_cfg, self.gamma, self.fused_rounds,
                max_cache_len - self.gamma - 2,
            )

    def _tensor(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(self.device)

    def _propose(self, histories: List[List[int]], draft_cache: Optional[Params],
                 positions2: np.ndarray) -> Tuple[np.ndarray, Optional[Params]]:
        if self.draft_cfg is None:
            props = np.stack([
                np.asarray(ngram_propose(h, self.gamma, self.ngram_max_k), np.int64)
                for h in histories
            ])
            return props, draft_cache
        # a done row can have a length-1 history (1-token prompt, first
        # sample was EOS): pad by repeating; its proposals are never used
        last2 = np.stack([h[-2:] if len(h) >= 2 else [h[-1], h[-1]] for h in histories])
        props, draft_cache = draft_propose(
            self.draft_cfg, self.draft_params, self._tensor(last2, torch.int64), draft_cache,
            self._tensor(positions2, torch.int32), self.gamma,
        )
        return props.cpu().numpy(), draft_cache

    @torch.inference_mode()
    def generate(
        self,
        input_ids: np.ndarray,  # [B, S] right-padded
        prompt_lengths: np.ndarray,  # [B]
        audio_encodings: Optional[np.ndarray] = None,
        audio_frame_counts: Optional[np.ndarray] = None,
        tokenizer=None,
        rng: Optional[torch.Generator] = None,
    ) -> List[List[int]]:
        gen_cfg = self.gen_cfg
        b, s = np.shape(input_ids)
        if s + gen_cfg.max_new_tokens + self.gamma > self.max_cache_len:
            raise ValueError("prompt + max_new_tokens + gamma exceeds cache length")
        if rng is None:
            rng = torch.Generator(device=self.device)
            rng.manual_seed(0)
        if audio_encodings is None:
            audio_encodings = np.zeros((b, 1, self.cfg.mm_hidden_size), np.float32)
            audio_frame_counts = np.zeros((b,), np.int32)
        if audio_frame_counts is None:
            audio_frame_counts = np.full((b,), np.shape(audio_encodings)[1], np.int32)
        prompt_lengths = np.asarray(prompt_lengths, np.int32)
        args = (self._tensor(input_ids, torch.int64), self._tensor(prompt_lengths, torch.int32),
                self._tensor(audio_encodings, torch.float32),
                self._tensor(audio_frame_counts, torch.int32))
        logits, cache = prefill(self.cfg, self.params, *args, self.audio_patch_id,
                                self.max_cache_len)
        first = _sample(logits, gen_cfg, rng).cpu().numpy()
        draft_cache = None
        if self.draft_cfg is not None:
            _, draft_cache = prefill(self.draft_cfg, self.draft_params, *args,
                                     self.audio_patch_id, self.max_cache_len)

        # host state: each row's whole history (prompt + emitted)
        histories = [list(map(int, input_ids[i, : prompt_lengths[i]])) for i in range(b)]
        done = np.zeros((b,), bool)
        out: List[List[int]] = [[] for _ in range(b)]
        emitted = np.zeros((b,), np.int64)
        eos, stop_text = gen_cfg.eos_token_id, gen_cfg.stop_text

        def absorb_one(i: int, t: int) -> None:
            if done[i]:
                return
            if eos is not None and t == eos:
                done[i] = True
                return
            out[i].append(t)
            histories[i].append(t)
            emitted[i] += 1
            if emitted[i] >= gen_cfg.max_new_tokens:
                done[i] = True
            elif stop_text and tokenizer is not None:
                if stop_text in tokenizer.decode(out[i][-8:]):
                    done[i] = True

        def absorb_round(toks: np.ndarray, n_emit: np.ndarray) -> Tuple[int, int]:
            """Absorb one round's [B, gamma+1] tokens -> (accepted, proposed):
            only tokens actually emitted count (EOS, stop text or the
            budget can cut a round short), less the one the target emits
            regardless."""
            accepted = proposed = 0
            for i in range(b):
                if done[i]:
                    continue
                before = int(emitted[i])
                for j in range(int(n_emit[i])):
                    absorb_one(i, int(toks[i, j]))
                    if done[i]:
                        break
                accepted += max(0, int(emitted[i]) - before - 1)
                proposed += self.gamma
            return accepted, proposed

        for i in range(b):
            absorb_one(i, int(first[i]))

        accepted = proposed = 0
        if self.fused_rounds > 0:
            prev_tok = self._tensor([h[-2] if len(h) >= 2 else h[-1] for h in histories],
                                    torch.int64)
            last_tok = self._tensor([h[-1] for h in histories], torch.int64)
            pos = self._tensor(prompt_lengths + emitted - 1, torch.int64)
            while not done.all():
                toks, n_emits, cache, draft_cache, prev_tok, last_tok, pos = self._fused(
                    self.params, self.draft_params, cache, draft_cache, prev_tok, last_tok,
                    pos, rng,
                )
                toks, n_emits = toks.cpu().numpy(), n_emits.cpu().numpy()  # the only reads
                for r in range(self.fused_rounds):
                    a, p = absorb_round(toks[:, r], n_emits[:, r])
                    accepted, proposed = accepted + a, proposed + p
        else:
            while not done.all():
                # row i's last emitted token sits at prompt_len + emitted - 1
                write_pos = prompt_lengths + emitted - 1
                proposals, draft_cache = self._propose(histories, draft_cache, write_pos - 1)
                last = np.asarray([h[-1] for h in histories], np.int64)
                tokens_in = np.concatenate([last[:, None], proposals], axis=1)
                target, n_emit, cache = verify(
                    self.cfg, gen_cfg, self.params, self._tensor(tokens_in, torch.int64),
                    self._tensor(proposals, torch.int64), cache,
                    self._tensor(write_pos, torch.int32), rng,
                )
                a, p = absorb_round(target.cpu().numpy(), n_emit.cpu().numpy())
                accepted, proposed = accepted + a, proposed + p

        self.last_acceptance_rate = accepted / proposed if proposed else 0.0
        if stop_text and tokenizer is not None:
            out = [Generator._trim_stop(ids, tokenizer, stop_text) for ids in out]
        return out
