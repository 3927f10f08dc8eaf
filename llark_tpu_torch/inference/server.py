"""Continuous-batching serving engine (counterpart of
llark_tpu/inference/server.py).

The reference serves batch=1, one request at a time
(scripts/inference/infer_from_webdataset.py:84-151). This engine keeps ONE
persistent batched KV cache of `max_batch` slots on the card and:

  * prefills each admission group together in one bucket-sized forward and
    copies its rows into free slots of the batched cache (or, paged, into
    the rows' pool blocks);
  * decodes all slots together in chunks of `decode_chunk` steps (per-row
    write positions, so rows at different depths coexist in one batch),
    sampling on the card from one seeded torch.Generator; each round is
    one `DecodeProgram` (a CUDA graph on the card), one for
    `decode_chunk` and one for `decode_chunk_drain`, like the reference's
    two compiled rounds (llark_tpu/inference/server.py:339-342,388-393);
  * retires rows on max_new_tokens / stop-text / EOS and immediately
    reuses their slots for queued requests.

Cache modes: dense or paged (`kv_block_size`), bf16 or int8
(`cfg.kv_cache_quant`); chunked admission (`prefill_chunk`, direct to the
pool when paged) and prefix caching (`shared_prefix_ids`). Every decode
step runs the flash-decode kernel in the cache's mode.

Speculative serving (inference/speculative.py): with a draft model
(`draft_cfg`, `draft_params`) each decode round is `spec_rounds` fused
propose -> verify -> accept rounds with one host read at their end; with
`spec_mode="ngram"` the host proposes from each row's history (or
`spec_proposer`) and one target forward over [last, d_1..d_gamma]
verifies every slot's window. Verify windows run the flash-decode kernel
at Sq = gamma + 1 in the cache's mode; the draft's cache is dense.

The caches are written in place, so where the JAX engine hands donated
buffers between its programs, this one shares tensors: the persistent
cache, a paged admission's cache dict and the decode rounds interleaved
with chunked admission all see the same pool tensors, and each write lands
before the next forward reads it. The decode programs replay on the
persistent cache's tensors, so they are allocated once and only ever
written in place, the block tables too (`_refresh_tables`).

Admission runs through programs too, one per (step, bucket) as the
reference jits one per shape (`_program`): the one-shot prefill, the
suffix prefill over the seeded prefix cache, the fused embeddings of a
chunked admission, its dense or paged chunks and its tail, and the row or
block insert into the persistent cache. Each is bound to tensors that are
allocated once and rewritten in place: a bucket's admission cache (seeded
with the prefix once, with prefix caching), a bucket's admission block
tables (`_pool_view`), the persistent cache. On the card each is a CUDA
graph in the pool the decode programs share, and the outputs a later step
reads (the embeddings across the decode rounds between chunks, the
logits) are buffers the programs own outside the pool. The draft model's
admission, the one-time prefix prefills and the speculative rounds run
eagerly.

Mesh serving (`mesh`, a `parallel/mesh.py` make_mesh mesh): every rank
builds the same server from the same full trees, keeps its shards
(`shard_model`: Megatron/ZeRO specs, int8 and int4 trees adapted; the draft
too) and runs the same engine loop on the same requests; the decoder sums
over "tensor" after wo / w_down and gathers the logits, so every rank
samples the same tokens, and its KV cache holds the rank's Hkv/t heads.
Its decode rounds and admission run eagerly (`decode_n`, each program's
`plain` route): two ranks on one card talk over gloo's host-staged
collectives, which a CUDA graph cannot hold.
The kernels run on each rank's local heads and shards. The engine's two
wall-clock decisions (admit_max_wait_s, admit_reorder_age_s) are taken on
rank 0 and broadcast, so the ranks never diverge; serve() returns the
requests, complete, on every rank.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.device import resolve_device
from llark_tpu_torch.generate import (
    DecodeProgram,
    GenerationConfig,
    Generator,
    GraphPool,
    _sample,
    decode_n,
    make_multistep_decode_fn,
    make_paged_prefill_chunk_fn,
    make_prefill_chunk_fn,
    make_prefill_fn,
    make_prefill_last_fn,
    make_suffix_prefill_fn,
    paged_prefill_chunk,
    prefill,
    prefix_cache,
    suffix_prefill,
)
from llark_tpu_torch.graphs import Program, as_index, cache_tensors
from llark_tpu_torch.inference.paged import BlockAllocator, make_block_insert_fn
from llark_tpu_torch.inference.speculative import (
    check_spec_dtype,
    make_fused_rounds_fn,
    ngram_propose,
    verify,
)
from llark_tpu_torch.models.decoder import (
    CACHE_TENSORS,
    Params,
    embed_tokens,
    init_kv_cache,
    init_paged_kv_cache,
    torch_dtype,
)
from llark_tpu_torch.models.fusion import build_inputs_embeds
from llark_tpu_torch.ops.decode_attention import max_paged_block_size

log = logging.getLogger(__name__)


def insert_row(batch_cache: Params, new_cache: Params, src_row: Union[int, torch.Tensor],
               dst_slot: Union[int, torch.Tensor]) -> None:
    """Copy row `src_row` of a freshly prefilled cache into slot `dst_slot`
    of the persistent batched cache, in place (leaves [L, B, ...]; the
    admission cache may be shorter than the slot). The row and the slot are
    ints or int64 device tensors (a program's static buffers,
    `graphs.as_index`)."""
    for key in CACHE_TENSORS:
        if key in batch_cache:
            dst = batch_cache[key]
            row = new_cache[key].index_select(1, as_index(src_row, dst.device))
            dst[:, :, :, : row.shape[3]].index_copy_(1, as_index(dst_slot, dst.device),
                                                     row.to(dst.dtype))


class RowInsertProgram(Program):
    """`insert_row` as one program (the reference's `jax.jit(self._insert_row,
    donate_argnums=(0,))`, llark_tpu/inference/server.py:394): (batch_cache,
    new_cache, src_row, dst_slot) -> batch_cache. Bound to both caches'
    tensors; the row and the slot go into static device buffers, so one
    program serves every admitted row and slot."""

    what = "row insert"

    def plain(self, batch_cache: Params, new_cache: Params, src_row, dst_slot) -> Params:
        insert_row(batch_cache, new_cache, src_row, dst_slot)
        return batch_cache

    @torch.inference_mode()
    def __call__(self, batch_cache: Params, new_cache: Params, src_row: int,
                 dst_slot: int) -> Params:
        self.bind(cache=cache_tensors(batch_cache), rows=cache_tensors(new_cache))
        dev = batch_cache["k"].device
        x = self.stage(row=as_index(int(src_row), dev), slot=as_index(int(dst_slot), dev))

        def body():
            self.plain(self._bound["cache"], self._bound["rows"], x["row"], x["slot"])
            return ()

        self.run(body, dev)
        return batch_cache


class EmbedProgram(Program):
    """The fused prompt embeddings of a chunked admission as one program
    (the reference's jitted `build_inputs_embeds`,
    llark_tpu/inference/server.py:319): (params, ids [B, S], audio
    [B, T, mm], frame_counts [B]) -> embeds [B, S, H], a buffer the program
    owns: the chunks and the tail read it across the decode rounds between
    them."""

    what = "embed"

    def __init__(self, cfg: ModelConfig, audio_patch_id: int, pool: Optional[GraphPool] = None):
        super().__init__(pool)
        self.cfg, self.audio_patch_id = cfg, audio_patch_id

    def plain(self, params: Params, ids, audio, frame_counts) -> torch.Tensor:
        return build_inputs_embeds(self.cfg, params, ids, audio, self.audio_patch_id, frame_counts)

    @torch.inference_mode()
    def __call__(self, params: Params, ids, audio, frame_counts) -> torch.Tensor:
        self.bind(params=params)
        x = self.stage(ids=ids, audio=audio, frames=frame_counts)
        embeds, = self.run(lambda: (self.plain(params, x["ids"], x["audio"], x["frames"]),),
                           ids.device)
        return embeds


@dataclass
class Request:
    input_ids: np.ndarray  # [S] int32 (unpadded)
    audio_encoding: Optional[np.ndarray] = None  # [T, mm] f32
    # per-request token budget; clamped to the server-level
    # gen_cfg.max_new_tokens so serve()'s capacity math stays valid
    max_new_tokens: Optional[int] = None
    # filled by the engine:
    tokens: List[int] = field(default_factory=list)
    done: bool = False
    error: Optional[str] = None  # set by an online engine on failure
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None


class BatchedServer:
    """Continuous-batching engine over a fixed slot count."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: Params,
        audio_patch_id: int,
        gen_cfg: Optional[GenerationConfig] = None,
        *,
        max_batch: int = 4,
        max_cache_len: int = 1024,
        prompt_buckets: tuple = (128, 512),
        max_audio_frames: int = 60,
        decode_chunk: int = 8,
        decode_chunk_drain: Optional[int] = None,
        drain_max_active: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        tokenizer=None,
        draft_cfg: Optional[ModelConfig] = None,
        draft_params=None,
        gamma: int = 4,
        spec_rounds: int = 2,
        shared_prefix_ids: Optional[np.ndarray] = None,
        spec_mode: Optional[str] = None,
        spec_proposer=None,
        ngram_max_k: int = 3,
        spec_force_accept: Optional[float] = None,
        kv_block_size: Optional[int] = None,
        kv_pool_blocks: Optional[int] = None,
        admit_batch: Optional[int] = None,
        allow_divergent_spec: bool = False,
        admit_min_fill: int = 1,
        admit_max_wait_s: float = 0.05,
        admit_reorder: bool = False,
        admit_reorder_age_s: float = 0.5,
        mesh=None,
        device: Union[str, torch.device] = "cuda",
        seed: int = 0,
    ):
        self.mesh = mesh
        if mesh is not None:
            from llark_tpu_torch.parallel.mesh import shard_model

            cfg, params = shard_model(mesh, cfg, params)
            if draft_cfg is not None and draft_params is not None:
                draft_cfg, draft_params = shard_model(mesh, draft_cfg, draft_params)
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embed'].device}, the server on {self.device}"
            )
        if cfg.use_flash_decode is None:
            # serving regime: the cache is provisioned for max context and
            # live length is usually well below it -- the flash-decode
            # kernel's live-only reads win here
            cfg = dataclasses.replace(cfg, use_flash_decode=True)
        self.cfg = cfg
        self.params = params
        self.audio_patch_id = audio_patch_id
        self.gen_cfg = gen_cfg or GenerationConfig()
        self.max_batch = max_batch
        # admission prefill batch: the transient-memory knob. The bucket-
        # sized admission cache ([L, admit_batch, Hkv, bucket, D]) coexists
        # with weights + the persistent cache/pool while requests splice
        # in; a smaller admit_batch trades burst-admission latency
        # (ceil(burst / admit_batch) prefills) for peak memory.
        self.admit_batch = min(admit_batch or max_batch, max_batch)
        # admission hysteresis (open-loop scheduling): every admission
        # prefill is padded to admit_batch rows and stalls decode for all
        # live slots, so with admit_min_fill > 1 the server waits until that
        # many requests are queued (or the oldest has waited
        # admit_max_wait_s, or no rows are active) before prefilling
        self.admit_min_fill = max(1, int(admit_min_fill))
        self.admit_max_wait_s = float(admit_max_wait_s)
        # bounded admission reordering (mixed-length traffic): each wave is
        # ONE bucket; with admit_reorder the largest queued same-bucket
        # group wins the wave, unless the head request has waited
        # admit_reorder_age_s, which forces its bucket (no starvation)
        self.admit_reorder = bool(admit_reorder)
        self.admit_reorder_age_s = float(admit_reorder_age_s)
        self.max_cache_len = max_cache_len
        self.prompt_buckets = tuple(sorted(prompt_buckets))
        self.max_audio_frames = max_audio_frames
        self.decode_chunk = decode_chunk
        self.tokenizer = tokenizer

        # prefix caching: every LLark request opens with the same
        # conversation header (conv_v1_2, reference
        # m2t/llava/conversation.py:237-271), so its KV is computed once
        # and admission prefills only the per-request suffix. Dense: a b=1
        # prefix cache copied into every admission cache. Paged: the block-
        # aligned head of the prefix fills shared pool blocks every slot's
        # table points at (the sub-block remainder folds into each
        # request's suffix), on the direct-to-pool chunked-prefill path.
        self._prefix_ids: Optional[np.ndarray] = None
        self._prefix_cache: Optional[Params] = None
        if shared_prefix_ids is not None:
            if prefill_chunk is not None and kv_block_size is None:
                raise ValueError(
                    "prefix caching and chunked prefill are mutually exclusive "
                    "(the suffix IS the short part)"
                )
            pids = np.asarray(shared_prefix_ids, np.int32).reshape(-1)
            if pids.size < 1:
                raise ValueError("shared_prefix_ids must be non-empty")
            if np.any(pids == audio_patch_id):
                raise ValueError(
                    "the shared prefix must be text-only (audio patch tokens "
                    "belong to the per-request suffix)"
                )
            if kv_block_size is not None:
                if prefill_chunk is None:
                    raise ValueError(
                        "paged prefix caching rides the direct-to-pool chunked "
                        "admission path: set prefill_chunk (a suffix-bucket-"
                        "sized chunk gives one-shot behavior)"
                    )
                if pids.size < kv_block_size:
                    raise ValueError(
                        f"shared prefix ({pids.size} tokens) is shorter than one "
                        f"KV block ({kv_block_size}): no full block to share -- "
                        "drop prefix caching or shrink kv_block_size"
                    )
            self._prefix_ids = pids
        # full length for prompt matching; the CACHED length (everything
        # admission may skip) is block-aligned in paged mode
        self._prefix_match_len = 0 if self._prefix_ids is None else int(self._prefix_ids.size)
        if self._prefix_ids is not None and kv_block_size is not None:
            self._prefix_len = (self._prefix_match_len // kv_block_size) * kv_block_size
        else:
            self._prefix_len = self._prefix_match_len
        # drop impossible bucket geometry up front: every admission table /
        # cache is sized bucket (+ chunk padding) past the cached prefix.
        # Oversized buckets are filtered, not fatal; only a geometry where
        # no bucket fits raises.
        feasible = []
        for b in self.prompt_buckets:
            pad = (-b) % prefill_chunk if prefill_chunk else 0
            if self._prefix_len + b + pad > max_cache_len:
                log.warning(
                    "dropping prompt bucket %d%s: cannot fit max_cache_len %d%s -- "
                    "prompts longer than the largest remaining bucket will be "
                    "rejected at submission",
                    b, f" (padded to {b + pad} by prefill_chunk)" if pad else "",
                    max_cache_len,
                    f" after the {self._prefix_len}-token cached prefix" if self._prefix_len else "",
                )
                continue
            if kv_block_size is not None and prefill_chunk is not None and b % prefill_chunk:
                raise ValueError(
                    f"paged chunked prefill needs every prompt bucket to be a "
                    f"multiple of prefill_chunk ({prefill_chunk}); got {b}"
                )
            feasible.append(b)
        if not feasible:
            raise ValueError(
                f"no prompt bucket in {self.prompt_buckets} fits max_cache_len "
                f"{max_cache_len}"
                + (f" after the {self._prefix_len}-token cached prefix" if self._prefix_len else "")
                + (f" with prefill_chunk {prefill_chunk} padding" if prefill_chunk else "")
                + ": shrink the buckets or enlarge the cache"
            )
        self.prompt_buckets = tuple(feasible)

        # chunked admission: interleave prompt-chunk forwards with decode
        # rounds so live slots keep emitting during long-prompt prefills
        self.prefill_chunk = prefill_chunk
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        # adaptive decode rounds: with decode_chunk_drain set, rounds
        # dispatched while at most drain_max_active slots (default: half)
        # are live run this shorter chunk, keeping the unpreemptible window
        # that a new arrival waits out short at low load. The per-token math
        # is the same, so tokens are unchanged.
        self.decode_chunk_drain = decode_chunk_drain
        if decode_chunk_drain is not None:
            self.drain_max_active = (
                max_batch // 2 if drain_max_active is None else int(drain_max_active)
            )
            if not 1 <= decode_chunk_drain <= decode_chunk:
                raise ValueError(
                    f"decode_chunk_drain {decode_chunk_drain} must be in "
                    f"[1, decode_chunk={decode_chunk}] (capacity headroom is "
                    "provisioned for the full chunk)"
                )
            if spec_mode is not None or draft_cfg is not None:
                # speculative rounds replace plain decode rounds entirely
                log.warning(
                    "decode_chunk_drain is inert under speculation: propose/verify "
                    "rounds replace plain decode rounds, so the short drain round "
                    "never runs"
                )

        # speculative serving. bf16 speculation can emit other text than
        # plain decode (verify and decode shapes round differently), so
        # below fp32 it needs an explicit opt-in; a caller that forces
        # acceptance (spec_force_accept) has declared its tokens meaningless
        if (draft_cfg is None) != (draft_params is None):
            raise ValueError("draft_cfg and draft_params must be given together")
        if spec_mode is not None or draft_cfg is not None:
            check_spec_dtype(cfg, allow_divergent_spec or spec_force_accept is not None)
        if spec_mode is not None:
            if spec_mode != "ngram":
                raise ValueError(f"unknown spec_mode {spec_mode!r}")
            if draft_cfg is not None:
                raise ValueError(
                    "spec_mode='ngram' and a draft model are mutually exclusive "
                    "(pick one proposal source)"
                )
        self.gamma = int(gamma)
        self.spec_rounds = int(spec_rounds)
        if draft_cfg is not None:
            if draft_params["embed"].device.type != self.device.type:
                raise ValueError(
                    f"draft_params live on {draft_params['embed'].device}, the server "
                    f"on {self.device}"
                )
            if draft_cfg.mm_hidden_size != cfg.mm_hidden_size:
                # admission feeds ONE audio buffer to both prefills
                raise ValueError(
                    f"draft mm_hidden_size {draft_cfg.mm_hidden_size} != target "
                    f"{cfg.mm_hidden_size}"
                )
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_cfg.vocab_size} != target {cfg.vocab_size} "
                    "(proposals are target-vocab ids)"
                )
            if draft_cfg.use_flash_decode is None:
                draft_cfg = dataclasses.replace(draft_cfg, use_flash_decode=True)
            # device rows may overshoot while the host decides to stop them:
            # the fused rounds clamp their positions here, in bounds
            self._spec_max_pos = max_cache_len - 1 - self.gamma
            self._spec = make_fused_rounds_fn(
                cfg, draft_cfg, self.gen_cfg, self.gamma, self.spec_rounds, self._spec_max_pos
            )
            self._d_cache: Optional[Params] = None
            self._d_prefix_cache: Optional[Params] = None
            self._prev_tok = np.zeros((max_batch,), np.int64)
        self.draft_cfg = draft_cfg
        self.draft_params = draft_params
        # draft-free speculation: host proposals (prompt lookup, or any
        # `spec_proposer(history, gamma) -> [gamma] ids`) verified by ONE
        # target forward over [last, d_1..d_gamma] per round; the host reads
        # every round, since proposals need the newly accepted tokens
        self.spec_mode = spec_mode
        self.spec_proposer = spec_proposer
        self.ngram_max_k = int(ngram_max_k)
        if spec_mode is not None and spec_proposer is None:
            self.spec_proposer = lambda hist, g: ngram_propose(hist, g, self.ngram_max_k)
        self.spec_accepted = 0  # host-round acceptance counters (stats())
        self.spec_proposed = 0
        # for measurements only: override each verify result with a host-
        # drawn acceptance of this probability per proposal. The device work
        # is unchanged (same forward, same writes); the tokens are not
        # meaningful under it.
        self.spec_force_accept = spec_force_accept
        self._force_rng = np.random.RandomState(1234)

        # paged KV (kv_block_size set): the persistent cache is a physical
        # block POOL + per-slot block tables instead of max_batch dense
        # max_cache_len rows. Tables are host-owned; a dirty flag refreshes
        # the device copy (int32 [B, max_blocks]) before the next decode.
        self.kv_block_size = kv_block_size
        self.paged = kv_block_size is not None
        if self.paged:
            if max_cache_len % kv_block_size:
                raise ValueError(
                    f"max_cache_len {max_cache_len} must be a multiple of "
                    f"kv_block_size {kv_block_size}"
                )
            if kv_block_size % 8:
                raise ValueError(
                    "kv_block_size must be a multiple of 8 (the JAX package's "
                    "tiling rule for pool blocks, kept so both serve the same "
                    "configurations)"
                )
            itemsize = 1 if cfg.kv_cache_quant else torch_dtype(cfg.dtype).itemsize
            cap = max_paged_block_size(cfg.num_kv_heads, cfg.head_dim, itemsize)
            if kv_block_size > cap:
                raise ValueError(
                    f"kv_block_size {kv_block_size} exceeds the flash-decode "
                    f"kernel's maximum {cap} for {cfg.num_kv_heads} KV heads x "
                    f"head_dim {cfg.head_dim}"
                )
            if (spec_mode is not None or draft_cfg is not None) and self.gamma + 1 > kv_block_size:
                raise ValueError("gamma+1 must fit in one KV block")
            self._max_blocks = max_cache_len // kv_block_size
            if kv_pool_blocks is None:
                # conservative default: full dense capacity (callers size the
                # pool down to their live-token budget)
                kv_pool_blocks = max_batch + max_batch * self._max_blocks
            self.kv_pool_blocks = kv_pool_blocks
            self._allocator = BlockAllocator(kv_pool_blocks, max_batch)
            self._host_tables = np.broadcast_to(
                np.arange(max_batch, dtype=np.int32)[:, None], (max_batch, self._max_blocks)
            ).copy()
            self._tables_dirty = True
            self._slot_blocks: List[List[int]] = [[] for _ in range(max_batch)]
            # paged prefix caching: pool blocks holding the block-aligned
            # shared-prefix KV, read by every slot's table, never freed
            self._shared_block_ids: Optional[List[int]] = None

        # persistent batched cache, built at the first admission
        self._cache: Optional[Params] = None
        # host-side slot state
        self._slot_req: List[Optional[Request]] = [None] * max_batch
        self._write_pos = np.zeros((max_batch,), np.int32)
        self._tokens_in_flight = np.zeros((max_batch,), np.int32)  # pending device col
        self._queue: List[Request] = []
        self._rng = torch.Generator(device=self.device)
        self._rng.manual_seed(seed)
        # plain decode rounds: chunk length -> program, sharing one pool
        self._programs: Dict[int, DecodeProgram] = {}
        self._pool = GraphPool(self.device) if self.device.type == "cuda" and mesh is None else None
        # admission: (step, bucket) -> program, in the same pool; the dense
        # admission caches by length and the admission block tables by shape
        # they are bound to, each allocated once
        self._admission: Dict[tuple, Program] = {}
        self._admit_caches: Dict[int, Params] = {}
        self._admit_tables: Dict[tuple, torch.Tensor] = {}
        # exclusive-driver guard: an online engine claims the server; serve()
        # refuses to run concurrently (two drivers would race the cache)
        self.driver = None

    # ------------------------------------------------------------------
    def _tensor(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(self.device)

    def _program(self, kind: str, bucket: int):
        """The admission program `kind` of one bucket, made at its first use
        and bound at its first call; on a mesh its eager `plain` route."""
        key = (kind, bucket)
        if key not in self._admission:
            cfg, pool, patch = self.cfg, self._pool, self.audio_patch_id
            make = {
                "prefill": lambda: make_prefill_fn(cfg, patch, bucket, pool),
                "suffix": lambda: make_suffix_prefill_fn(cfg, patch, pool),
                "embed": lambda: EmbedProgram(cfg, patch, pool),
                "chunk": lambda: make_prefill_chunk_fn(cfg, pool),
                "paged_chunk": lambda: make_paged_prefill_chunk_fn(cfg, pool),
                "last": lambda: make_prefill_last_fn(cfg, self._prefix_len, pool),
                "insert": lambda: RowInsertProgram(pool),
                "block_insert": lambda: make_block_insert_fn(
                    self.kv_block_size, -(-bucket // self.kv_block_size), pool),
            }[kind]
            self._admission[key] = make()
        program = self._admission[key]
        return program.plain if self.mesh is not None else program

    def _suffix_len(self, req: Request) -> int:
        """Tokens the admission prefill must compute (the whole prompt
        without prefix caching; the per-request suffix with it, which in
        paged mode includes the prefix's sub-block remainder)."""
        return len(req.input_ids) - self._prefix_len

    def _check_prefix(self, req: Request) -> Optional[str]:
        """None if the request is admissible under prefix caching, else a
        rejection message."""
        if self._prefix_ids is None:
            return None
        ids = np.asarray(req.input_ids)
        p = self._prefix_match_len
        if len(ids) <= p or not np.array_equal(ids[:p], self._prefix_ids):
            return (
                f"prompt must start with the {p}-token shared prefix and carry "
                "at least one suffix token (prefix-caching server)"
            )
        return None

    def _prefix_tensor(self) -> torch.Tensor:
        return self._tensor(self._prefix_ids[None, : self._prefix_len], torch.int64)

    def _ensure_prefix_cache(self) -> None:
        """Run the one-time b=1 prefix prefills: the target's for dense
        prefix caching (the paged prefix lives in shared pool blocks), and
        the draft's, whose cache is dense in both modes, over the
        block-aligned head (the sub-block remainder rides each suffix)."""
        if self._prefix_ids is None:
            return
        if not self.paged and self._prefix_cache is None:
            self._prefix_cache = prefix_cache(self.cfg, self.params, self._prefix_tensor())
        if self.draft_cfg is not None and self._d_prefix_cache is None:
            self._d_prefix_cache = prefix_cache(
                self.draft_cfg, self.draft_params, self._prefix_tensor()
            )

    def _seeded_admission_cache(self, total: int, draft: bool = False) -> Params:
        """Admission cache of length `total` with the prefix KV (the
        target's, or with `draft` the draft's) copied into every row
        (cache index = prefix length). The target's is made and seeded once
        per length, as the reference jits its seeding once per length
        (llark_tpu/inference/server.py:635-668): suffix prefills write from
        the prefix length on, so the prefix stays. The draft's, eager, is
        made anew at every admission."""
        if total > self.max_cache_len:
            raise ValueError(
                f"prefix ({self._prefix_len}) + bucket ({total - self._prefix_len}) "
                f"exceeds max_cache_len {self.max_cache_len}"
            )
        if not draft and total in self._admit_caches:
            return self._admit_caches[total]
        cfg = self.draft_cfg if draft else self.cfg
        prefix = self._d_prefix_cache if draft else self._prefix_cache
        cache = init_kv_cache(cfg, self.admit_batch, total, device=self.device)
        for key in CACHE_TENSORS:
            if key in cache:
                p = prefix[key]  # [L, 1, Hkv, P(, D)]
                cache[key][:, :, :, : p.shape[3]] = p
        cache["index"] = self._prefix_len
        if not draft:
            self._admit_caches[total] = cache
        return cache

    def _admission_cache(self, total: int) -> Params:
        """The dense admission cache of `total` positions, made at the
        first admission that needs it and rewritten in place by every later
        one: its programs are bound to it. What an earlier group left past
        a row's live length is never read."""
        if total not in self._admit_caches:
            self._admit_caches[total] = init_kv_cache(self.cfg, self.admit_batch, total,
                                                      device=self.device)
        return self._admit_caches[total]

    def _ensure_pool_cache(self) -> None:
        """Build the paged persistent cache (block pool + tables) once."""
        if self._cache is None:
            self._cache = init_paged_kv_cache(
                self.cfg, self.max_batch, self.kv_pool_blocks, self.kv_block_size,
                self._max_blocks, device=self.device,
            )

    def _pool_view(self, tables: np.ndarray) -> Params:
        """A cache dict over the persistent pool tensors with the given
        (admission-span) block tables: chunks written through it land in
        the pool that decode rounds read. The tables are copied into the
        device tensor of their shape, made once: the admission programs are
        bound to it."""
        view = {key: self._cache[key] for key in CACHE_TENSORS if key in self._cache}
        view["index"] = 0
        shape = tuple(np.shape(tables))
        if shape not in self._admit_tables:
            self._admit_tables[shape] = torch.empty(shape, dtype=torch.int32, device=self.device)
        view["block_tables"] = self._admit_tables[shape]
        view["block_tables"].copy_(torch.from_numpy(np.ascontiguousarray(tables, np.int32)))
        return view

    def _ensure_paged_prefix(self) -> None:
        """Fill the shared-prefix pool blocks once (paged prefix caching):
        allocate blocks for the block-aligned prefix head, run ONE
        direct-to-pool chunk forward over its embeddings and pin the block
        ids for every admission table."""
        if not self.paged or self._prefix_ids is None or self._shared_block_ids is not None:
            return
        self._ensure_pool_cache()
        n_shared = self._prefix_len // self.kv_block_size
        blocks = self._allocator.alloc(n_shared)
        if blocks is None:
            raise RuntimeError(
                f"pool of {self.kv_pool_blocks} blocks cannot hold the "
                f"{n_shared}-block shared prefix"
            )
        # if the forward raises after the alloc, return the blocks, so a
        # retrying driver does not leak n_shared blocks per attempt
        try:
            embeds = embed_tokens(self.cfg, self.params, self._prefix_tensor())
            paged_prefill_chunk(
                self.cfg, self.params, embeds,
                torch.full((1,), self._prefix_len, dtype=torch.int32, device=self.device),
                self._pool_view(np.asarray(blocks, np.int32)[None, :]), 0,
            )
        except Exception:
            self._allocator.free(blocks)
            raise
        self._shared_block_ids = blocks

    def _headroom(self) -> int:
        """Cache positions a live row may write past its stop point before
        the host truncates it (serve()'s capacity check and the paged block
        budget): a fused draft pass can run a whole pass past it and its
        windows reach gamma beyond; a host round absorbs every round, but
        its window reaches gamma + 1 past the last emitted position."""
        if self.draft_cfg is not None:
            return 2 * self.spec_rounds * (self.gamma + 1) + self.gamma + 1
        if self.spec_mode is not None:
            return 2 * (self.gamma + 1)
        return self.decode_chunk

    def _block_budget(self, suffix_len: int, bucket: int) -> int:
        """PRIVATE physical blocks a request needs for its whole lifetime:
        the admission covers the full bucket span; decode then writes up to
        max_new + headroom past the prompt. With paged prefix caching the
        span starts at the block-aligned shared-prefix boundary."""
        span = max(bucket, suffix_len + self.gen_cfg.max_new_tokens + self._headroom())
        cap = self.max_cache_len - self._prefix_len
        return -(-min(span, cap) // self.kv_block_size)

    @torch.inference_mode()
    def _refresh_tables(self) -> None:
        """Copy the host tables into the cache's table tensor, in place: the
        decode programs read the tensor they were captured on."""
        if self.paged and self._tables_dirty and self._cache is not None:
            self._cache["block_tables"].copy_(torch.from_numpy(self._host_tables))
            self._tables_dirty = False

    def _bucket(self, n: int) -> int:
        for b in self.prompt_buckets:
            if n <= b:
                return b
        raise ValueError(
            f"prompt length {n} exceeds the largest bucket {self.prompt_buckets[-1]}"
        )

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._slot_req) if r is None]

    def _active(self) -> List[int]:
        return [i for i, r in enumerate(self._slot_req) if r is not None]

    def _admit_ready(self) -> bool:
        """Admission hysteresis: True when an admission wave should fire
        now. Always when nothing is decoding (waiting would idle the card)
        or when enough requests queued to fill the wave; otherwise once the
        oldest queued request has waited admit_max_wait_s."""
        if self.admit_min_fill <= 1 or not self._active():
            return True
        want = min(self.admit_min_fill, self.admit_batch, len(self._free_slots()))
        if len(self._queue) >= want:
            return True
        oldest = min(r.submitted_at for r in self._queue)
        return self._agree((time.time() - oldest) >= self.admit_max_wait_s)

    def _agree(self, decision: bool) -> bool:
        """A wall-clock decision: on a mesh, rank 0's, broadcast to every
        rank (ranks that decided on their own clocks would run different
        programs and hang in a collective)."""
        if self.mesh is None:
            return decision
        from llark_tpu_torch.parallel import comm

        return bool(comm.broadcast_object(bool(decision), src=0, group=comm.world()))

    def _select_admit_group(self, width: int):
        """(bucket, members) for this admission wave, members FIFO-ordered.

        Default (strict FIFO): the head request's bucket, consecutive
        same-bucket head-of-queue members only. admit_reorder: the LARGEST
        queued same-bucket group wins (ties: the group whose first member is
        oldest), unless the head request has waited admit_reorder_age_s,
        which forces its bucket. Requests that fail the prefix check or fit
        no bucket are skipped here and fail when they reach the head."""
        q = self._queue
        if (self.admit_reorder and len(q) > 1
                and self._agree((time.time() - q[0].submitted_at) < self.admit_reorder_age_s)):
            groups: Dict[int, List[Request]] = {}
            for r in q:
                if self._check_prefix(r) is not None:
                    continue
                try:
                    groups.setdefault(self._bucket(self._suffix_len(r)), []).append(r)
                except ValueError:
                    continue  # oversize: fails at the head, not here
            if groups:
                bucket, members = max(
                    groups.items(),
                    key=lambda kv: (min(len(kv[1]), width), -kv[1][0].submitted_at),
                )
                return bucket, members[:width]
        bucket = self._bucket(self._suffix_len(q[0]))
        members: List[Request] = []
        for r in q:
            if (len(members) >= width or self._check_prefix(r) is not None
                    or self._bucket(self._suffix_len(r)) != bucket):
                break
            members.append(r)
        return bucket, members

    def _admit(self) -> None:
        """Prefill queued requests into free slots. Same-bucket requests are
        prefilled together in ONE batched forward (a burst of k arrivals
        costs one prefill, not k); see _select_admit_group for the order.
        With a draft model its dense cache is prefilled alongside (one-shot,
        or over the seeded prefix) and spliced into the same slots."""
        self._ensure_prefix_cache()
        self._ensure_paged_prefix()
        while self._queue and self._free_slots() and self._admit_ready():
            # prefix-caching servers reject prompts that don't open with the
            # shared prefix (fail the request, not the batch)
            while self._queue:
                err = self._check_prefix(self._queue[0])
                if err is None:
                    break
                req = self._queue.pop(0)
                req.error = err
                req.done = True
                req.finished_at = time.time()
            if not self._queue:
                break
            slots = self._free_slots()
            head_bucket, candidates = self._select_admit_group(
                min(len(slots), self.admit_batch)
            )
            group: List[Request] = []
            pending_blocks: List[List[int]] = []
            for req in candidates:
                if self.paged:
                    # admission is gated by pool capacity, not just free
                    # slots: a request that can't get its blocks waits in
                    # the queue until retirements free some
                    blocks = self._allocator.alloc(
                        self._block_budget(self._suffix_len(req), head_bucket)
                    )
                    if blocks is None:
                        break
                    pending_blocks.append(blocks)
                group.append(req)
            if not group:
                break  # pool exhausted: decode on, admit after retirements
            admitted = set(map(id, group))
            self._queue = [r for r in self._queue if id(r) not in admitted]
            # everything that can raise runs before any block is committed
            # to a slot: on failure the allocated blocks go back to the pool
            try:
                # fixed admission batch (pad with plen=1 dummies)
                k = self.admit_batch
                ids = np.zeros((k, head_bucket), np.int32)
                plens = np.ones((k,), np.int32)
                audio = np.zeros((k, self.max_audio_frames, self.cfg.mm_hidden_size), np.float32)
                fcnt = np.zeros((k,), np.int32)
                for j, req in enumerate(group):
                    row = np.asarray(req.input_ids, np.int32)[self._prefix_len:]
                    ids[j, : len(row)] = row
                    plens[j] = len(row)
                    if req.audio_encoding is not None:
                        t = min(req.audio_encoding.shape[0], self.max_audio_frames)
                        audio[j, :t] = req.audio_encoding[:t]
                        fcnt[j] = t
                t_ids, t_plens = self._tensor(ids, torch.int64), self._tensor(plens, torch.int32)
                t_audio, t_fcnt = self._tensor(audio, torch.float32), self._tensor(fcnt, torch.int32)
                if self._prefix_ids is not None and not self.paged:
                    logits, new_cache = self._program("suffix", head_bucket)(
                        self.params, t_ids, t_plens, t_audio, t_fcnt,
                        self._seeded_admission_cache(self._prefix_len + head_bucket),
                    )
                elif self.prefill_chunk is not None:
                    admit_tables = None
                    if self.paged:
                        # direct-to-pool prefill: each admitted row's block
                        # span (pad rows -> their own parking block); with
                        # paged prefix caching every row's table leads with
                        # the shared-prefix blocks
                        self._ensure_pool_cache()
                        n_shared = self._prefix_len // self.kv_block_size
                        span = n_shared + head_bucket // self.kv_block_size
                        admit_tables = np.empty((k, span), np.int32)
                        for j in range(k):
                            if j < len(group):
                                if n_shared:
                                    admit_tables[j, :n_shared] = self._shared_block_ids
                                admit_tables[j, n_shared:] = pending_blocks[j][: span - n_shared]
                            else:
                                admit_tables[j, :] = j  # parking block
                    logits, new_cache = self._chunked_prefill(
                        t_ids, t_plens, t_audio, t_fcnt, admit_tables
                    )
                else:
                    logits, new_cache = self._program("prefill", head_bucket)(
                        self.params, t_ids, t_plens, t_audio, t_fcnt,
                        self._admission_cache(head_bucket),
                    )
                firsts = _sample(logits, self.gen_cfg, self._rng).cpu().numpy()
                if self.draft_cfg is not None:
                    if self._prefix_ids is not None:
                        _, d_new_cache = suffix_prefill(
                            self.draft_cfg, self.draft_params, t_ids, t_plens, t_audio, t_fcnt,
                            self.audio_patch_id,
                            self._seeded_admission_cache(self._prefix_len + head_bucket, True),
                        )
                    else:
                        _, d_new_cache = prefill(
                            self.draft_cfg, self.draft_params, t_ids, t_plens, t_audio, t_fcnt,
                            self.audio_patch_id, head_bucket,
                        )
                    if self._d_cache is None:
                        self._d_cache = init_kv_cache(
                            self.draft_cfg, self.max_batch, self.max_cache_len, device=self.device
                        )
                if self._cache is None:
                    if self.paged:
                        self._ensure_pool_cache()
                    else:
                        # the persistent batched cache is FULL max_cache_len
                        # even though admission caches are bucket-sized
                        self._cache = init_kv_cache(
                            self.cfg, self.max_batch, self.max_cache_len, device=self.device
                        )
            except Exception:
                for blocks in pending_blocks:
                    self._allocator.free(blocks)
                raise
            now = time.time()
            bucket_blocks = -(-head_bucket // self.kv_block_size) if self.paged else 0
            for j, req in enumerate(group):
                slot = slots[j]
                if self.paged:
                    blocks = pending_blocks[j]
                    self._slot_blocks[slot] = blocks  # private only: shared-
                    # prefix blocks are pool-wide and never freed
                    ns = self._prefix_len // self.kv_block_size
                    self._host_tables[slot, :] = slot  # parking default
                    if ns:
                        self._host_tables[slot, :ns] = self._shared_block_ids
                    self._host_tables[slot, ns : ns + len(blocks)] = blocks
                    self._tables_dirty = True
                    if new_cache is not None:
                        # direct-to-pool admission leaves new_cache None: the
                        # K/V already sit in this row's blocks
                        self._program("block_insert", head_bucket)(
                            self._cache, new_cache, j, blocks[:bucket_blocks])
                else:
                    self._program("insert", head_bucket)(self._cache, new_cache, j, slot)
                if self.draft_cfg is not None:
                    insert_row(self._d_cache, d_new_cache, j, slot)  # eager
                    self._prev_tok[slot] = int(ids[j, plens[j] - 1])
                req.first_token_at = now
                self._slot_req[slot] = req
                self._write_pos[slot] = self._prefix_len + plens[j]
                self._tokens_in_flight[slot] = int(firsts[j])
                if self._absorb(slot, int(firsts[j])):  # may already be EOS
                    self._finish(slot)

    def _chunked_prefill(self, ids, plens, audio, fcnt, admit_tables=None):
        """Prefill one admission group in `prefill_chunk`-token chunks,
        running a decode round for the live slots between chunks. With a
        bf16 cache this is token-identical to one-shot prefill (attention
        windows depend only on positions); with an int8 cache, chunks after
        the first attend the quantized history while one-shot prefill
        attends full-precision in-flight K/V, so outputs agree only within
        quantization noise.

        The bucket is padded up to a chunk multiple; the pad region writes
        masked-then-overwritten cache slots, the same invariant padded
        one-shot prefill relies on."""
        k, bucket = ids.shape
        embeds = self._program("embed", bucket)(self.params, ids, audio, fcnt)
        pad = (-bucket) % self.prefill_chunk
        if self._prefix_len + bucket + pad > self.max_cache_len:
            raise ValueError(
                f"bucket {bucket} padded to {bucket + pad} (after a {self._prefix_len}-"
                f"token cached prefix) exceeds max_cache_len {self.max_cache_len}; pick "
                "a prefill_chunk that divides the bucket or enlarge the cache"
            )
        padded = torch.nn.functional.pad(embeds, (0, 0, 0, pad)) if pad else embeds
        chunks = range(0, bucket + pad, self.prefill_chunk)
        if admit_tables is not None:
            # paged direct-to-pool prefill: each chunk writes its K/V
            # straight into the admitted rows' pool blocks -- no bucket-
            # sized admission cache and no block insert. With paged prefix
            # caching the embeds hold only suffixes, whose absolute
            # positions start at the block-aligned cached-prefix length.
            if self.prefill_chunk % self.kv_block_size:
                raise ValueError(
                    f"paged chunked prefill needs prefill_chunk ({self.prefill_chunk}) "
                    f"to be a multiple of kv_block_size ({self.kv_block_size})"
                )
            view = self._pool_view(admit_tables)
            base = self._prefix_len
            chunk, lengths = self._program("paged_chunk", bucket), plens + base
            for c in chunks:
                chunk(self.params, padded[:, c : c + self.prefill_chunk], lengths, view, base + c)
                if c + self.prefill_chunk < bucket + pad:
                    self._decode_round()  # live slots keep emitting mid-prefill
            logits, _ = self._program("last", bucket)(self.params, embeds, plens, view)
            return logits, None
        # bucket-sized admission cache: the row copy into the persistent
        # cache only reads the prompt positions
        cache = dict(self._admission_cache(bucket + pad), index=0)
        chunk = self._program("chunk", bucket)
        for c in chunks:
            cache = chunk(self.params, padded[:, c : c + self.prefill_chunk], plens, cache)
            if c + self.prefill_chunk < bucket + pad:
                self._decode_round()
        return self._program("last", bucket)(self.params, embeds, plens, cache)

    def _absorb(self, slot: int, t: int) -> bool:
        """Mirror of Generator.generate's per-token absorb: EOS tokens are
        dropped and stop the row; appended tokens check stop_text against
        an 8-token decoded tail only. True when the row is finished."""
        req = self._slot_req[slot]
        gen = self.gen_cfg
        if gen.eos_token_id is not None and t == gen.eos_token_id:
            return True
        req.tokens.append(t)
        if gen.stop_text and self.tokenizer is not None:
            if gen.stop_text in self.tokenizer.decode(req.tokens[-8:]):
                return True
        limit = gen.max_new_tokens
        if req.max_new_tokens is not None:
            limit = min(max(1, req.max_new_tokens), limit)
        return len(req.tokens) >= limit

    def _finish(self, slot: int) -> None:
        req = self._slot_req[slot]
        if self.gen_cfg.stop_text and self.tokenizer is not None:
            req.tokens = Generator._trim_stop(req.tokens, self.tokenizer, self.gen_cfg.stop_text)
        req.done = True
        req.finished_at = time.time()
        self._slot_req[slot] = None
        self._release_blocks(slot)

    def _release_blocks(self, slot: int) -> None:
        """Return a retired or aborted row's PRIVATE pool blocks and repoint
        its whole table at its parking block, so parked writes can never
        land in a block a future request owns. Shared-prefix blocks are
        pool-wide and never freed."""
        if self.paged and self._slot_blocks[slot]:
            self._allocator.free(self._slot_blocks[slot])
            self._slot_blocks[slot] = []
            self._host_tables[slot, :] = slot
            self._tables_dirty = True

    def _decode_round(self) -> None:
        """One chunked decode over all slots (inactive rows write to the
        last `decode_chunk` cache positions, which live rows never attend:
        serve() caps prompt + max_new at max_cache_len - decode_chunk); a
        speculative round instead where speculation is on."""
        if self.draft_cfg is not None:
            return self._spec_round()
        if self.spec_mode is not None:
            return self._hostspec_round()
        active = self._active()
        if not active:
            return
        self._refresh_tables()
        chunk = self.decode_chunk
        if self.decode_chunk_drain is not None and len(active) <= self.drain_max_active:
            chunk = self.decode_chunk_drain
        token = np.zeros((self.max_batch,), np.int64)
        pos = np.full((self.max_batch,), self.max_cache_len - self.decode_chunk, np.int32)
        for i in active:
            token[i] = self._tokens_in_flight[i]
            pos[i] = self._write_pos[i]
        token, pos = self._tensor(token, torch.int64), self._tensor(pos, torch.int64)
        if self.mesh is not None:
            toks, _, self._cache = decode_n(
                self.cfg, self.gen_cfg, self.params, token, self._cache, pos, chunk, self._rng,
            )
        else:
            if chunk not in self._programs:
                self._programs[chunk] = make_multistep_decode_fn(
                    self.cfg, self.gen_cfg, chunk, self._pool)
            toks, _, self._cache = self._programs[chunk](
                self.params, token, self._cache, pos, self._rng)
        toks = toks.cpu().numpy()  # [B, chunk]: the round's only host read
        for i in active:
            for j in range(chunk):
                if self._absorb(i, int(toks[i, j])):
                    self._finish(i)
                    break
            else:
                # row still live: the cache holds all chunk tokens
                self._write_pos[i] += chunk
                self._tokens_in_flight[i] = int(toks[i, -1])

    def _hostspec_round(self) -> None:
        """One draft-free speculative round (llark_tpu/inference/
        server.py:1236-1284): host proposals verified by ONE target forward
        over every slot's [last, d_1..d_gamma] window; 1..gamma+1 tokens per
        live slot, one host read."""
        active = self._active()
        if not active:
            return
        self._refresh_tables()
        g = self.gamma
        tokens_in = np.zeros((self.max_batch, g + 1), np.int64)
        proposals = np.zeros((self.max_batch, g), np.int64)
        # parked rows write into the never-attended tail region
        pos = np.full((self.max_batch,), self.max_cache_len - (g + 1), np.int32)
        for i in active:
            req = self._slot_req[i]
            hist = list(map(int, req.input_ids)) + req.tokens
            proposals[i] = np.asarray(self.spec_proposer(hist, g), np.int64)
            tokens_in[i, 0] = self._tokens_in_flight[i]
            tokens_in[i, 1:] = proposals[i]
            pos[i] = self._write_pos[i]
        target, n_emit, self._cache = verify(
            self.cfg, self.gen_cfg, self.params, self._tensor(tokens_in, torch.int64),
            self._tensor(proposals, torch.int64), self._cache, self._tensor(pos, torch.int32),
            self._rng,
        )
        target, n_emit = target.cpu().numpy(), n_emit.cpu().numpy()  # the round's only read
        for i in active:
            n = int(n_emit[i])
            if self.spec_force_accept is not None:
                n = 1
                while n <= g and self._force_rng.random_sample() < self.spec_force_accept:
                    n += 1
            self.spec_accepted += n - 1
            self.spec_proposed += g
            for j in range(n):
                if self._absorb(i, int(target[i, j])):
                    self._finish(i)
                    break
            else:
                self._write_pos[i] += n
                self._tokens_in_flight[i] = int(target[i, n - 1])

    def _spec_round(self) -> None:
        """One fused speculative pass over all slots (llark_tpu/inference/
        server.py:1286-1360): spec_rounds propose -> verify -> accept ->
        advance rounds enqueued back to back, one host read at the end.
        Inactive rows park near the cache tail; the fused rounds' position
        clamp keeps their draft and target writes in bounds."""
        active = self._active()
        if not active:
            return
        self._refresh_tables()
        prev = np.zeros((self.max_batch,), np.int64)
        last = np.zeros((self.max_batch,), np.int64)
        pos = np.full((self.max_batch,), self._spec_max_pos - self.spec_rounds * (self.gamma + 1),
                      np.int64)
        for i in active:
            prev[i] = self._prev_tok[i]
            last[i] = self._tokens_in_flight[i]
            pos[i] = self._write_pos[i]
        toks, n_emit, self._cache, self._d_cache, prev_o, last_o, pos_o = self._spec(
            self.params, self.draft_params, self._cache, self._d_cache,
            self._tensor(prev, torch.int64), self._tensor(last, torch.int64),
            self._tensor(pos, torch.int64), self._rng,
        )
        # one read of all five outputs
        toks, n_emit, prev_o, last_o, pos_o = (
            t.cpu().numpy() for t in (toks, n_emit, prev_o, last_o, pos_o)
        )
        for i in active:
            finished = False
            for r in range(self.spec_rounds):
                for j in range(int(n_emit[i, r])):
                    if self._absorb(i, int(toks[i, r, j])):
                        self._finish(i)
                        finished = True
                        break
                if finished:
                    break
            if not finished:
                self._write_pos[i] = int(pos_o[i])
                self._prev_tok[i] = int(prev_o[i])
                self._tokens_in_flight[i] = int(last_o[i])

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def serve(self, requests: List[Request]) -> List[Request]:
        """Run all requests to completion with continuous batching; returns
        the same list with tokens and timestamps filled."""
        if self.driver is not None:
            raise RuntimeError(
                "server is driven by an online engine; submit through it instead "
                "of serve() (concurrent drivers race over the KV cache)"
            )
        now = time.time()
        cap = min(
            self.max_cache_len - self.gen_cfg.max_new_tokens - self._headroom(),
            self._prefix_len + self.prompt_buckets[-1],
        )
        for r in requests:
            r.submitted_at = now
            if len(r.input_ids) > cap:
                raise ValueError(
                    f"prompt {len(r.input_ids)} exceeds capacity {cap} (cache "
                    f"{self.max_cache_len}, largest bucket {self.prompt_buckets[-1]})"
                )
            err = self._check_prefix(r)
            if err is not None:
                raise ValueError(err)
        self._queue.extend(requests)
        while self._queue or self._active():
            self._admit()
            self._decode_round()
        return requests

    def stats(self, requests: List[Request]) -> Dict[str, Any]:
        lat = [r.finished_at - r.submitted_at for r in requests if r.finished_at]
        ttft = [r.first_token_at - r.submitted_at for r in requests if r.first_token_at]
        toks = sum(len(r.tokens) for r in requests)
        wall = max((r.finished_at or 0.0) for r in requests) - min(
            r.submitted_at for r in requests
        )
        out = {
            "requests": len(requests),
            "tokens": toks,
            "tokens_per_sec": toks / wall if wall > 0 else float("nan"),
            "mean_latency_s": float(np.mean(lat)) if lat else float("nan"),
            "mean_ttft_s": float(np.mean(ttft)) if ttft else float("nan"),
        }
        if self.spec_proposed:
            out["spec_acceptance"] = round(self.spec_accepted / self.spec_proposed, 3)
        return out
