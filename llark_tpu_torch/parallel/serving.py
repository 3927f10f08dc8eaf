"""Mesh-sharded serving: tensor-parallel prefill and decode (counterpart of
llark_tpu/parallel/serving.py).

  * weights: Megatron column/row parallel over "tensor" and ZeRO over
    "fsdp" (the training specs, `parallel/mesh.py`; int8 and int4 trees
    adapted); the decoder sums over "tensor" after wo / w_down and gathers
    the logits, so every rank of a row samples the same token;
  * KV cache [L, B/(d*f), Hkv/t, S, D] on each rank (`kv_cache_spec`):
    rows over ("data", "fsdp"), heads over "tensor", the int8 scales alike,
    so cache capacity grows with the mesh;
  * batch: each rank prefills and decodes its rows; the ranks agree each
    chunk on whether every row of the batch is done (FSDP's weight gathers
    keep them in step), and the rows are gathered to every rank at the end.

The kernels run on each rank's shapes: the flash prefill over its local
heads, the flash decode over its cache, the int8/int4 products over its
weight shards. `ShardedGenerator` has the surface of
`llark_tpu_torch.generate.Generator`.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.generate import GenerationConfig, Generator, decode_n
from llark_tpu_torch.parallel import comm
from llark_tpu_torch.parallel.mesh import AXES, P, batch_shard_index, batch_sharding, shard_model


def kv_cache_spec(cfg: Optional[ModelConfig] = None) -> dict:
    """Specs of the [L, B, Hkv, S, D] cache (plus the [L, B, Hkv, S] scales
    when cfg.kv_cache_quant)."""
    kv = P(None, AXES.batch, AXES.tensor, None, None)
    spec = {"k": kv, "v": kv, "index": P()}
    if cfg is not None and cfg.kv_cache_quant:
        sc = P(None, AXES.batch, AXES.tensor, None)
        spec.update({"k_scale": sc, "v_scale": sc})
    return spec


class _RankGenerator(Generator):
    """The Generator a rank runs on its rows and shards: it stops only when
    every batch shard is done."""

    def _finished(self, done: np.ndarray) -> bool:
        left = torch.tensor([0 if done.all() else 1], dtype=torch.int64, device=self.device)
        return int(self.cfg.shard.batch_sum(left)) == 0

    def _prefill_fn(self, b, s, t):
        # eager, as the decode chunks below
        return super()._prefill_fn(b, s, t).plain

    def _decode_chunk(self, token, cache, positions, n, rng):
        # eager: the chunk's collectives may go through gloo's host staging,
        # which a CUDA graph cannot hold
        return decode_n(self.cfg, self.gen_cfg, self.params, token, cache, positions, n, rng)


class ShardedGenerator:
    """Tensor/data-parallel Generator over a mesh (`parallel/mesh.py`
    make_mesh). Every rank builds it from the same full params and calls
    generate() with the same inputs; each gets every row's tokens."""

    def __init__(
        self,
        mesh,
        cfg: ModelConfig,
        params,
        audio_patch_id: int,
        gen_cfg: Optional[GenerationConfig] = None,
        max_cache_len: int = 2048,
        device: Union[str, torch.device] = "cuda",
    ):
        self.mesh = mesh
        self.cfg = cfg
        self.local_cfg, self.params = shard_model(mesh, cfg, params)
        self._gen = _RankGenerator(self.local_cfg, self.params, audio_patch_id, gen_cfg,
                                   max_cache_len, device)
        self.gen_cfg = self._gen.gen_cfg
        self.audio_patch_id = audio_patch_id
        self.max_cache_len = max_cache_len

    def prefill(self, input_ids, prompt_lengths, audio_encodings=None, audio_frame_counts=None):
        """This rank's rows: (next-token logits [B/(d*f), V], its cache)."""
        rows = batch_sharding(self.mesh)
        local = [None if a is None else rows(np.asarray(a))
                 for a in (input_ids, prompt_lengths, audio_encodings, audio_frame_counts)]
        return self._gen.prefill(*local)

    def generate(
        self,
        input_ids: np.ndarray,
        prompt_lengths: np.ndarray,
        audio_encodings: Optional[np.ndarray] = None,
        audio_frame_counts: Optional[np.ndarray] = None,
        tokenizer=None,
        rng: Optional[torch.Generator] = None,
    ) -> List[List[int]]:
        """Per-row token lists of the whole batch (every rank gets them).
        The batch must split over the batch shards (data x fsdp). Sampling
        draws from `rng` (default: seeded 0), the same seed on every rank."""
        rows = batch_sharding(self.mesh)
        b = np.shape(input_ids)[0]
        if audio_encodings is None:
            audio_encodings = np.zeros((b, 1, self.cfg.mm_hidden_size), np.float32)
            audio_frame_counts = np.zeros((b,), np.int32)
        if audio_frame_counts is None:
            audio_frame_counts = np.full((b,), np.shape(audio_encodings)[1], np.int32)
        out = self._gen.generate(
            rows(np.asarray(input_ids)), rows(np.asarray(prompt_lengths)),
            rows(np.asarray(audio_encodings)), rows(np.asarray(audio_frame_counts)),
            tokenizer=tokenizer, rng=rng,
        )
        index, count = batch_shard_index(self.mesh)
        if count == 1:
            return out
        shards = dict(comm.all_gather_object((index, out), comm.world()))
        return [row for i in range(count) for row in shards[i]]
