#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (llark_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py             # every phase
    python3 chip_smoke.py --phase 23  # one phase alone: 17 (checkpoint I/O),
                                      # 20 (the CLAP path), 21 (Jukebox),
                                      # 22 (Mixture-of-Experts) or 23 (native
                                      # I/O, annotation and preprocessing)

Phases, in order; any failure exits non-zero before the final line:
  1. the card's name and power limit; build every CUDA kernel from
     llark_tpu_torch/csrc/ (nvcc, one process per source, in parallel);
     the device time of the two quantized products at the reported shape
     by kernel (one kernel each);
  2. flash-prefill kernel vs its plain PyTorch version (bf16, seeded), at
     the shape batch_infer gives it (batch 1) and at batch 4, held per
     query row: |kernel - plain| / |plain| over the head dim (L2);
  3. flash-decode kernel vs its plain PyTorch version, likewise;
  4. the serving path at full Llama-2-7B width (32 layers, random bf16
     weights made on the card from a seed): 4 requests through
     `batch_infer`, greedy, 32 new tokens each, with both kernels' launch
     counts read around that run; then the same requests with the plain
     attention path, comparing prefill logits and greedy tokens, and a
     torch.profiler split of one request's first 8 tokens into device and
     idle time;
  5. per-kernel timings at batch 1, the shape batch_infer gives the
     kernels and the one the {"kernels": ...} line reports, and at batch 4
     (printed only): medians of CUDA-event device
     times, L2 flushed before each launch) beside the plain version, PyTorch's
     scaled_dot_product_attention as the library yardstick, and the bound
     from bytes and FLOPs at 3.35 TB/s and 989 TFLOP/s (H100 SXM, bf16);
     the flash-prefill kernel also at one-shot admission's [8,32,512,128]
     (printed); the flash-decode kernel's host enqueue time a call;
  6. (A) the flash-decode kernel in every cache mode against its plain
     version at 7B serving shapes: q [8,32,1,128], 2048-position caches,
     live lengths 300-340; dense bf16, dense int8, paged bf16 with 16- and
     128-token blocks, paged int8 with 128-token blocks, Sq=5 with GQA
     Hkv=8 and ALiBi; paged tables scattered over the pool; and the
     flash-prefill kernel at the serving engine's one-shot admission shape,
     q [8,32,512,128] causal with the admitted prompts' lengths (and a wave
     padded with one-token rows); each held per query row;
  7. (B) the serving engine (`BatchedServer`) at full Llama-2-7B width (32
     layers, random bf16 weights from the seed): 16 requests (the four
     prompts of requests() four times, random [256, 4800] encodings),
     greedy, 32 new tokens, 8 slots, cache 2048, decode_chunk 8, in four
     modes: (a) the run of record, paged 128-token blocks + int8 KV +
     prefill_chunk 256; (b) dense bf16, one-shot admission; (c) paged bf16,
     16-token blocks, prefill_chunk 256, prefix caching; (d) dense int8,
     one-shot admission. Each mode: wall time, tokens/s, mean TTFT, the
     flash-decode launches by cache mode (all in its own), the
     flash-prefill launches (one-shot admission runs it: (b) and (d)),
     peak memory, and a decode round's device idle share and the
     flash-decode kernel's part of its device time (torch.profiler);
     one decode step from an admitted state through the kernel route and
     the plain route, logits within LOGITS_TOL;
  8. the training kernels against their plain versions at the training
     path's shape ([2, 32, 1024, 128] bf16, causal, kv_lengths [1024, 700])
     and with GQA + ALiBi and head_dim 64: the forward's log-sum-exp and
     the flash backward's dq, dk and dv (one call: delta, the products,
     dq's rounding); then every kernel on fp32 inputs against its fp32
     plain version, each launch counted: K1 with and without its
     log-sum-exp and K3+K4 at the training shape and at head_dim 64 with
     GQA + ALiBi, K2 with an fp32 or int8 cache, dense or paged, and K5 / K6
     at M = 1, 9, 17, 65, 2048 (one per switch of their tiles);
  9. one training step's loss and projector gradient at 7B width, 2 layers,
     through the flash kernels and through the plain attention path (2
     flash backward launches);
 10. the adapter stage at Llama-2-7B width, 8 layers (ADAPTER_LAYERS,
     cut from 32 for the time limit; fp32 parameters, frozen backbone, remat) through `train()` on shards written to a temp
     dir: batch 2 x 2 accumulation steps, 1024 tokens, 256 x 4800 audio
     frames; the loss must fall;
 11. the run-of-record flags (the whole model trains) at 7B width, 2
     layers (FULL_LAYERS), likewise; for both: median step ms, tokens/s, MFU, peak
     memory, launches of the flash forward and backward per step (the
     backward exactly one per layer per micro-batch: 64 in the adapter
     stage) and the card's idle share in a torch.profiler trace of one step;
 12. the training kernels' timings at the phase-8 shape beside their plain
     versions and PyTorch's scaled_dot_product_attention (the whole
     backward, delta included, against SDPA's backward with the same mask;
     the old wrapper's PyTorch delta alone; at kv_len [1024, 1024] against
     SDPA is_causal=True as a second reference, for the backward and for
     the forward with and without its log-sum-exp); and the
     flash-decode kernel's four cache modes at the phase-6 shape beside
     their plain version (no single PyTorch call reads an int8 or paged
     cache: SDPA over a dense bf16 view is printed beside them);
 13. the two weight-only quantized products (int8, int4 with 128-row groups)
     against their plain versions, bf16, weights quantized from seeded
     randn * 0.02: (K, N) in (4096, 4096), (4096, 11008), (11008, 4096) x
     M in 1, 8, 9, 16, 17, 64, 65 (both sides of each switch of the
     kernel's tiles), 293, 384, 2048 (chunked admission, 8 x 256), 4096,
     and a ragged case (M 5, K 256, N 1000);
     each held per output row, |kernel - plain| / |plain| (L2 over N);
 14. serving from quantized weights at full Llama-2-7B width, 32 layers:
     bf16 params from the seed, quantized on the card
     (`quantize_params_int8_incremental`), then `batch_infer` (the 4 requests
     of phase 4) and `BatchedServer` in modes (a) and (b) of phase 7; then
     the same with `quantize_params_int4_incremental(layout="rows")` for
     `batch_infer` and mode (a). Gates: 224 launches (7 projections x 32
     layers) of the format's kernel around one decode step, a positive
     multiple of 224 over each run and none of the other format's; every
     request ends with 32 tokens; prefill logits and one decode step's
     logits, kernel route vs the plain products on the same quantized tree,
     within LOGITS_TOL; in mode (a) also chunked admission replayed on the
     admitted state (`paged_prefill_chunk` at [8, 256], M = 2048, 224
     launches a chunk, then `prefill_last`), its next-token logits held the
     same way. Per run: wall, tokens/s, mean TTFT, peak memory,
     parameter bytes and a decode round's device time and idle share, beside
     the bf16 figures of phases 4 and 7;
 15. the int4 cols layout (no kernel) at 7B width, 2 layers: one forward
     against the same tree dequantized to bf16 weights;
 16. timings of the two quantized products at the three (K, N) and M in 1,
     8, 384, 2048, 4096 beside their plain versions, their bounds, and two
     yardsticks that are not the same function: `torch.matmul` on a bf16
     copy of the weight, and dequantize-then-matmul; at M = 1 and 8 also
     with a clean cold L2 (`flush_l2(clean=True)`); what one quantized
     projection costs the host to enqueue; and, where the installed torch
     runs them on CUDA, `torch._weight_int8pack_mm` and
     `torch._weight_int4pack_mm` at the reported shape and at M = 2048,
     (K, N) = (4096, 4096), held against the kernels' outputs and printed
     beside the kernels' times (the kernels line's library_ms, at the
     reported shape, when they agree); `python -m
     llark_tpu_torch.tools.wq_library_times` times them at all six
     admission shapes;
 17. checkpoint I/O and the WebDataset CLI at Llama-2-7B width, 2 layers
     (CKPT_LAYERS), bf16 params from the seed: `save_hf_checkpoint` (fp32
     pytorch_model.bin + config.json), the same state dict rewritten as two
     bf16 .safetensors shards with an index by this script's own writer, and
     `load_hf_state_dict` bitwise alike from both; `load_pretrained_backbone`
     onto the card; `train()` from that directory (adapter-stage flags, 2
     steps, phase 10's shard), whose first step must see the exported
     backbone bit for bit, with a finite loss and the flash launch gates of
     phase 10; then, the run's word tokenizer given a word for each of the
     model's ids (so that no token decodes as <unk> and equal rows mean
     equal tokens), `from_webdataset.main` over a 4-row shard of [256, 4800]
     encodings with crop-window keys, one request at a time (greedy, 32 new
     tokens) and through the engine in mode (a)'s cache (8 slots, paged
     128-token blocks, int8 KV, chunks of 128, which the CLI's prompt buckets
     allow): 4 CSV rows with the example ids restored, equal to
     `batch_infer` / `batch_infer_continuous` on the loaded model in this
     process, the flash-prefill kernel once per layer per request in the
     first run, flash decode only in each run's cache mode (dense bf16, then
     paged int8); export and import seconds and GB/s and the CLI's seconds
     per request beside the card's name and power limit;
 18. LoRA and QLoRA at Llama-2-7B width (fp32 parameters, bf16 compute,
     remat; rank 64, alpha 16, dropout 0.05, 512 positions, batch 2 x 2,
     phase 10's shard), each run through `train()` (`run_lora`): (a) QLoRA
     on an int8 base, 32 layers, 4 steps; (b) on an int4 base (rows layout,
     group 128), 32 layers, 3 steps; (c) LoRA on the float base, 4 layers
     (LORA_CUT_LAYERS), 3 steps, then `merge_lora`; (d) one micro-batch under
     each remat policy ("full", "dots", "dots_narrow"), 4 layers, int8 base;
     (e) (a)'s run directory through `load_pretrained_model` ->
     `batch_infer`, factors unmerged, flash decode on. Gates: the loss
     falls; K5 (K6 in (b)) 14 times a layer a micro-batch (7 in the forward,
     7 in remat's recompute: 448 at 32 layers), the other format's never; K1
     twice and the flash backward once per
     layer per micro-batch; the base bit for bit the quantized seeded init;
     every LoRA-B moved; the adapter files written; one more step against
     every product on its plain version (loss 1e-2 absolute; the LoRA-B
     gradient 3e-2 relative to max with attention plain on both sides, so
     that it reads K5 / K6 and their dx; no kernel launches inside; the
     same step in fp32 printed beside it, the plain step's own bf16
     rounding); the dots
     policies' LoRA gradients within 1e-2 of full's, with K5 once per
     product; in (e) K1 once per layer per request, dense K2, 224 K5
     launches per decode step, one decode step's logits against the plain
     products and (c)'s merged tree's prefill logits against its unmerged
     tree's within 5e-2 relative to max, every request 32 tokens. Printed:
     step ms, tokens/s, MFU (frozen-base accounting with the LoRA term),
     peak memory, idle share and the top kernels of each run, the device
     time of the dx products read from the profiled step's trace, one
     decode step through the quantized operator and called directly, and
     each part's seconds;
 19. speculative decoding, beam search and the online HTTP engine at full
     Llama-2-7B width, 32 layers, random weights from the seed, gamma 4,
     32 new tokens, greedy (`run_speculation`): (a) an fp32 target (tf32
     off) on the 4 requests of phase 4: plain `Generator` greedy tokens and
     each step's top-2 logit margin; `SpeculativeGenerator` by n-gram, with
     the target's own tensors as draft (fused, 4 rounds) and with an
     MPT-1B-width draft (24 layers, ALiBi, the target's vocab; fused); one
     verify window [4, 5] against 5 sequential decode steps and one draft
     proposal call; `BeamSearcher` with K = 1, K = 4 (every beam's score
     against a teacher-forced log-prob of its tokens through the plain
     attention route) and K = 4 over an int8 cache, and the device split of
     one K = 4 beam step (the cache gather's part); (b) `BatchedServer`
     with bf16 weights (8 slots, cache 2048, allow_divergent_spec), 16
     requests of phase 7: n-gram in mode (a) and mode (b), the MPT-1B-width
     draft with spec_rounds 2 in mode (a), n-gram in mode (a) with
     spec_force_accept 0.8 and n-gram in mode (a) from int8 weights; each
     with a verify window from 8 admitted slots against sequential steps
     and a speculative round's device split; (c) mode (a) without
     speculation behind `OnlineEngine` + `serve_http` on 127.0.0.1: 16
     requests from 8 client threads (base64 .npy encodings), a body with
     the wrong encoding width, one more request. Gates: every stream equal
     to plain greedy up to its first step with a margin below NEAR_TIE;
     n-gram acceptance equal to `simulate_ngram_acceptance` replayed on the
     emitted tokens (`replayed_acceptance`); verify-window logits within
     WINDOW_TOL of the steps' (LOGITS_TOL from int8 weights); K2 once a layer at Sq = 5 in a verify window
     (32 launches, in the cache's mode alone), once a layer at Sq = 2 then
     at Sq = 1 in a draft call (24 launches each for the MPT draft), the
     target's launches only in its run's cache mode and the draft's only
     in dense mode; K1 once a layer per prefill; 224 K5 launches in a
     verify window from int8 weights and no K6 launch; beams K = 1 equal
     to greedy, K = 4 scores within 1e-3 relative; every request 32 tokens;
     HTTP 200 for each valid request, 400 for the malformed body, /health
     back at 8 free slots and an empty queue, `stop()` joining the engine
     thread, no request with its error set. Printed: acceptance, seconds,
     tokens/s, mean TTFT, streams equal to phase 7's plain tokens, a
     speculative round's device time and idle share beside phase 7's
     decode round, HTTP TTFT p50/p90;
 20. the CLAP path (`run_clap_path`): (a) 8 WAVs written with the port's
     `write_wav`, 16-bit PCM at 44.1 kHz (3 to 25 s, some stereo; a chord
     under noise from the seed); (b) `extract_cli clap --batch-size 8`
     through the CLI's own parser on the card: HTSAT-base at full width
     with seeded random weights, `read_wav` resampling to 48 kHz,
     rand_trunc / repeatpad to 10 s; (c) the same CLI with `--device cpu`
     (the plain path): the same file names, (1, 512) fp32, norm 1 +- 1e-5,
     and every card embedding within CLAP_TOL (1e-6) of the CPU's, the worst
     printed; then the card's run again with TF32 products, which must land
     above CLAP_TOL, so that the gate tells fp32 from TF32; (d) (b)'s run is
     profiled: its clips/s, host seconds for read + resample + prepare apart
     from its embed seconds (the `ClapRun` it returns), its device time and
     idle share; (e) a CLAP-width LLark (mm_hidden_size 512) at Llama-2-7B
     width, 4 layers, bf16 params from the seed, written as a run directory
     with a word tokenizer that names each of its ids, and
     `from_encodings.main` over the card's 8 .npy files: the CSV rows equal
     to `batch_infer` on the same encodings and params, no <unk> in them,
     K1 once per layer per request, K2 in dense bf16 alone and as often as
     in `batch_infer`; the phase's seconds;
 21. the Jukebox path (`run_jukebox_path`), each gate beside a control that
     must fail it: (a) the parity fixture's state dicts
     (tests/fixtures/jukebox_parity) through the port's importer, fp32 on
     the card: codes equal to the goldens for the full, short and stereo
     clips, pooled embeddings and the prior's activations on the goldens'
     codes within JUKEBOX_GOLD_ATOL (1e-6) and the same frame counts; the
     control runs with TF32 products; (b) full width cut to depth 3 (one
     row / column / previous-row cycle), fp32, one window of 2^20 samples,
     weights drawn on the CPU from the seed: codes on the card equal to the
     CPU plain path's except where the CPU's top-2 distance margin is under
     JUKEBOX_MARGIN_EPS (the count printed), activations on the CPU's codes
     within JUKEBOX_WIDE_TOL (1e-4) relative to max; the control, TF32
     products; the CPU's seconds and threads; (c) 8 WAVs written with
     `write_wav` (16-bit PCM, 44.1 kHz, 3 to 40 s, some stereo; two cropped at
     2^20 samples, the rest padded) through `extract_cli jukebox` on the card
     at its defaults (random full-width weights drawn on the card from the
     seed, the prior in bf16 at depth 36, batch 2, int16 upload, bf16
     readback, fps 10), profiled: each file [floor(floor(8192 n / 2^20) / 34),
     4800] fp32 and finite, a second call with --skip-existing writes
     nothing; clips/s, read + prepare seconds against the wait on the device
     (the `JukeboxRun`), device ms and idle share of the CLI's own run; one
     warm bf16 window's device time and its share of 989 TFLOP/s; (d) the
     30 s clip's codes through the same 36-layer weights in fp32: the CLI's
     bf16 file within JUKEBOX_BF16_TOL (5e-2) relative to max; the control,
     the fp32 run on the codes rolled by one; (e) phase 20 (e)'s answer half
     at mm_hidden_size 4800 over the 8 files. The weights are freed before
     (e); the parts' seconds and the phase's;
 22. Mixture-of-Experts at Mixtral-8x7B width (`run_moe_path`; hidden 4096,
     14336 intermediate, 32 query heads over 8 KV heads, 8 experts, top-2,
     rope_theta 1e6, LLark's vocab and 4800-wide projector; seeded random
     weights, a word tokenizer that names every id), each gate beside a
     control that must fail it: (a) K1 at q [1,32,384,128] over k/v
     [1,8,384,128] and K2 at q [8,32,1,128] over [8,8,2048,128] dense bf16
     and paged int8 caches, live lengths 300-340, per row against their
     plain versions (controls: the plain versions over rolled KV heads); (b)
     one layer's moe_ffn in fp32 (TF32 off) on the card and on the CPU plain
     path, the same weights (drawn on the card from the seed, copied to the
     host), tokens [2, 64, 4096],
     "switch" at capacity factor 1 (tokens drop) and "mixtral": the experts
     chosen equal but where the CPU's top-k margin is under MOE_MARGIN_EPS
     (counted; such rows left out), outputs within MOE_TOL (1e-4) relative
     to max, aux_loss and dropped_frac printed (control: TF32 products); (c)
     8 layers, bf16 weights, "mixtral" routing at capacity factor 4 (as an
     imported Mixtral runs): `batch_infer` of phase 4's 4 requests, greedy,
     32 tokens, K1 once a layer a request, K2 once a layer a step in dense
     bf16 alone, and the 4 requests as one batch, prefill and one decode
     step, kernel route against the plain attention route pinned to the
     kernel route's expert choices (bf16 rounding flips near-tied choices,
     and a flipped token follows other experts from there on): the logits
     within LOGITS_TOL, and every choice the plain route would have made
     otherwise at a near tie of its router probabilities (two of its top
     k + 1 within MOE_BF16_MARGIN_EPS, 1e-2) (`pinned_rel_err`; control: the
     plain route over rolled KV heads, pinned alike, must fail it; the
     plain route on its own choices printed); then the same from the int8 tree
     quantized on the card, the int8 kernel once per attention projection
     and once per expert product (224 a forward), against the plain
     products; (d) `BatchedServer` in phase 7's modes (a) and (b), 16
     requests x 32 tokens, the gates of phase 7 (the decode step's logits
     through `pinned_rel_err`), the first wave's 8 streams beside
     batch_infer's (printed, not gated); then at fp32 (TF32 off) and
     MOE_FP32_LAYERS (2) layers the engine's one-shot mode over a dense fp32
     cache and mode (a)'s geometry over a paged fp32 pool (128-token
     blocks, prefill_chunk 256), every stream equal to batch_infer's (its
     prefill through K1 for the one-shot mode, on the plain route for the
     chunks, which attend plainly: K1 rounds fp32 operands to bf16) up to
     its first step whose top-2 margin is under NEAR_TIE (control: the
     streams against the next request's); (e) the adapter stage at 2
     layers, fp32 parameters, "switch" at capacity factor 1.25, batch 2 x
     1024: one step's loss and projector gradient through the kernels
     against the plain attention path pinned to the kernel route's expert
     choices (under "switch" a flipped choice moves the row's later
     capacity slots), where the plain route's own choices may differ from
     the pinned ones only at near ties (control: the plain route over rolled
     KV heads, pinned alike, must fail), then `train()` 3 steps with
     phase 10's launch gates, the MoE metrics per step and MFU; (f)
     `save_hf_checkpoint` -> `load_pretrained_backbone` of 1 layer: bit for
     bit, "mixtral" routing at capacity factor 4 selected, `config.json` a
     MixtralForCausalLM's (control: the experts rolled by one). Printed: the
     bytes a batch-1 decode step reads and their floor, prefill ms, decode
     ms/token, the serving figures of phase 7, the parts' seconds.
 23. native I/O, annotation and preprocessing (`run_native_phase`): (a)
     both native libraries (`native/audioproc.cpp`, `native/tarloader.cpp`)
     compiled afresh with g++, their seconds; phase 20's 8 WAVs read at 48
     kHz and phase 21's at 44.1 kHz through `read_wav` (the native library)
     and through the numpy routes called by name, seconds a second of audio
     for each, the samples within NATIVE_READ_TOL (1e-4) in the interior and
     `peak_normalize` within PEAK_TOL (1e-6) of x / max|x|; (b) 8 seeded
     synthbench clips of 30 s (every family) as 44.1 kHz WAVs through
     `python -m llark_tpu_torch.preprocessing.pipeline_cli` crop
     --multicrop, annotate (the DSP chain, a worker a core) and
     crop-annotations, rows/s each, then `pack_webdataset` and the shards
     read back through the native tar loader and the Python reader, equal
     samples; (c) BeatNet and KeyNet on the card against the same modules on
     the CPU for each clip, fp32 with TF32 off, within ANNOTATOR_TOL (1e-5)
     relative to max (control: the card with TF32 products must land above
     it), the neural chain's key, tempos, beats and downbeats equal on the
     card and the CPU, and synthbench's scores of the DSP and neural chains
     on these clips; (d) the native calls of phase 17 (train() and
     `from_webdataset` read their shards through the native tar loader),
     phase 20 (8 parses and resamples in the CLAP CLI's card run; its host
     share) and phase 21 (8 parses; its host seconds), each gated in its
     phase; the parts' seconds.

Launch gates: the flash-prefill kernel once per layer per prefill (32 per
request in phase 4), once per layer per admission wave in the one-shot
serving modes (64 in (b) and (d), none in the chunked ones), and once per
layer per micro-batch plus once more in remat's recomputation when
training (128 per adapter step).

Prints a {"kernels": [...]} JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Imports nothing of JAX or llark_tpu.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import csv
import dataclasses
import json
import os
import statistics
import struct
import subprocess
import sys
import shutil
import tempfile
import threading
import time

import numpy as np
import torch

from llark_tpu_torch.audio import io as audio_io
from llark_tpu_torch.audio import neural, synthbench
from llark_tpu_torch.audio.annotate import annotate_elem
from llark_tpu_torch.audio.io import DEFAULT_SR, read_wav, write_wav
from llark_tpu_torch.config import DataArguments, ModelArguments, ModelConfig, TrainingArguments
from llark_tpu_torch.data.pipeline import make_data_module
from llark_tpu_torch.data.webdataset import TarShardReader, TarShardWriter
from llark_tpu_torch.encoders import extract_cli
from llark_tpu_torch.encoders.jukebox import encode as jb_encode
from llark_tpu_torch.encoders.jukebox import import_torch as jb_import
from llark_tpu_torch.encoders.jukebox import prior as jb_prior
from llark_tpu_torch.encoders.jukebox import vqvae as jb_vqvae
from llark_tpu_torch.encoders.jukebox.config import JukeboxPriorConfig, JukeboxVQVAEConfig
from llark_tpu_torch.encoders.jukebox.encode import JukeboxEncoder
from llark_tpu_torch.generate import (
    GenerationConfig,
    Generator,
    decode_step,
    paged_prefill_chunk,
    prefill,
    prefill_last,
)
from llark_tpu_torch.infer import (
    _common_prompt_prefix,
    batch_infer,
    batch_infer_continuous,
    build_prompt_ids,
)
from llark_tpu_torch.inference import beam as beam_mod
from llark_tpu_torch.inference import from_encodings, from_webdataset
from llark_tpu_torch.inference import speculative as spec_mod
from llark_tpu_torch.inference.server import BatchedServer, Request
from llark_tpu_torch.interop import hf
from llark_tpu_torch.models import decoder as decoder_mod
from llark_tpu_torch.models import lora as lora_mod
from llark_tpu_torch.models import moe as moe_mod
from llark_tpu_torch.models import quant
from llark_tpu_torch.models.decoder import _quantize_kv, decoder_forward
from llark_tpu_torch.models.fusion import build_inputs_embeds, init_llark_params
from llark_tpu_torch.ops import _build
from llark_tpu_torch.ops import attention as attn_ops
from llark_tpu_torch.ops import decode_attention as dec_ops
from llark_tpu_torch.ops import int4_matmul as int4_ops
from llark_tpu_torch.ops import int8_matmul as int8_ops
from llark_tpu_torch.tokenization import TokenizerBundle, WordTokenizer
from llark_tpu_torch.models.utils import load_pretrained_model, save_model_metadata
from llark_tpu_torch.native import build as native_build
from llark_tpu_torch.preprocessing import pack_webdataset
from llark_tpu_torch.train import flops
from llark_tpu_torch.train import train as train_mod
from llark_tpu_torch.train.checkpoint import CheckpointManager
from llark_tpu_torch.train.state import TrainState
from llark_tpu_torch.train.step import make_loss_fn, train_loss
from llark_tpu_torch.train.train import train

SEED = 0
# Kernel vs plain, both rounded to bf16 on output. ROW_TOL bounds the worst
# query row's |kernel - plain| / |plain| (L2 over the head dim). On an H100
# 80GB HBM3 at 700 W the cases below read at most 4.9e-3 for the prefill
# kernel, which rounds the probabilities to bf16 for the P.V product, and
# 1.6e-3 for the decode kernel, which keeps them to about fp32 precision (a
# bf16 high part and the bf16 rest); P rounded to bf16 alone read 4.9e-3
# there (PERF.md). The decode limit is about one bf16 ulp (2**-8 = 3.9e-3
# relative) above the fp32 readings, the prefill limit above its own.
# KERNEL_TOL bounds max |kernel - plain| / max |plain| over the output.
# The quantized products are held per output row (L2 over the output
# channels). The int8 kernel computes the plain version's exact products in
# another order and rounds once: at most 2.9e-4 read. The int4 kernel keeps
# the group scales in fp32 and applies them to fp32 group sums, where the
# plain version rounds nibble x scale to bf16 before the product: at most
# 3.7e-3 read. Each limit is about one bf16 ulp above its reading.
ROW_TOL = {"flash_fwd": 1e-2, "flash_decode": 4e-3, "flash_bwd": 1e-2,
           "int8_matmul": 4e-3, "int4_matmul": 8e-3}
KERNEL_TOL = 2e-2
# The flash backward (dq, dk, dv) is held to the JAX package's bound for
# its flash backward, 1.6e-2 relative to max (PERFORMANCE.md:130-132). Its per-row
# measure floors each row's norm at 1e-2 of the tensor's RMS row norm: a
# dq row can be ~0 by cancellation (the first query sees one key, so its
# ds is p (dp - delta) = 0 up to rounding), and a relative error there says
# nothing. On the cases below an H100 80GB HBM3 at 700 W read at most
# 5.4e-3 per row and 6.1e-3 relative to max (PERF.md): the row limit is
# about one bf16 ulp (3.9e-3 relative) above that.
BWD_TOL = 1.6e-2
ROW_FLOOR = {"flash_bwd": 1e-2}
# log-sum-exp of the forward, kernel vs plain, absolute (fp32): read at
# most 3.1e-5 on the cases below
LSE_TOL = 1e-4
LOGITS_TOL = 5e-2  # prefill logits, kernel path vs plain attention path
# one verify window's logits against gamma + 1 sequential decode steps
# (phase 19), relative to max. From float weights both sides run the same
# products and read 2.97e-6 to 3.89e-6 (fp32 and bf16, H100 80GB HBM3 at
# 700 W). From int8 weights K5 splits the contraction at M = 8 and not at
# M = 40, and that rounding read 1.29e-2: held at LOGITS_TOL.
WINDOW_TOL = 1e-4
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
N_TIMED = 30


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def rel_err(got: torch.Tensor, want: torch.Tensor):
    diff = (got.float() - want.float()).abs().max().item()
    return diff / max(want.float().abs().max().item(), 1e-6), diff


def row_err(got: torch.Tensor, want: torch.Tensor, floor: float = 0.0) -> float:
    """Worst |got - want| / |want| over the rows of the last axis (L2).
    Without a floor, a row of zeros in want (a query with no live key) must
    be zeros in got; with one, each row's norm counts as at least `floor`
    times the RMS row norm of want."""
    g, w = got.float(), want.float()
    w_norm = w.norm(dim=-1)
    if floor:
        w_norm = w_norm.clamp_min(floor * w_norm.square().mean().sqrt().item())
    live = w_norm > 0
    check(bool((g.norm(dim=-1)[~live] == 0).all()), "a row with no live key is not zeros")
    return ((g - w).norm(dim=-1)[live] / w_norm[live]).max().item()


def check_close(kernel: str, name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Hold a kernel's output against its plain version; the max |diff|."""
    row = row_err(got, want, ROW_FLOOR.get(kernel, 0.0))
    rel, diff = rel_err(got, want)
    limit = BWD_TOL if kernel in ROW_FLOOR else KERNEL_TOL
    print(f"{kernel} {name}: worst row {row:.3e}, max|d| {diff:.3e}, rel-to-max {rel:.3e}")
    check(row <= ROW_TOL[kernel], f"{kernel} {name}: row error {row:.3e} > {ROW_TOL[kernel]}")
    check(rel <= limit, f"{kernel} {name}: rel-to-max {rel:.3e} > {limit}")
    return diff


def bf16_randn(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

_FLUSH = None


def flush_l2(clean: bool = False) -> None:
    """A 256 MB write: the next kernel finds the 50 MB L2 cache cold. The
    cache then holds ~50 MB of dirty lines, which the next kernel's reads
    write back to device memory first (a bytes-bound kernel pays ~15 us for
    them at 3.35 TB/s). With `clean`, a read of the same 256 MB follows: the
    cache is cold and clean, as a layer of the model finds it after a
    projection that only read its weights."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    _FLUSH.zero_()
    if clean:
        _FLUSH.sum()


def median_ms(fn, n: int = N_TIMED, clean: bool = False) -> float:
    """Median device time of fn over n runs, from CUDA events. Before each
    run a 256 MB write leaves the L2 cache cold (as a layer of the model
    finds it; `clean`: and holding no dirty line, see flush_l2), and a sleep
    kernel keeps the card busy while the host enqueues fn, so the events
    time the device work and not the Python around the launch."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        flush_l2(clean)
        torch.cuda._sleep(4_000_000)  # ~2 ms at 1.98 GHz
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_flops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "operations")


# ---------------------------------------------------------------------------
# phases 2 and 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_flash_fwd(gen: torch.Generator, plen: int) -> float:
    # (name, batch, heads, kv heads, head_dim, ALiBi, kv_lengths): first the
    # shape batch_infer gives the kernel (one request, prompt padded to 384)
    ragged = [384, 0, 301, 129]
    cases = [
        (f"main path [1,32,384,128] causal, kv_len {plen}", 1, 32, 32, 128, False, [plen]),
        ("[4,32,384,128] causal", 4, 32, 32, 128, False, ragged),
        ("GQA Hkv=8 + ALiBi", 4, 32, 8, 128, True, ragged),
        ("head_dim 64", 4, 32, 32, 64, False, ragged),
    ]
    worst_abs = 0.0
    for name, b, h, hkv, d, alibi, lengths in cases:
        q = bf16_randn(gen, b, h, 384, d)
        k = bf16_randn(gen, b, hkv, 384, d)
        v = bf16_randn(gen, b, hkv, 384, d)
        kv_lengths = torch.tensor(lengths, device="cuda")
        slopes = attn_ops.alibi_slopes(h, "cuda") if alibi else None
        got = attn_ops.flash_attention_fwd(q, k, v, kv_lengths=kv_lengths, slopes=slopes)
        torch.cuda.synchronize()
        want = attn_ops._flash_attention_fwd_plain(
            q, k, v, causal=True, kv_lengths=kv_lengths, slopes=slopes
        )
        worst_abs = max(worst_abs, check_close("flash_fwd", name, got, want))
    return worst_abs


def check_flash_decode(gen: torch.Generator, plen: int) -> float:
    # (batch, heads, kv heads, ALiBi, kv_lengths, query lengths): first the
    # shape batch_infer gives the kernel (one request, cache 2048)
    ragged = [1, 77, 1000, 2048]
    cases = [
        (1, 32, 32, False, [plen + 16], (1,)),
        (4, 32, 32, False, ragged, (1, 5)),
        (4, 32, 8, True, ragged, (1, 5)),
    ]
    worst_abs = 0.0
    for b, h, hkv, alibi, lengths, sqs in cases:
        kv_lengths = torch.tensor(lengths, device="cuda")
        k = bf16_randn(gen, b, hkv, 2048, 128)
        v = bf16_randn(gen, b, hkv, 2048, 128)
        slopes = attn_ops.alibi_slopes(h, "cuda") if alibi else None
        for sq in sqs:
            q = bf16_randn(gen, b, h, sq, 128)
            q_positions = (kv_lengths - sq).clamp_min(0)
            got = dec_ops.flash_decode_attention(
                q, k, v, kv_lengths=kv_lengths, q_positions=q_positions, slopes=slopes
            )
            torch.cuda.synchronize()
            want = dec_ops._flash_decode_plain(
                q, k, v, kv_lengths=kv_lengths, q_positions=q_positions, k_scale=None,
                v_scale=None, slopes=slopes, block_tables=None,
            )
            name = f"cache [{b},{hkv},2048,128] kv_len {lengths} Sq={sq}{' ALiBi' if alibi else ''}"
            worst_abs = max(worst_abs, check_close("flash_decode", name, got, want))
    return worst_abs


# ---------------------------------------------------------------------------
# phase 4: the serving path at Llama-2-7B width
# ---------------------------------------------------------------------------


PROMPTS = ["Describe the audio.", "What is the tempo?", "Which instruments play?",
           "What is the key of this piece?"]


def requests(cfg: ModelConfig):
    """The main path's 4 requests: a question and a random [256, 4800]
    encoding each, made from the seed; and their longest prompt, in tokens."""
    bundle = TokenizerBundle.from_tokenizer(WordTokenizer(2048))
    rng = np.random.RandomState(SEED)
    rows = [
        {"example_id": str(i), "prompt": p,
         "audio_encoding": rng.randn(256, cfg.mm_hidden_size).astype(np.float32)}
        for i, p in enumerate(PROMPTS)
    ]
    plen = max(len(build_prompt_ids(p, 256, bundle)) for p in PROMPTS)
    return bundle, rows, plen


# the launch counters of the two quantized products, by weight format
WQ_KERNELS = {"int8": int8_ops.int8_matmul, "int4": int4_ops.int4_matmul}
PRODUCTS_PER_FORWARD = 7 * 32  # 7 projections x 32 layers


@contextlib.contextmanager
def plain_products():
    """Inside, the quantized products of CUDA tensors run their plain
    versions: the gates that hold the kernel route against the plain one on
    the same quantized tree use it. The package itself has no such switch.
    No kernel may launch inside: a patch that missed the name the package
    calls would hold the kernel against itself."""
    saved = int8_ops.int8_matmul, quant.int4_matmul
    before = {name: fn.launches for name, fn in WQ_KERNELS.items()}
    int8_ops.int8_matmul = lambda x, q, scale: int8_ops._int8_matmul_plain(x, q, scale)
    quant.int4_matmul = lambda x, q4, scale, group=128: int4_ops._int4_matmul_plain(x, q4, scale)
    try:
        yield
    finally:
        int8_ops.int8_matmul, quant.int4_matmul = saved
    after = {name: fn.launches for name, fn in WQ_KERNELS.items()}
    check(after == before, f"a quantized kernel launched on the plain route: {before} -> {after}")


def reset_wq_counts() -> None:
    for fn in WQ_KERNELS.values():
        fn.launches = 0


def check_wq_counts(where: str, wq: str) -> int:
    """The format's kernel ran a positive multiple of 224 times (every
    forward is 7 projections x 32 layers) and the other format's never."""
    own = WQ_KERNELS[wq].launches
    others = sum(fn.launches for name, fn in WQ_KERNELS.items() if name != wq)
    check(own > 0 and own % PRODUCTS_PER_FORWARD == 0,
          f"{where}: {own} {wq} launches is no positive multiple of {PRODUCTS_PER_FORWARD}")
    check(others == 0, f"{where}: the other format's kernel launched {others} times")
    return own


def param_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(params))


def run_main_path(cfg: ModelConfig, bundle: TokenizerBundle, rows, params=None, wq=None):
    """`batch_infer` over the 4 requests, then per request the kernel route
    against a plain route: for bf16 weights (`wq` None) the plain attention
    path; for a quantized tree (`wq` "int8" or "int4") the plain products.
    Returns the launch counts of the batch_infer run and the run's figures."""
    label = "bf16 weights" if wq is None else f"{wq} weights"
    if params is None:
        t0 = time.perf_counter()
        params = init_llark_params(cfg, seed=SEED, device="cuda")
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _leaves(params))
        print(f"7B-width params: {n_params / 1e9:.3f} B in bf16 on the card, "
              f"init {time.perf_counter() - t0:.2f} s")
    gen_cfg = GenerationConfig(max_new_tokens=32)
    generator = Generator(cfg, params, bundle.audio_patch_id, gen_cfg, max_cache_len=2048)

    attn_ops.flash_attention_fwd.launches = 0
    dec_ops.flash_decode_attention.launches = 0
    reset_wq_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = batch_infer(rows, generator, bundle)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {
        "flash_fwd": attn_ops.flash_attention_fwd.launches,
        "flash_decode": dec_ops.flash_decode_attention.launches,
        "int8_matmul": int8_ops.int8_matmul.launches,
        "int4_matmul": int4_ops.int4_matmul.launches,
    }
    print(f"batch_infer ({label}): {len(results)} requests in {wall:.3f} s; launches {launches}")
    check(len(results) == len(rows), "batch_infer lost a row")
    check(all(isinstance(r["model_completion"], str) for r in results), "no completion")
    # one prefill per request, one flash-prefill launch per layer
    check(launches["flash_fwd"] == cfg.num_layers * len(rows),
          f"the main path launched the flash-prefill kernel {launches['flash_fwd']} times, "
          f"not {cfg.num_layers} x {len(rows)}")
    check(launches["flash_decode"] > 0, "the main path never launched the flash-decode kernel")
    if wq is None:
        check(launches["int8_matmul"] == 0 and launches["int4_matmul"] == 0,
              "bf16 weights launched a quantized product")
    else:
        check_wq_counts(f"batch_infer ({label})", wq)
    print("completion 0:", repr(results[0]["model_completion"][:120]))

    # the same requests through the plain route
    exact = GenerationConfig(max_new_tokens=32, stop_text="")
    gen_k = Generator(cfg, params, bundle.audio_patch_id, exact, max_cache_len=2048)
    if wq is None:
        plain_cfg = dataclasses.replace(cfg, use_pallas_attention=False, use_flash_decode=False)
        gen_p, plain, plain_name = (
            Generator(plain_cfg, params, bundle.audio_patch_id, exact, max_cache_len=2048),
            contextlib.nullcontext, "plain attention path")
    else:
        gen_p, plain, plain_name, rows = gen_k, plain_products, "plain products", rows[:2]
    agree, total, prefill_ms, decode_ms = 0, 0, [], []
    for row in rows:
        ids = build_prompt_ids(row["prompt"], 256, bundle)
        plen = len(ids)
        s = int(np.ceil(plen / 128) * 128)
        input_ids = np.full((1, s), bundle.pad_token_id, np.int32)
        input_ids[0, :plen] = ids
        args = (input_ids, np.array([plen], np.int32), row["audio_encoding"][None],
                np.array([256], np.int32))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits_k, cache = gen_k.prefill(*args)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if wq is not None:
            # one decode step from the prefilled cache: 224 launches, and its
            # logits against the plain products (the second step rewrites the
            # same K/V at the same position)
            token = logits_k.argmax(-1)
            pos = torch.tensor([plen], device="cuda")
            reset_wq_counts()
            with torch.inference_mode():
                step_k = decode_step(cfg, params, token, cache, pos)[0]
            own = check_wq_counts(f"one decode step ({label})", wq)
            check(own == PRODUCTS_PER_FORWARD, f"one decode step launched {own} {wq} products")
            with torch.inference_mode(), plain_products():
                step_p = decode_step(cfg, params, token, cache, pos)[0]
            rel, diff = rel_err(step_k, step_p)
            print(f"prompt {plen} tokens: one decode step, {own} {wq} launches; logits vs "
                  f"{plain_name} max|d| {diff:.3e}, rel-to-max {rel:.3e}")
            check(rel <= LOGITS_TOL, f"decode logits rel err {rel:.3e} > {LOGITS_TOL}")
        del cache
        torch.cuda.synchronize()
        t1b = time.perf_counter()
        toks_k = gen_k.generate(*args)[0]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with plain():
            logits_p, _ = gen_p.prefill(*args)
            toks_p = gen_p.generate(*args)[0]
        check(tuple(logits_k.shape) == (1, cfg.vocab_size), f"logits shape {logits_k.shape}")
        check(bool(torch.isfinite(logits_k).all()), "non-finite prefill logits")
        rel, diff = rel_err(logits_k, logits_p)
        print(f"prompt {plen} tokens (padded {s}): prefill logits vs {plain_name} "
              f"max|d| {diff:.3e}, rel-to-max {rel:.3e}")
        check(rel <= LOGITS_TOL, f"prefill logits rel err {rel:.3e} > {LOGITS_TOL}")
        agree += sum(a == b for a, b in zip(toks_k, toks_p))
        total += len(toks_p)
        prefill_ms.append((t1 - t0) * 1e3)
        decode_ms.append(((t2 - t1b) - (t1 - t0)) * 1e3 / (len(toks_k) - 1))
    print(f"greedy tokens equal to the {plain_name}: {agree}/{total}")
    p_ms, d_ms = statistics.median(prefill_ms), statistics.median(decode_ms)
    print(f"7B serving ({label}), batch 1, prompt {plen} (padded to {s}): prefill {p_ms:.2f} ms, "
          f"decode {d_ms:.2f} ms/token, {1e3 / d_ms:.1f} tok/s (medians of {len(rows)} requests)")
    # the device split of a short generate: the profiler's own cost grows
    # with the events (a 32-token generate took it ~40 s)
    short = Generator(cfg, params, bundle.audio_patch_id,
                      GenerationConfig(max_new_tokens=8, stop_text=""), max_cache_len=2048)
    _, short_s = seconds(lambda: short.generate(*args))
    busy_ms = profile_device(lambda: short.generate(*args), short_s * 1e3,
                             what="one generate (prefill + 7 decode steps)")
    figures = dict(batch_wall_s=wall, prefill_ms=p_ms, decode_ms=d_ms, generate_wall_ms=short_s * 1e3,
                   generate_device_ms=busy_ms, param_gb=param_bytes(params) / 1e9)
    del params, generator, gen_k, gen_p
    torch.cuda.empty_cache()
    return launches, figures


def profile_device(fn, wall_ms, top: int = 8,
                   what: str = "one run"):
    """Device kernel time of one fn() run from torch.profiler, beside the
    same run's unprofiled wall time (`wall_ms`), or with `wall_ms` None the
    profiled run's own: the card's idle share. Returns the device ms (None
    if the profiler saw none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, profiled_s = seconds(fn)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        print("device busy time: not measured (the profiler saw no device time)")
        return None
    wall_ms, how = (profiled_s * 1e3, "profiled") if wall_ms is None else (wall_ms, "unprofiled")
    print(f"{what}: wall {wall_ms:.1f} ms {how}, "
          f"device kernels {busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.1%}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<6d} {e.key[:90]}")
    return busy_ms


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ---------------------------------------------------------------------------
# phase 5: timings
# ---------------------------------------------------------------------------


def sdpa(q, k, v, mask):
    # library yardstick only: the port never calls it
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def time_flash_fwd_at(gen, s: int, lengths):
    """K1 at q/k/v [len(lengths), 32, s, 128] bf16, causal, kv_len per row:
    (ms, plain_ms, sdpa_ms, (bound_ms, bound_by), shape). SDPA gets the
    same mask (every row here sees at least key 0, so its softmax has no
    NaN row)."""
    b, h, d = len(lengths), 32, 128
    q, k, v = (bf16_randn(gen, b, h, s, d) for _ in range(3))
    # int32 lengths, as the decoder passes them: the wrapper converts nothing
    kv = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    kw = dict(causal=True, kv_lengths=kv, slopes=None)
    ms = median_ms(lambda: attn_ops.flash_attention_fwd(q, k, v, **kw))
    plain_ms = median_ms(lambda: attn_ops._flash_attention_fwd_plain(q, k, v, **kw))
    pos = torch.arange(s, device="cuda")
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] < kv[:, None, None])
    lib_ms = median_ms(lambda: sdpa(q, k, v, mask[:, None]))
    # bytes: q and o whole, k and v live rows only; FLOPs: 4*D per visible
    # (query, key) pair
    live = [min(n, s) for n in lengths]
    nbytes = 2 * (2 * b * h * s * d) + 2 * (2 * h * sum(live) * d) + 4 * b
    qi = np.arange(s)[:, None]
    ki = np.arange(s)[None, :]
    pairs = sum(int(((ki <= qi) & (ki < n)).sum()) for n in live)
    flops = 4.0 * d * h * pairs
    shown = lengths if len(set(lengths)) > 1 else lengths[0]
    return ms, plain_ms, lib_ms, bound(nbytes, flops), f"[{b},{h},{s},{d}] causal, kv_len {shown}"


def time_flash_fwd(gen, plen, b):
    return time_flash_fwd_at(gen, 384, [plen] * b)


def time_flash_decode(gen, kv_len, b):
    h, s, d = 32, 2048, 128
    q = bf16_randn(gen, b, h, 1, d)
    k, v = bf16_randn(gen, b, h, s, d), bf16_randn(gen, b, h, s, d)
    kv = torch.full((b,), kv_len, dtype=torch.int32, device="cuda")
    qpos = kv - 1
    ms = median_ms(lambda: dec_ops.flash_decode_attention(
        q, k, v, kv_lengths=kv, q_positions=qpos))
    plain_ms = median_ms(lambda: dec_ops._flash_decode_plain(
        q, k, v, kv_lengths=kv, q_positions=qpos, k_scale=None, v_scale=None,
        slopes=None, block_tables=None))
    mask = (torch.arange(s, device="cuda")[None, :] < kv[:, None])[:, None, None, :]
    lib_ms = median_ms(lambda: sdpa(q, k, v, mask))
    nbytes = 2 * (2 * b * h * d) + 2 * (2 * b * h * kv_len * d) + 8 * b
    flops = 4.0 * d * b * h * kv_len
    return ms, plain_ms, lib_ms, bound(nbytes, flops), f"q [{b},{h},1,{d}], cache S={s}, kv_len {kv_len}"


def k2_host_us(gen, kv_len) -> float:
    """Host time to enqueue one flash-decode call at the one-request shape
    (q [1,32,1,128], cache 2048): the least of five host_us runs, since the
    host's speed varies with its other load."""
    q = bf16_randn(gen, 1, 32, 1, 128)
    k, v = bf16_randn(gen, 1, 32, 2048, 128), bf16_randn(gen, 1, 32, 2048, 128)
    kv = torch.tensor([kv_len], dtype=torch.int32, device="cuda")
    return min(host_us(lambda: dec_ops.flash_decode_attention(q, k, v, kv_lengths=kv))
               for _ in range(5))


# ---------------------------------------------------------------------------
# phase 6 (A): the flash-decode kernel's int8 and paged modes (K2')
# ---------------------------------------------------------------------------

SERVE_LENGTHS = [300, 305, 311, 318, 322, 329, 334, 340]  # ragged live lengths, batch 8


def k2_inputs(gen, mode: str, hkv: int = 32, sq: int = 1, bs: int = 128, s: int = 2048):
    """q [8, 32, sq, 128] bf16 and a cache of `s` positions per row in one
    of the modes "bf16" or "int8" (dense), "paged" or "paged_int8". Paged
    tables are random permutations of the pool's blocks (scattered, not
    consecutive), with the 8 parking blocks first as the server lays the
    pool out."""
    b, h, d = len(SERVE_LENGTHS), 32, 128
    q = bf16_randn(gen, b, h, sq, d)
    # int32 lengths and positions, as the decoder passes them
    kw = dict(kv_lengths=torch.tensor(SERVE_LENGTHS, dtype=torch.int32, device="cuda"))
    kw["q_positions"] = kw["kv_lengths"] - sq
    if mode.startswith("paged"):
        max_blocks = s // bs
        n_blocks = b + b * max_blocks
        k, v = bf16_randn(gen, n_blocks, hkv, bs, d), bf16_randn(gen, n_blocks, hkv, bs, d)
        perm = torch.randperm(n_blocks - b, generator=gen, device="cuda") + b
        kw["block_tables"] = perm.reshape(b, max_blocks).to(torch.int32)
    else:
        k, v = bf16_randn(gen, b, hkv, s, d), bf16_randn(gen, b, hkv, s, d)
    if mode.endswith("int8"):
        (k, kw["k_scale"]), (v, kw["v_scale"]) = _quantize_kv(k), _quantize_kv(v)
    return q, k, v, kw


def k2_plain(q, k, v, kw):
    return dec_ops._flash_decode_plain(
        q, k, v, kv_lengths=kw["kv_lengths"], q_positions=kw["q_positions"],
        k_scale=kw.get("k_scale"), v_scale=kw.get("v_scale"), slopes=kw.get("slopes"),
        block_tables=kw.get("block_tables"))


# K2' rows of the kernels line: (name, input mode of k2_inputs, block size,
# the serving mode of phase 7 whose run gives its launches, that run's
# cache mode); paged int8 is the run-of-record mode (a)
K2_ROWS = (("flash_decode_int8", "int8", 0, "d", "dense_int8"),
           ("flash_decode_paged", "paged", 16, "c", "paged_bf16"),
           ("flash_decode_paged_int8", "paged_int8", 128, "a", "paged_int8"))


def check_flash_decode_modes(gen: torch.Generator):
    """The flash-decode kernel in every cache mode against its plain
    version at 7B serving shapes: q [8,32,1,128], 2048-position caches,
    live lengths 300-340. Both sides compute in fp32 from the same int8
    values and scales. The worst max |diff| per row of the kernels line."""
    cases = [
        ("flash_decode", "dense bf16", dict(mode="bf16")),
        ("flash_decode_int8", "dense int8", dict(mode="int8")),
        ("flash_decode_paged", "paged bf16, 16-token blocks", dict(mode="paged", bs=16)),
        ("flash_decode_paged", "paged bf16, 128-token blocks", dict(mode="paged", bs=128)),
        ("flash_decode_paged_int8", "paged int8, 128-token blocks",
         dict(mode="paged_int8", bs=128)),
        ("flash_decode_paged_int8", "paged int8, 128-token blocks, Sq=5, GQA Hkv=8 + ALiBi",
         dict(mode="paged_int8", bs=128, sq=5, hkv=8, alibi=True)),
        ("flash_decode_int8", "dense int8, Sq=5, GQA Hkv=8 + ALiBi",
         dict(mode="int8", sq=5, hkv=8, alibi=True)),
    ]
    worst = {}
    for row, name, case in cases:
        alibi = case.pop("alibi", False)
        q, k, v, kw = k2_inputs(gen, **case)
        if alibi:
            kw["slopes"] = attn_ops.alibi_slopes(32, "cuda")
        got = dec_ops.flash_decode_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        if "paged" in name:
            name += ", scattered tables"
        err = check_close("flash_decode", f"{name}, kv_len 300-340", got, k2_plain(q, k, v, kw))
        worst[row] = max(worst.get(row, 0.0), err)
    return worst


def check_flash_fwd_admission(gen: torch.Generator, lengths) -> float:
    """The flash-prefill kernel at the shape one-shot admission gives it in
    phase 7 (modes (b) and (d)): 8 admitted prompts padded to the 512-token
    bucket, causal, each row's own length; and a wave of 5 prompts padded
    with 3 one-token rows, as the server pads a short wave. The worst max
    |diff|."""
    worst = 0.0
    for name, lens in ((f"kv_len {lengths}", lengths),
                       ("5 prompts + 3 one-token rows", lengths[:5] + [1, 1, 1])):
        q, k, v = (bf16_randn(gen, 8, 32, 512, 128) for _ in range(3))
        kv_lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        got = attn_ops.flash_attention_fwd(q, k, v, kv_lengths=kv_lengths)
        torch.cuda.synchronize()
        want = attn_ops._flash_attention_fwd_plain(
            q, k, v, causal=True, kv_lengths=kv_lengths, slopes=None)
        worst = max(worst, check_close(
            "flash_fwd", f"serving admission [8,32,512,128] causal, {name}", got, want))
    return worst


def time_flash_decode_mode(gen, mode: str, bs: int):
    """(ms, plain_ms, sdpa_ms, (bound_ms, bound_by), shape) of one K2' mode
    at the phase-6 shape. The bound counts the live bytes: K and V up to
    each row's length (int8 or bf16), their fp32 scales, the live table
    entries, q and out."""
    q, k, v, kw = k2_inputs(gen, mode, bs=bs)
    ms = median_ms(lambda: dec_ops.flash_decode_attention(q, k, v, **kw))
    plain_ms = median_ms(lambda: k2_plain(q, k, v, kw))
    # printed beside it only: SDPA over a dense bf16 view of the same cache
    # (no single PyTorch call reads an int8 or paged cache)
    kd, vd = k, v
    if "block_tables" in kw:
        kd, vd = dec_ops._dense_view(k, kw["block_tables"]), dec_ops._dense_view(v, kw["block_tables"])
    if "k_scale" in kw:
        ks, vs = kw["k_scale"], kw["v_scale"]
        if "block_tables" in kw:
            ks, vs = dec_ops._dense_view(ks, kw["block_tables"]), dec_ops._dense_view(vs, kw["block_tables"])
        kd = (kd.float() * ks[..., None]).to(torch.bfloat16)
        vd = (vd.float() * vs[..., None]).to(torch.bfloat16)
    s = kd.shape[2]
    mask = (torch.arange(s, device="cuda")[None, :] < kw["kv_lengths"][:, None])[:, None, None, :]
    sdpa_ms = median_ms(lambda: sdpa(q, kd, vd, mask))
    b, h, sq, d = q.shape
    hkv, live = k.shape[1], sum(SERVE_LENGTHS)
    elem = 1 if mode.endswith("int8") else 2
    nbytes = 2 * hkv * live * d * elem + 2 * 2 * b * h * sq * d + 8 * b
    if mode.endswith("int8"):
        nbytes += 2 * hkv * live * 4
    if mode.startswith("paged"):
        nbytes += 4 * sum(-(-n // bs) for n in SERVE_LENGTHS)
    flops = 4.0 * d * h * sq * live
    return ms, plain_ms, sdpa_ms, bound(nbytes, flops), (
        f"{mode}{f' bs {bs}' if bs else ''}, q [{b},{h},{sq},{d}], 2048-position caches, "
        f"kv_len 300-340")


# ---------------------------------------------------------------------------
# phase 7 (B): the serving engine at Llama-2-7B width
# ---------------------------------------------------------------------------

# server modes: (label, description, its flash-decode cache mode,
# kv_cache_quant, server keywords); the modes without prefill_chunk admit in
# one shot, through the flash-prefill kernel (chunked admission attends the
# cache through the plain route, as on the TPU)
SERVER_MODES = (
    ("a", "run-of-record: paged 128-token blocks, int8 KV, prefill_chunk 256", "paged_int8",
     True, dict(kv_block_size=128, prefill_chunk=256)),
    ("b", "dense bf16 cache, one-shot admission", "dense_bf16", False, {}),
    ("c", "paged bf16, 16-token blocks, prefill_chunk 256, prefix caching", "paged_bf16",
     False, dict(kv_block_size=16, prefill_chunk=256, prefix=True)),
    ("d", "dense int8 cache, one-shot admission", "dense_int8", True, {}),
)


def serving_requests(cfg: ModelConfig, bundle: TokenizerBundle, n: int, seed: int):
    """n requests: the four prompts of requests() in turn, each with a
    random [256, 4800] encoding made from `seed`."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        ids = np.asarray(build_prompt_ids(PROMPTS[i % 4], 256, bundle), np.int32)
        out.append(Request(ids, rng.randn(256, cfg.mm_hidden_size).astype(np.float32)))
    return out


def profile_round(server: BatchedServer):
    """Wall time of one decode round over the live slots, unprofiled, and
    the device kernel time of the next one from torch.profiler: the card's
    idle share in a round."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server._decode_round()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        server._decode_round()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        return wall_ms, None, "not measured (the profiler saw no device time)"
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    # the flash-decode kernel's share: its split and combine kernels
    k2 = [e for e in kernels if "decode_split" in e.key or "decode_combine" in e.key]
    k2_ms = sum(e.self_device_time_total for e in k2) / 1e3
    return wall_ms, busy_ms, (
        f"flash decode {k2_ms:.2f} ms x{sum(e.count for e in k2)} "
        f"({k2_ms / busy_ms:.1%} of the round's device time); " + "; ".join(
            f"{e.self_device_time_total / 1e3:.2f} ms x{e.count} {e.key[:60]}" for e in top))


def check_chunked_admission(server: BatchedServer, wq: str, label: str) -> None:
    """Chunked admission of the 8 live requests once more, as the server's
    `_admit` drives it: `paged_prefill_chunk` over each [8, 256] chunk of
    the fused prompt embeddings (M = 8 x 256 = 2048 in every product) into
    the slots' own pool blocks, then `prefill_last`; first through the
    kernels, which rewrites what admission wrote, then through the plain
    products. Each chunk must launch 224 products, and the next-token
    logits of the two routes are held within LOGITS_TOL."""
    k, bucket, chunk = server.max_batch, server.prompt_buckets[-1], server.prefill_chunk
    reqs = list(server._slot_req)
    check(all(r is not None for r in reqs) and server._prefix_len == 0 and bucket % chunk == 0,
          f"serving ({label}): no full admitted state to replay")
    ids = np.zeros((k, bucket), np.int32)
    for j, r in enumerate(reqs):
        ids[j, : len(r.input_ids)] = r.input_ids
    plens = server._tensor(np.array([len(r.input_ids) for r in reqs], np.int32), torch.int32)
    audio = server._tensor(np.stack([r.audio_encoding for r in reqs]), torch.float32)
    fcnt = server._tensor(np.full((k,), audio.shape[1], np.int32), torch.int32)
    embeds = build_inputs_embeds(server.cfg, server.params, server._tensor(ids, torch.int64),
                                 audio, server.audio_patch_id, fcnt)
    view = server._pool_view(server._host_tables[:, : bucket // server.kv_block_size])
    logits = {}
    for route, ctx in (("kernel", contextlib.nullcontext), ("plain", plain_products)):
        with ctx():
            for c in range(0, bucket, chunk):
                done = WQ_KERNELS[wq].launches
                paged_prefill_chunk(server.cfg, server.params, embeds[:, c : c + chunk], plens,
                                    view, c)
                own = WQ_KERNELS[wq].launches - done
                check(own == (PRODUCTS_PER_FORWARD if route == "kernel" else 0),
                      f"serving ({label}): one admission chunk on the {route} route launched "
                      f"{own} {wq} products")
            logits[route] = prefill_last(server.cfg, server.params, embeds, plens, view, 0)[0]
    check(bool(torch.isfinite(logits["kernel"]).all()),
          f"serving ({label}): non-finite admission logits")
    firsts = logits["kernel"].argmax(-1).tolist()
    same = sum(a == int(b) for a, b in zip(firsts, server._tokens_in_flight))
    rel, diff = rel_err(logits["kernel"], logits["plain"])
    print(f"  chunked admission replayed, {bucket // chunk} chunks of [{k}, {chunk}] (M = {k * chunk}, "
          f"{PRODUCTS_PER_FORWARD} {wq} launches each): next-token logits vs the plain products "
          f"max|d| {diff:.3e}, rel-to-max {rel:.3e}; first tokens equal to the admitted ones "
          f"{same}/{k}")
    check(rel <= LOGITS_TOL, f"serving ({label}): {wq} admission logits rel err {rel:.3e}")


# the engine's geometry in phases 7, 14 and 19
SERVING_BASE = dict(max_batch=8, max_cache_len=2048, prompt_buckets=(512,), max_audio_frames=256,
                    decode_chunk=8)


@torch.inference_mode()
def run_serving_engine(cfg: ModelConfig, bundle: TokenizerBundle, params=None, modes="abcd",
                       wq=None):
    """Drive BatchedServer at full 7B width in each cache mode of `modes`;
    check and print what each did. `params` may be a quantized tree of
    format `wq` ("int8" or "int4"; default: bf16 weights made here).
    Returns the flash-decode launches by cache mode of each mode's serve()
    run (plus that run's launches of the format's product under its name),
    and each mode's figures; from bf16 weights these include the 16
    requests' tokens, which phase 19 counts its streams against."""
    weights = "bf16 weights" if wq is None else f"{wq} weights"
    if params is None:
        params = init_llark_params(cfg, seed=SEED, device="cuda")
    gen_cfg = GenerationConfig(max_new_tokens=32, stop_text="")
    base = dict(SERVING_BASE, tokenizer=bundle.tokenizer)
    launches, figures = {}, {}
    for label, name, own_mode, quant_kv, extra in SERVER_MODES:
        if label not in modes:
            continue
        mcfg = dataclasses.replace(cfg, kv_cache_quant=quant_kv)
        kw = dict(base, **extra)
        reqs = serving_requests(cfg, bundle, 16, SEED)
        if kw.pop("prefix", False):
            kw["shared_prefix_ids"] = _common_prompt_prefix(
                [r.input_ids for r in reqs], bundle.audio_patch_id,
                min_len=max(8, kw["kv_block_size"]))
        server = BatchedServer(mcfg, params, bundle.audio_patch_id, gen_cfg, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dec_ops.reset_launch_counts()
        attn_ops.flash_attention_fwd.launches = 0
        reset_wq_counts()
        t0 = time.perf_counter()
        server.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_mode = dict(dec_ops.flash_decode_attention.launches_by_mode)
        fwd_launches = attn_ops.flash_attention_fwd.launches
        launches[label] = by_mode
        stats = server.stats(reqs)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        print(f"serving ({label}, {weights}) {name}: 16 requests x 32 tokens in {wall:.2f} s, "
              f"{stats['tokens_per_sec']:.1f} tokens/s, mean TTFT {stats['mean_ttft_s']:.3f} s, "
              f"peak memory {peak_gb:.2f} GiB; flash-decode launches by cache mode {by_mode}, "
              f"flash-prefill launches {fwd_launches}")
        check(all(r.done and r.error is None and len(r.tokens) == 32 for r in reqs),
              f"serving ({label}): a request did not finish with 32 tokens")
        check(by_mode[own_mode] > 0, f"serving ({label}): no flash-decode launch in {own_mode}")
        check(sum(by_mode.values()) == by_mode[own_mode],
              f"serving ({label}): flash-decode launched in another cache mode: {by_mode}")
        # one-shot admission: two waves of 8, one flash-prefill launch per
        # layer each; chunked admission attends through the plain route
        want_fwd = 0 if "prefill_chunk" in extra else 2 * cfg.num_layers
        check(fwd_launches == want_fwd,
              f"serving ({label}): {fwd_launches} flash-prefill launches, not {want_fwd}")
        if wq is None:
            check(all(fn.launches == 0 for fn in WQ_KERNELS.values()),
                  f"serving ({label}): bf16 weights launched a quantized product")
        else:
            by_mode[f"{wq}_matmul"] = check_wq_counts(f"serving ({label}, {weights})", wq)
            print(f"  {wq} product launches in the run: {by_mode[f'{wq}_matmul']} "
                  f"({by_mode[f'{wq}_matmul'] // PRODUCTS_PER_FORWARD} forwards x "
                  f"{PRODUCTS_PER_FORWARD})")

        # one cache state after admission: 8 live slots
        server._queue = serving_requests(cfg, bundle, 8, SEED + 1)
        for r in server._queue:
            r.submitted_at = time.time()
        server._admit()
        server._refresh_tables()
        # one decode step from that state through the kernel route and
        # through the plain route (it rewrites the same K/V at the same
        # positions, so the second step sees the first one's cache)
        token = torch.as_tensor(server._tokens_in_flight, dtype=torch.int64, device="cuda")
        pos = torch.as_tensor(server._write_pos, dtype=torch.int64, device="cuda")
        plain_cfg = dataclasses.replace(server.cfg, use_flash_decode=False)
        # (the returned cache is the server's own: bind only the logits, so
        # that the cache goes with the server at the end of the mode)
        reset_wq_counts()
        with recorded_routes() as routes_k:
            lk = decode_step(server.cfg, params, token, server._cache, pos)[0]
        if wq is not None:
            own = check_wq_counts(f"serving ({label}): one decode step", wq)
            check(own == PRODUCTS_PER_FORWARD,
                  f"serving ({label}): one decode step launched {own} {wq} products")
        # a MoE model's plain step follows the kernel step's expert choices
        with pinned_routes(routes_k) as routes_p:
            lp = decode_step(plain_cfg, params, token, server._cache, pos)[0]
        check(bool(torch.isfinite(lk).all()), f"serving ({label}): non-finite decode logits")
        ok, reading = pinned_rel_err(lk, lp, routes_k, routes_p)
        print(f"  one decode step from the admitted state, kernel vs plain route: {reading}")
        check(ok, f"serving ({label}): decode logits {reading}")
        if wq is not None:
            with plain_products():
                lq = decode_step(server.cfg, params, token, server._cache, pos)[0]
            rel, diff = rel_err(lk, lq)
            print(f"  the same step, {PRODUCTS_PER_FORWARD} {wq} kernel launches vs the plain "
                  f"products: max|d| {diff:.3e}, rel-to-max {rel:.3e}")
            check(rel <= LOGITS_TOL, f"serving ({label}): {wq} decode logits rel err {rel:.3e}")
            if "prefill_chunk" in extra:
                check_chunked_admission(server, wq, label)
        wall_ms, busy_ms, top = profile_round(server)
        if busy_ms is None:
            print(f"  one decode round (8 slots x 8 tokens): wall {wall_ms:.1f} ms; device {top}")
        else:
            print(f"  one decode round (8 slots x 8 tokens): wall {wall_ms:.1f} ms unprofiled, "
                  f"device kernels {busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.1%}; {top}")
        figures[label] = dict(wall_s=wall, tokens_per_sec=stats["tokens_per_sec"],
                              mean_ttft_s=stats["mean_ttft_s"], peak_gib=peak_gb,
                              round_wall_ms=wall_ms, round_device_ms=busy_ms)
        if wq is None:
            figures[label]["tokens"] = [r.tokens for r in reqs]
        del server
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return launches, figures


# ---------------------------------------------------------------------------
# phases 13-16: the weight-only quantized products and serving from them
# ---------------------------------------------------------------------------

WQ_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))  # Llama-2-7B projections (K, N)
WQ_GROUP = 128
WQ_REPORT = (8, 4096, 11008)  # the serving engine's decode shape (M, K, N) of the kernels line


def wq_case(gen: torch.Generator, k: int, n: int):
    """A seeded randn * 0.02 weight [k, n] as its int8 and int4 (rows, group
    128) quantized forms and its bf16 copy."""
    w = torch.randn((k, n), generator=gen, device="cuda") * 0.02
    return quant.quantize_weight(w), quant.quantize_weight_int4(w, WQ_GROUP), w.to(torch.bfloat16)


def wq_run(fmt: str, x, wq, plain: bool = False):
    if fmt == "int8":
        fn = int8_ops._int8_matmul_plain if plain else int8_ops.int8_matmul
        return fn(x, wq["q"], wq["scale"])
    if plain:
        return int4_ops._int4_matmul_plain(x, wq["q4"], wq["scale"])
    return int4_ops.int4_matmul(x, wq["q4"], wq["scale"], group=WQ_GROUP)


def check_wq_matmul(gen: torch.Generator):
    """Both quantized products against their plain versions at the shapes
    the quantized serving path gives them (decode of one request and of 8
    slots, prefill of one request ragged and padded, chunked admission of
    8 x 256, one-shot admission of 8 x 512), at an M on each side of every
    switch of the kernel's tiles (8 | 9, 16 | 17, 64 | 65), and at a ragged
    shape. The worst max |diff| per kernel."""
    worst = {"int8_matmul": 0.0, "int4_matmul": 0.0}
    cases = [(k, n, (1, 8, 9, 16, 17, 64, 65, 293, 384, 2048, 4096)) for k, n in WQ_SHAPES]
    cases.append((256, 1000, (5,)))
    for k, n, ms in cases:
        w8, w4, _ = wq_case(gen, k, n)
        for m in ms:
            x = bf16_randn(gen, m, k)
            for fmt, wq in (("int8", w8), ("int4", w4)):
                got = wq_run(fmt, x, wq)
                torch.cuda.synchronize()
                err = check_close(f"{fmt}_matmul", f"M={m} (K,N)=({k},{n})", got,
                                  wq_run(fmt, x, wq, plain=True))
                worst[f"{fmt}_matmul"] = max(worst[f"{fmt}_matmul"], err)
    return worst


def wq_bound(fmt: str, m: int, k: int, n: int):
    """The bound of one quantized product: x, the stored weight bytes and
    their scales read once, the output written once; 2 M K N operations."""
    stored = k * n + 4 * n if fmt == "int8" else k * n // 2 + 4 * (k // WQ_GROUP) * n
    return bound(2 * m * k + stored + 2 * m * n, 2.0 * m * k * n)


def host_us(fn, n: int = 500) -> float:
    """Host time to enqueue one fn() call: n calls back to back (fewer than
    the launch queue holds), the clock read before the card has drained."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def time_wq_matmul(gen: torch.Generator):
    """Timings of both products at the three (K, N) and M in 1, 8, 384,
    2048, 4096. Returns {format: (ms, plain_ms, (bound_ms, bound_by))} at
    WQ_REPORT, and every kernel time as {(format, M, K, N): ms}."""
    report, times = {}, {}
    for k, n in WQ_SHAPES:
        w8, w4, wb = wq_case(gen, k, n)
        if (k, n) == WQ_SHAPES[0]:
            # what one projection of a decode step costs the host, which sets
            # the step's wall time: the dispatcher the decoder calls, beside
            # the one call an unquantized projection makes
            x = bf16_randn(gen, 8, 1, k)
            with torch.inference_mode():
                print(f"host enqueue per projection at M=8 (K,N)=({k},{n}): "
                      f"int8 {host_us(lambda: quant.quantized_dense(x, w8, None, x.dtype)):.1f} us, "
                      f"int4 {host_us(lambda: quant.quantized_dense_int4(x, w4, None, x.dtype)):.1f} us, "
                      f"torch.matmul on bf16 weights {host_us(lambda: torch.matmul(x, wb)):.1f} us")
        for m in (1, 8, 384, 2048, 4096):
            x = bf16_randn(gen, m, k)
            # printed beside them, neither computes the same function: the
            # product an unquantized model pays, and a dequantized copy
            # written to memory before the product
            bf16_ms = median_ms(lambda: torch.matmul(x, wb))
            deq_ms = median_ms(lambda: torch.matmul(x, quant.dequantize_weight(w8, torch.bfloat16)))
            for fmt, wq in (("int8", w8), ("int4", w4)):
                ms = median_ms(lambda: wq_run(fmt, x, wq))
                times[(fmt, m, k, n)] = ms
                plain_ms = median_ms(lambda: wq_run(fmt, x, wq, plain=True))
                bound_ms, bound_by = wq_bound(fmt, m, k, n)
                print(f"{fmt}_matmul at M={m} (K,N)=({k},{n}): kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
                      f"{bound_ms / ms:.1%} of bound; not the same function: torch.matmul on a "
                      f"bf16 copy of the weight {bf16_ms:.4f} ms, int8 dequantize-then-matmul "
                      f"{deq_ms:.4f} ms")
                if m <= 8:
                    # decode shapes are bound by bytes: also with no dirty
                    # line in the cold L2 (flush_l2)
                    clean_ms = median_ms(lambda: wq_run(fmt, x, wq), clean=True)
                    clean_bf16 = median_ms(lambda: torch.matmul(x, wb), clean=True)
                    print(f"  with a clean cold L2: kernel {clean_ms:.4f} ms, "
                          f"{bound_ms / clean_ms:.1%} of bound; torch.matmul on a bf16 copy "
                          f"{clean_bf16:.4f} ms")
                if (m, k, n) == WQ_REPORT:
                    report[fmt] = (ms, plain_ms, (bound_ms, bound_by))
    return report, times


# (M, K, N) of the library yardsticks: the kernels line's decode shape and
# one chunked-admission shape (`_weight_int8pack_mm` takes 75-407 ms a call
# at admission shapes, PERF.md)
WQ_LIBRARY_SHAPES = (WQ_REPORT, (2048, 4096, 4096))


def time_wq_library(gen: torch.Generator, kernel_ms: dict, shapes=WQ_LIBRARY_SHAPES):
    """PyTorch's own weight-only quantized products at `shapes` ((M, K, N)),
    where the installed torch runs them on CUDA tensors (the port never
    calls them): `torch._weight_int8pack_mm` (int8 [N, K], one bf16 scale
    per output channel) and `torch._weight_int4pack_mm` (tinygemm's packed
    int4, bf16 scale and zero point per 128-row group; zero 0 here, the
    symmetric scheme of K6). The weights are converted before the timed
    window. Each is held against the kernel's output on the same inputs; it
    counts as the kernel's library yardstick (same function up to its bf16
    scales) when it agrees within KERNEL_TOL, and is printed beside the
    kernel's time from `kernel_ms` ({(format, M, K, N): ms}). Returns
    {format: ms or None} at WQ_REPORT."""
    out = {}
    for m, k, n in shapes:
        w = torch.randn((k, n), generator=gen, device="cuda") * 0.02
        x = bf16_randn(gen, m, k)
        w8 = quant.quantize_weight(w)
        w4 = quant.quantize_weight_int4(w, WQ_GROUP)

        def int8_call():
            wt = w8["q"].t().contiguous()
            sc = w8["scale"].reshape(n).to(torch.bfloat16)
            return lambda: torch._weight_int8pack_mm(x, wt, sc)

        def int4_call():
            q, scale = quant._quantize_groups_int4(w, WQ_GROUP)
            qu = (q.to(torch.int32) + 8).t().contiguous()  # [N, K], 1..15, 8 = zero
            packed = (qu[:, 0::2] << 4 | qu[:, 1::2]).to(torch.uint8)
            wp = torch._convert_weight_to_int4pack(packed, 8)
            sz = torch.stack([scale, torch.zeros_like(scale)], dim=-1).to(torch.bfloat16).contiguous()
            return lambda: torch._weight_int4pack_mm(x, wp, WQ_GROUP, sz)

        for fmt, name, make, wq in (("int8", "torch._weight_int8pack_mm", int8_call, w8),
                                    ("int4", "torch._weight_int4pack_mm", int4_call, w4)):
            try:
                fn = make()
                got = fn()
                torch.cuda.synchronize()
            except (RuntimeError, NotImplementedError, AttributeError) as e:
                print(f"{name} does not run on CUDA tensors in torch {torch.__version__}: "
                      f"{str(e).splitlines()[0][:160]}")
                if (m, k, n) == WQ_REPORT:
                    out[fmt] = None
                continue
            rel, _ = rel_err(got, wq_run(fmt, x, wq))
            ms = median_ms(fn, n=N_TIMED if m < 2048 else 10)
            same = rel <= KERNEL_TOL
            kms = kernel_ms[(fmt, m, k, n)]
            print(f"{name} at M={m} (K,N)=({k},{n}): {ms:.4f} ms beside the {fmt} kernel's "
                  f"{kms:.4f} ms ({ms / kms:.2f}x); rel-to-max against the kernel {rel:.3e} "
                  f"({'the same function up to its bf16 scales' if same else 'another function'})")
            if (m, k, n) == WQ_REPORT:
                out[fmt] = ms if same else None
        del w, x, w8, w4
    return out


def print_wq_kernel_split(n: int = 10) -> None:
    """Each quantized product's device time at WQ_REPORT by kernel: the mean
    device time of each kernel over n runs, L2 flushed, by name, from
    torch.profiler. One kernel a product: a split contraction is combined
    inside it by the last block of each output tile. Runs first, on inputs
    from a seed of its own: late in the script the profiler returned no
    device events for a window this short."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    m, k, n_out = WQ_REPORT
    w8, w4, _ = wq_case(gen, k, n_out)
    x = bf16_randn(gen, m, k)
    for fmt, wq in (("int8", w8), ("int4", w4)):
        wq_run(fmt, x, wq)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                flush_l2()
                wq_run(fmt, x, wq)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and "wq::" in e.key]
        split = "; ".join(
            f"{e.key.split('(')[0].removeprefix('void ')} "
            f"{e.self_device_time_total / e.count:.1f} us x{e.count}" for e in kernels)
        print(f"{fmt}_matmul at M={m} (K,N)=({k},{n_out}), device time by kernel: "
              f"{split or 'not measured (the profiler saw no device time)'}")


def beside(name: str, got: dict, ref: dict) -> None:
    """One run's figures beside the bf16-weight run's of this script."""
    def fmt(v):
        return "not measured" if v is None else f"{v:.4g}"
    print(f"  {name} | " + "; ".join(f"{k} {fmt(got[k])} (bf16: {fmt(ref[k])})" for k in got))


def run_quantized_serving(cfg: ModelConfig, bundle: TokenizerBundle, rows, wq: str, modes: str,
                          bf16_main: dict, bf16_serving: dict):
    """Serve from a tree quantized on the card at full 7B width, 32 layers:
    `batch_infer`, then `BatchedServer` in `modes`. Returns the serving
    runs' launch counts."""
    t0 = time.perf_counter()
    params = init_llark_params(cfg, seed=SEED, device="cuda")
    before = param_bytes(params)
    if wq == "int8":
        params = quant.quantize_params_int8_incremental(cfg, params)
    else:
        params = quant.quantize_params_int4_incremental(cfg, params, group=WQ_GROUP, layout="rows")
    torch.cuda.synchronize()
    head = params["lm_head"]
    print(f"{wq} weights: {before / 1e9:.3f} GB of bf16 params quantized on the card to "
          f"{param_bytes(params) / 1e9:.3f} GB in {time.perf_counter() - t0:.2f} s (init included); "
          f"lm_head leaves {sorted(head)}")
    check(all(isinstance(params["layers"][name], dict) for name in
              ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")), "a projection is not quantized")
    _, main = run_main_path(cfg, bundle, rows, params=params, wq=wq)
    beside(f"batch_infer and one request, {wq} weights", main, bf16_main)
    launches, figures = run_serving_engine(cfg, bundle, params=params, modes=modes, wq=wq)
    for label, got in figures.items():
        beside(f"serving ({label}), {wq} weights", got, bf16_serving[label])
    return launches


@torch.inference_mode()
def check_int4_cols(cfg: ModelConfig) -> None:
    """The default layout of `quantize_params_int4_incremental` (cols: no
    kernel, plain PyTorch) on the card at 7B width, 2 layers: one forward
    against the same tree dequantized to bf16 weights."""
    small = dataclasses.replace(cfg, num_layers=2)
    params = quant.quantize_params_int4_incremental(
        small, init_llark_params(small, seed=SEED, device="cuda"))
    check("q4c" in params["layers"]["w_down"] and "q4c" in params["lm_head"],
          "the default int4 layout is not cols")
    ids = torch.from_numpy(np.random.RandomState(SEED).randint(4, 2000, (2, 64))).cuda()
    reset_wq_counts()
    got, _ = decoder_forward(small, params, input_ids=ids)
    torch.cuda.synchronize()
    check(all(fn.launches == 0 for fn in WQ_KERNELS.values()), "the cols layout launched a kernel")
    dense = dict(params, lm_head=quant.dequantize_weight_int4_cols(params["lm_head"], torch.bfloat16))
    dense["layers"] = {
        name: quant.dequantize_weight_int4_cols(w, torch.bfloat16) if isinstance(w, dict) else w
        for name, w in params["layers"].items()}
    want, _ = decoder_forward(small, dense, input_ids=ids)
    check(bool(torch.isfinite(got).all()), "int4 cols: non-finite logits")
    rel, diff = rel_err(got, want)
    print(f"int4 cols layout, 7B width, 2 layers, [2, 64] tokens: logits vs the dequantized "
          f"tree max|d| {diff:.3e}, rel-to-max {rel:.3e}")
    check(rel <= LOGITS_TOL, f"int4 cols logits rel err {rel:.3e} > {LOGITS_TOL}")
    del params, dense
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8 (fp32): every kernel on fp32 inputs
# ---------------------------------------------------------------------------

# The kernels round fp32 q, k, v, dO (K1, K3+K4) and x (K5, K6) to bf16 as
# they stage them, for bf16 products with fp32 accumulators, and write fp32
# outputs; K2 reads fp32 as it is. Each is held against its fp32 plain
# version at the bf16 kernels' per-row gates (ROW_TOL). The log-sum-exp then
# carries the rounding of the scores (q.k of bf16-rounded operands, about
# 2**-8 of |s| each) and is held to FP32_LSE_TOL, absolute: an H100 80GB
# HBM3 at 700 W read 5.3e-3 and 6.5e-3 on random [2, 8, 200, 64 | 128]
# inputs (PERF.md). FP32_BWD_NOTE: the rounding of q, k, v, dO alone moves a
# dq row near cancellation by up to 8.5e-2 of its norm (the plain version on
# rounded against unrounded operands, [2, 32, 1024, 128], PERF.md), so the
# backward's per-row gate holds it against its plain version on the rounded
# operands, and against the unrounded ones relative to max (BWD_TOL).
FP32_LSE_TOL = 2e-2


def fp32_randn(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device="cuda")


def check_fp32_kernels(gen: torch.Generator) -> None:
    """K1 (with and without its log-sum-exp), K3+K4, K2 in all four cache
    modes, K5 and K6 on fp32 inputs against their fp32 plain versions, each
    launch counted."""
    def launched(fn, counter, before):
        out = fn()
        torch.cuda.synchronize()
        check(counter() > before, "an fp32 call did not launch its kernel")
        return out

    b, h, s, d = 2, 32, 1024, 128
    kv = torch.tensor(TRAIN_LENGTHS, device="cuda")
    for hkv, dd, alibi in ((h, d, False), (8, 64, True)):
        q, do = fp32_randn(gen, b, h, s, dd), fp32_randn(gen, b, h, s, dd)
        k, v = fp32_randn(gen, b, hkv, s, dd), fp32_randn(gen, b, hkv, s, dd)
        kw = dict(causal=True, kv_lengths=kv, slopes=attn_ops.alibi_slopes(h, "cuda") if alibi else None)
        name = f"fp32 [{b},{h},{s},{dd}] Hkv={hkv}{' ALiBi' if alibi else ''}"
        fwd = attn_ops.flash_attention_fwd
        got = launched(lambda: fwd(q, k, v, **kw), lambda: fwd.launches, fwd.launches)
        out, lse = launched(lambda: fwd(q, k, v, return_lse=True, **kw), lambda: fwd.launches,
                            fwd.launches)
        check(got.dtype == torch.float32 and out.dtype == torch.float32, f"fp32 K1 output is {got.dtype}")
        want, lse_p = attn_ops._flash_attention_fwd_plain(q, k, v, return_lse=True, **kw)
        check_close("flash_fwd", name, got, want)
        lse_err = (lse - lse_p).abs().max().item()
        print(f"flash_fwd log-sum-exp {name}: max|d| {lse_err:.3e}")
        check(lse_err <= FP32_LSE_TOL, f"fp32 log-sum-exp {name}: {lse_err:.3e} > {FP32_LSE_TOL}")
        bwd = attn_ops.flash_attention_bwd
        grads = launched(lambda: bwd(q, k, v, out, lse, do, **kw), lambda: bwd.launches, bwd.launches)
        plain = attn_ops._flash_bwd_plain(q, k, v, do, lse, attn_ops._flash_bwd_delta(out, do), **kw)
        # the per-row gate against the plain version on the operands rounded
        # as the kernel rounds them (FP32_BWD_NOTE); against the unrounded
        # ones relative to max
        qr, kr, vr, dr = (t.to(torch.bfloat16).float() for t in (q, k, v, do))
        rounded = attn_ops._flash_bwd_plain(qr, kr, vr, dr, lse, attn_ops._flash_bwd_delta(out, dr), **kw)
        for part, g, w, r in zip(("dq", "dk", "dv"), grads, plain, rounded):
            check(g.dtype == torch.float32, f"fp32 {part} is {g.dtype}")
            check_close("flash_bwd", f"{part} {name} (rounded operands)", g, r)
            rel, _ = rel_err(g, w)
            row = row_err(g, w, ROW_FLOOR["flash_bwd"])
            print(f"flash_bwd {part} {name} against the unrounded operands: rel-to-max {rel:.3e}, "
                  f"worst row {row:.3e} (not gated)")
            check(rel <= BWD_TOL, f"fp32 {part} {name}: rel-to-max {rel:.3e} > {BWD_TOL}")
    # K2: q [8,32,1,128] and Sq = 5 with GQA, fp32 or int8 caches, dense
    # and paged (128-token blocks, scattered tables)
    dec = dec_ops.flash_decode_attention
    lengths = torch.tensor(SERVE_LENGTHS, device="cuda")
    for cache in ("fp32", "int8"):
        for paged in (False, True):
            for sq, hkv in ((1, 32), (5, 8)):
                q = fp32_randn(gen, 8, 32, sq, 128)
                k, v = fp32_randn(gen, 8, hkv, 2048, 128), fp32_randn(gen, 8, hkv, 2048, 128)
                kw = dict(kv_lengths=lengths, q_positions=lengths - sq, k_scale=None, v_scale=None,
                          block_tables=None)
                if cache == "int8":
                    k, kw["k_scale"] = _quantize_kv(k)
                    v, kw["v_scale"] = _quantize_kv(v)
                if paged:
                    perm = torch.randperm(8 * 16, generator=gen, device="cuda")
                    kw["block_tables"] = perm.reshape(8, 16).to(torch.int32)
                    def pool(t):
                        blocks = t.reshape(8, hkv, 16, 128, *t.shape[3:]).transpose(1, 2)
                        blocks = blocks.reshape(8 * 16, hkv, 128, *t.shape[3:])
                        out = torch.empty_like(blocks)
                        out[perm] = blocks
                        return out
                    k, v = pool(k), pool(v)
                    if cache == "int8":
                        kw["k_scale"], kw["v_scale"] = pool(kw["k_scale"]), pool(kw["v_scale"])
                mode = ("paged_" if paged else "dense_") + cache
                before = dec.launches_by_mode[mode]
                got = launched(lambda: dec(q, k, v, **kw), lambda: dec.launches_by_mode[mode], before)
                want = dec_ops._flash_decode_plain(q, k, v, slopes=None, **kw)
                check(got.dtype == torch.float32, f"fp32 K2 output is {got.dtype}")
                check_close("flash_decode", f"fp32 q, {mode} cache, Sq={sq} Hkv={hkv}", got, want)
    # K5, K6: each regime at a 7B projection
    k_, n_ = WQ_SHAPES[0]
    w8, w4, _ = wq_case(gen, k_, n_)
    for m in (1, 9, 17, 65, 2048):
        x = fp32_randn(gen, m, k_)
        for fmt, wq in (("int8", w8), ("int4", w4)):
            fn = WQ_KERNELS[fmt]
            got = launched(lambda: wq_run(fmt, x, wq), lambda: fn.launches, fn.launches)
            check(got.dtype == torch.float32, f"fp32 {fmt} output is {got.dtype}")
            check_close(f"{fmt}_matmul", f"fp32 M={m} (K,N)=({k_},{n_})", got,
                        wq_run(fmt, x, wq, plain=True))


# ---------------------------------------------------------------------------
# phase 8: training kernels against their plain versions
# ---------------------------------------------------------------------------

TRAIN_SHAPE = (2, 32, 1024, 128)  # the training path's q/k/v: batch 2, 1024 tokens
TRAIN_LENGTHS = [1024, 700]


def check_flash_bwd(gen: torch.Generator):
    """The forward's LSE and the backward's dq, dk and dv against their
    plain versions; the worst max |diff| of each."""
    b, h, s, d = TRAIN_SHAPE
    cases = [
        (f"main path [{b},{h},{s},{d}] causal, kv_len {TRAIN_LENGTHS}", h, d, False),
        ("GQA Hkv=8 + ALiBi", 8, d, True),
        ("head_dim 64", h, 64, False),
    ]
    worst = {"flash_fwd_lse": 0.0, "flash_bwd": 0.0}
    for name, hkv, dd, alibi in cases:
        q, do = bf16_randn(gen, b, h, s, dd), bf16_randn(gen, b, h, s, dd)
        k, v = bf16_randn(gen, b, hkv, s, dd), bf16_randn(gen, b, hkv, s, dd)
        kv = torch.tensor(TRAIN_LENGTHS, device="cuda")
        kw = dict(causal=True, kv_lengths=kv, slopes=attn_ops.alibi_slopes(h, "cuda") if alibi else None)
        out, lse = attn_ops.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        _, lse_p = attn_ops._flash_attention_fwd_plain(q, k, v, return_lse=True, **kw)
        lse_err = (lse - lse_p).abs().max().item()
        print(f"flash_fwd log-sum-exp {name}: max|d| {lse_err:.3e}")
        check(lse_err <= LSE_TOL, f"log-sum-exp {name}: {lse_err:.3e} > {LSE_TOL}")
        worst["flash_fwd_lse"] = max(worst["flash_fwd_lse"], lse_err)
        grads = attn_ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        delta = attn_ops._flash_bwd_delta(out, do)
        plain = attn_ops._flash_bwd_plain(q, k, v, do, lse, delta, **kw)
        for part, got, want in zip(("dq", "dk", "dv"), grads, plain):
            err = check_close("flash_bwd", f"{part} {name}", got, want)
            worst["flash_bwd"] = max(worst["flash_bwd"], err)
            if part != "dq":  # keys at or past kv_len get exact zeros
                check(bool((got[1, :, TRAIN_LENGTHS[1]:] == 0).all()), f"{part}: a dead key is not zeros")
    return worst


# ---------------------------------------------------------------------------
# phases 9-11: the training path
# ---------------------------------------------------------------------------

# one step at 7B width, kernel path vs plain attention path (both bf16): the
# loss read 3.2e-3 apart and the projector gradient 1.15e-2 relative to max
# on an H100 80GB HBM3 at 700 W; the limits sit a few bf16 ulps above
TRAIN_ABS_LOSS_TOL = 1e-2
TRAIN_GRAD_TOL = 3e-2
# phase 10's depths, cut so that the script keeps inside its time limit
# (train() writes the whole state at its end: 27 GB of fp32 parameters at
# 32 layers); the adapter stage from 32, the run-of-record flags from 4
ADAPTER_LAYERS = 8
FULL_LAYERS = 2


def write_shards(directory: str, cfg: ModelConfig) -> str:
    """4 identical samples (one question, one answer, a [256, 4800] random
    encoding made from the seed): every training batch holds the same
    example, so the loss of a few steps must fall."""
    enc = np.random.RandomState(SEED).randn(256, cfg.mm_hidden_size).astype(np.float32)
    writer = TarShardWriter(os.path.join(directory, "mir-train-%05d.tar"), max_count=100)
    for i in range(4):
        writer.write({
            "__key__": f"clip{i:03d}",
            "json": {"response": [{"question": "What is the tempo of this piece ?",
                                   "answer": "It is a slow ballad at 70 beats per minute ."}]},
            "audio_encoding.pyd": enc,
        })
    writer.close()
    return writer.written_paths[0]


def train_args(directory: str, shard: str, steps: int, lr: float = 1e-3, seq: int = 1024,
               train_flags=None, **flags):
    """`train()`'s arguments: batch 2 x 2 of `seq` positions, the last
    step profiled; `flags` are ModelArguments, `train_flags`
    TrainingArguments."""
    model_args = ModelArguments(model_name_or_path="llama2-7b", **flags)
    data_args = DataArguments(train_data_path=shard, max_audio_frames=256,
                              task_sample_probs={"mir": 1.0})
    training_args = TrainingArguments(
        output_dir=os.path.join(directory, "out"), per_device_train_batch_size=2,
        gradient_accumulation_steps=2, model_max_length=seq, learning_rate=lr,
        max_steps=steps, save_steps=10**6, logging_steps=1, seed=SEED,
        profile_dir=os.path.join(directory, "profile"), profile_start_step=steps - 1,
        profile_num_steps=1, checkpoint_on_preemption=False, **(train_flags or {}),
    )
    return model_args, data_args, training_args


def check_gradient_through_kernels(cfg: ModelConfig, directory: str, shard: str) -> None:
    """One training step's loss and projector gradient at 7B width and 2
    layers, with the flash kernels and with the plain attention path: the
    kernels' backward reaches q, k and v."""
    small = dataclasses.replace(cfg, num_layers=2)
    model_args, data_args, training_args = train_args(directory, shard, 1)
    bundle = TokenizerBundle.from_tokenizer(WordTokenizer(1024))
    batch = next(iter(make_data_module(
        bundle, data_args, batch_size=2, max_seq_len=1024, mm_hidden_size=cfg.mm_hidden_size,
        seed=SEED)["train_iterator"]()))
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items() if isinstance(v, np.ndarray)}
    params = init_llark_params(small, seed=SEED, device="cuda")
    proj = params["mm_projector"]["kernel"].requires_grad_()
    results = {}
    for use_kernels in (True, False):
        c = dataclasses.replace(small, use_pallas_attention=use_kernels)
        attn_ops.flash_attention_bwd.launches = 0
        loss, _, _ = make_loss_fn(c, audio_patch_id=bundle.audio_patch_id)(params, batch)
        (grad,) = torch.autograd.grad(loss, [proj])
        results[use_kernels] = (loss.item(), grad, attn_ops.flash_attention_bwd.launches)
    (lk, gk, nk), (lp, gp, _) = results[True], results[False]
    rel, _ = rel_err(gk, gp)
    print(f"7B width, 2 layers, one step: loss {lk:.5f} (kernels) vs {lp:.5f} (plain), "
          f"projector gradient rel-to-max {rel:.3e}, |grad| {gk.norm().item():.4e} vs "
          f"{gp.norm().item():.4e}; flash backward launches {nk}")
    check(nk == small.num_layers, "the kernel path did not run the flash backward")
    check(abs(lk - lp) <= TRAIN_ABS_LOSS_TOL, f"loss differs by {abs(lk - lp):.3e}")
    check(rel <= TRAIN_GRAD_TOL, f"projector gradient rel err {rel:.3e} > {TRAIN_GRAD_TOL}")
    del params, proj, batch
    torch.cuda.empty_cache()


def device_split(trace_path: str, wall_ms: float, top: int = 6, span: str = None) -> None:
    """Device kernel time of one profiled train step (its chrome trace)
    beside the unprofiled median step time: the card's idle share. With
    `span`, also the device time of the kernels launched inside the CPU
    ranges of that name (an autograd node's backward: the host calls that
    launched them lie inside the range, on its thread)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            kernels.setdefault(e["name"], [0.0, 0])
            kernels[e["name"]][0] += e.get("dur", 0.0) / 1e3
            kernels[e["name"]][1] += 1
    busy = sum(ms for ms, _ in kernels.values())
    if busy <= 0:
        print("device busy time: not measured (the trace holds no device kernels)")
        return
    print(f"  one step: device kernels {busy:.1f} ms against a median step of {wall_ms:.1f} ms, "
          f"idle share {1 - busy / wall_ms:.1%}")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {ms:8.2f} ms  x{n:<5d} {name[:90]}")
    if span is not None:
        span_kernels(events, span)


def span_kernels(events: list, span: str) -> None:
    """Device ms of the kernels whose launch lies inside a CPU range named
    `span`; a quantized-product kernel among them would mean the range also
    held a recomputed forward, and fails."""
    ranges = {}
    for e in events:
        if e.get("cat") == "cpu_op" and e.get("name") == span:
            ranges.setdefault(e["tid"], []).append((e["ts"], e["ts"] + e["dur"]))
    inside = set()
    for e in events:
        # the launch calls: the runtime and lower-level API categories
        if e.get("cat", "").startswith("cuda_") and any(
                a <= e["ts"] <= b for a, b in ranges.get(e.get("tid"), ())):
            inside.add(e.get("args", {}).get("correlation"))
    hit = [e for e in events if e.get("cat") == "kernel" and e["args"].get("correlation") in inside]
    n = sum(len(r) for r in ranges.values())
    ms = sum(e.get("dur", 0.0) for e in hit) / 1e3
    print(f"  dx products (kernels launched in {n} {span} ranges): {ms:.2f} ms of device time, "
          f"{len(hit)} kernels")
    check(n > 0 and hit, f"the trace holds no kernel launched in {span}")
    check(not any("wq_matmul_kernel" in e["name"] for e in hit),
          f"a quantized-product kernel launched inside {span}")


def run_training(label: str, cfg: ModelConfig, directory: str, shard: str, steps: int,
                 frozen_base: bool, lr: float, seq: int = 1024, train_flags=None,
                 keep: bool = False, span: str = None, **flags):
    """Drive `train()` on the card; check and print what the path did.
    Returns the launches in the run of the two training kernel wrappers and
    of the two quantized products, and with `keep` train()'s result (the
    run directory is then left on disk). `span` names a CPU range whose
    kernels the profiled step's trace reads (see `span_kernels`)."""
    model_args, data_args, training_args = train_args(directory, shard, steps, lr, seq,
                                                      train_flags, **flags)
    torch.cuda.reset_peak_memory_stats()
    counters = (attn_ops.flash_attention_fwd, attn_ops.flash_attention_bwd,
                int8_ops.int8_matmul, int4_ops.int4_matmul)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    result = train(model_args, data_args, training_args, model_cfg=cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    losses = result["losses"]
    with open(os.path.join(training_args.output_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    # the first step warms up, the last one is profiled
    step_ms = statistics.median(r["step_time_s"] for r in records[1:-1]) * 1e3
    tokens = (training_args.per_device_train_batch_size * training_args.gradient_accumulation_steps
              * training_args.model_max_length)
    tok_s = tokens / (step_ms / 1e3)
    # the run's cfg: with LoRA it carries the rank, and the flops its term
    mfu = flops.train_mfu(result["cfg"], training_args.model_max_length, tok_s,
                          frozen_base=frozen_base)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"{label}: {steps} steps in {wall:.1f} s; losses {[round(x, 4) for x in losses]}; "
          f"grad norms {[round(r['grad_norm'], 4) for r in records]}")
    print(f"  median step {step_ms:.1f} ms, {tok_s:.0f} tokens/s (batch 2 x 2 x {seq} positions), "
          f"MFU {mfu:.1%}, peak memory {peak_gb:.2f} GiB, launches per step "
          f"{ {k: v / steps for k, v in launches.items()} }")
    device_split(os.path.join(training_args.profile_dir, "trace.json"), step_ms, span=span)
    check(result["final_step"] == steps, f"{label}: stopped at step {result['final_step']}")
    check(all(np.isfinite(r["grad_norm"]) for r in records), f"{label}: a non-finite grad norm")
    check(losses[-1] < losses[0], f"{label}: the loss did not fall ({losses[0]:.4f} -> {losses[-1]:.4f})")
    check(launches["flash_attention_fwd"] > 0 and launches["flash_attention_bwd"] > 0,
          f"{label}: a training kernel never launched: {launches}")
    # one backward per layer per micro-batch
    per_step = training_args.gradient_accumulation_steps * cfg.num_layers
    check(launches["flash_attention_bwd"] == steps * per_step,
          f"{label}: {launches['flash_attention_bwd']} flash backward launches, not {steps} x {per_step}")
    # the forward once per layer per micro-batch, and again in remat's
    # recomputation
    fwd_per_step = per_step * (2 if cfg.remat else 1)
    check(launches["flash_attention_fwd"] == steps * fwd_per_step,
          f"{label}: {launches['flash_attention_fwd']} flash forward launches, not {steps} x {fwd_per_step}")
    if keep:
        return launches, result
    del result
    shutil.rmtree(directory)  # the checkpoint: 27 GB at 32 layers
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 12: training kernels' timings
# ---------------------------------------------------------------------------


def time_flash_bwd(gen):
    """Timings at the training shape: the forward with its log-sum-exp
    (printed) and the whole flash backward (delta, the products, dq's
    rounding): (ms, plain_ms, library_ms, (bound_ms, bound_by), shape)."""
    b, h, s, d = TRAIN_SHAPE
    q, k, v, do = (bf16_randn(gen, b, h, s, d) for _ in range(4))
    kv = torch.tensor(TRAIN_LENGTHS, dtype=torch.int32, device="cuda")
    kw = dict(causal=True, kv_lengths=kv, slopes=None)
    out, lse = attn_ops.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    # library yardstick: SDPA forward and backward (dq, dk and dv together)
    # at the same mask; no query row here is without a visible key, which
    # would make SDPA's softmax NaN
    pos = torch.arange(s, device="cuda")
    mask = ((pos[None, :] <= pos[:, None]) & (pos[None, :] < kv[:, None, None]))[:, None]
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    lib_out = sdpa(ql, kl, vl, mask)
    # visible (query, key) pairs; the forward does 2 products of 2*D FLOPs
    # per pair, the backward 5; bytes: inputs read once (bf16 q, dO and O
    # whole, k and v up to each row's kv_len only; fp32 lse), outputs
    # written once (dq, dk, dv whole: dead keys get zeros)
    qi, ki = np.arange(s)[:, None], np.arange(s)[None, :]
    pairs = sum(int(((ki <= qi) & (ki < n)).sum()) for n in TRAIN_LENGTHS) * h
    tensor = 2 * b * h * s * d  # one bf16 [B, H, S, D]
    live_kv = 2 * h * d * sum(TRAIN_LENGTHS)  # one bf16 k or v, live rows
    fwd_ms = median_ms(lambda: attn_ops.flash_attention_fwd(q, k, v, return_lse=True, **kw))
    fwd_plain = median_ms(lambda: attn_ops._flash_attention_fwd_plain(q, k, v, return_lse=True, **kw))
    fwd_lib = median_ms(lambda: sdpa(q, k, v, mask))
    fwd_bound, fwd_by = bound(2 * tensor + 2 * live_kv + 4 * b * h * s, 4.0 * d * pairs)
    print(f"flash_fwd with log-sum-exp at [{b},{h},{s},{d}] causal, kv_len {TRAIN_LENGTHS}: "
          f"kernel {fwd_ms:.4f} ms, plain {fwd_plain:.4f} ms, SDPA {fwd_lib:.4f} ms, "
          f"bound {fwd_bound:.4f} ms ({fwd_by}), {fwd_bound / fwd_ms:.1%} of bound")

    def plain_bwd():
        delta = attn_ops._flash_bwd_delta(out, do)
        return attn_ops._flash_bwd_plain(q, k, v, do, lse, delta, **kw)

    bwd_ms = median_ms(lambda: attn_ops.flash_attention_bwd(q, k, v, out, lse, do, **kw))
    plain_ms = median_ms(plain_bwd)
    lib_ms = median_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do, retain_graph=True))
    delta_ms = median_ms(lambda: attn_ops._flash_bwd_delta(out, do))
    bwd_bound = bound(3 * tensor + 2 * live_kv + 4 * b * h * s + 3 * tensor, 10.0 * d * pairs)
    shape = f"[{b},{h},{s},{d}] causal, kv_len {TRAIN_LENGTHS}"
    print(f"  the PyTorch delta the two-kernel backward computed beforehand, "
          f"(g.float() * out.float()).sum(-1), alone: {delta_ms:.4f} ms")
    # second reference, not the yardstick: SDPA is_causal=True (PyTorch's
    # flash backend) with every key live, beside the kernels at kv_len [s, s]
    full = torch.full((b,), s, dtype=torch.int32, device="cuda")
    out_f, lse_f = attn_ops.flash_attention_fwd(q, k, v, causal=True, kv_lengths=full, return_lse=True)
    full_ms = median_ms(lambda: attn_ops.flash_attention_bwd(
        q, k, v, out_f, lse_f, do, causal=True, kv_lengths=full))
    lib_c = torch.nn.functional.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    lib_c_ms = median_ms(lambda: torch.autograd.grad(lib_c, (ql, kl, vl), do, retain_graph=True))
    print(f"  at kv_len [{s}, {s}]: flash backward {full_ms:.4f} ms, SDPA is_causal=True backward "
          f"{lib_c_ms:.4f} ms (dq, dk and dv)")
    # K1 beside SDPA is_causal=True with every key live
    full_lse = median_ms(lambda: attn_ops.flash_attention_fwd(
        q, k, v, causal=True, kv_lengths=full, return_lse=True))
    full_fwd = median_ms(lambda: attn_ops.flash_attention_fwd(q, k, v, causal=True, kv_lengths=full))
    full_plain = median_ms(lambda: attn_ops._flash_attention_fwd_plain(
        q, k, v, causal=True, kv_lengths=full, slopes=None, return_lse=True))
    lib_fwd = median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True))
    full_pairs = b * h * s * (s + 1) // 2
    full_bound, full_by = bound(4 * tensor + 4 * b * h * s, 4.0 * d * full_pairs)
    print(f"  at kv_len [{s}, {s}]: flash_fwd with log-sum-exp {full_lse:.4f} ms, without "
          f"{full_fwd:.4f} ms, plain (with log-sum-exp) {full_plain:.4f} ms, SDPA is_causal=True "
          f"forward {lib_fwd:.4f} ms, bound "
          f"{full_bound:.4f} ms ({full_by}), {full_bound / full_lse:.1%} of bound")
    return bwd_ms, plain_ms, lib_ms, bwd_bound, shape


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 17: checkpoint I/O and the WebDataset CLI at Llama-2-7B width
# ---------------------------------------------------------------------------

# a 32-layer export writes 27 GB of fp32 on the host, and reads as much
# back, within the script's limit: depth is cut to 2 layers (from 4 in PR 19)
CKPT_LAYERS = 2
ST_DTYPE_NAMES = {torch.float32: "F32", torch.bfloat16: "BF16"}


def seconds(fn):
    """(fn(), its wall seconds, the card synchronised on both sides)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def write_safetensors(path: str, tensors: dict) -> None:
    """A .safetensors file written by the format itself (no package): the
    header's length as 8 little-endian bytes, a JSON header of dtype, shape
    and data offsets, padded to 8 bytes, then the raw little-endian data."""
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": ST_DTYPE_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            f.write(t.contiguous().view(torch.uint8).numpy().data)


def write_safetensors_shards(directory: str, sd: dict, n_shards: int = 2) -> int:
    """`sd` as `n_shards` .safetensors files and their index; bytes written."""
    keys = list(sd)
    weight_map, total = {}, 0
    for s in range(n_shards):
        fname = f"model-{s + 1:05d}-of-{n_shards:05d}.safetensors"
        part = {k: sd[k] for k in keys[s::n_shards]}
        write_safetensors(os.path.join(directory, fname), part)
        weight_map.update(dict.fromkeys(part, fname))
        total += os.path.getsize(os.path.join(directory, fname))
    with open(os.path.join(directory, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    return total


@contextlib.contextmanager
def first_step_params():
    """Inside, `train()`'s first step records a copy of the backbone it
    receives (the list this yields holds it) before it runs."""
    seen = []
    make = train_mod.make_train_step

    def make_watched(*args, **kw):
        step = make(*args, **kw)

        def watched(state, batch):
            if not seen:
                seen.append({k: {n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                             else v.clone() for k, v in state.params.items()
                             if k != "mm_projector"})
            return step(state, batch)
        return watched

    train_mod.make_train_step = make_watched
    try:
        yield seen
    finally:
        train_mod.make_train_step = make


def backbone_equal(got: dict, want: dict, top=("embed", "final_norm_scale", "lm_head")) -> list:
    """Names of the backbone leaves of `got` (the layers and `top`) that
    differ from `want` (cast to got's dtype) in any bit."""
    bad = []
    for name in top:
        if not torch.equal(got[name], want[name].to(got[name].dtype)):
            bad.append(name)
    for name, t in want["layers"].items():
        if not torch.equal(got["layers"][name], t.to(got["layers"][name].dtype)):
            bad.append(f"layers/{name}")
    return bad


def write_eval_shard(directory: str, cfg: ModelConfig) -> tuple:
    """A 4-row eval shard: crop-window keys in the packer's encoding, a
    question each, random [256, 4800] encodings from the seed. Returns its
    path and the example ids the CLI must restore."""
    rng = np.random.RandomState(SEED + 17)
    questions = ["What is the tempo of this piece ?", "Which instruments play ?",
                 "What is the key of this piece ?", "Describe the audio ."]
    writer = TarShardWriter(os.path.join(directory, "eval-%05d.tar"), max_count=100)
    for i, question in enumerate(questions):
        writer.write({
            "__key__": f"clip{i:03d}-start30_000-end60_000",
            "json": {"response": [{"question": question, "answer": "a slow ballad ."}]},
            "audio_encoding.pyd": rng.randn(256, cfg.mm_hidden_size).astype(np.float32),
        })
    writer.close()
    return writer.written_paths[0], [f"clip{i:03d}-start30.000-end60.000" for i in range(4)]


def run_webdataset_cli(label: str, run_dir: str, shard: str, ids: list, flags: list,
                       smi: str) -> tuple:
    """`from_webdataset.main` over the shard; returns its CSV rows and the
    flash kernels' launches of that run."""
    out_csv = os.path.join(run_dir, f"eval-{label.split()[0]}.csv")
    attn_ops.flash_attention_fwd.launches = 0
    dec_ops.reset_launch_counts()
    _, wall = seconds(lambda: from_webdataset.main([
        "--checkpoint-dir", run_dir, "--input", shard, "--output", out_csv,
        "--max-new-tokens", "32", "--max-cache-len", "2048", *flags]))
    launches = {"flash_fwd": attn_ops.flash_attention_fwd.launches,
                **{k: v for k, v in dec_ops.flash_decode_attention.launches_by_mode.items() if v}}
    with open(out_csv, newline="") as f:
        rows = list(csv.DictReader(f))
    print(f"from_webdataset ({label}, {smi}): {len(rows)} rows in {wall:.2f} s, "
          f"{wall / max(len(rows), 1):.3f} s per request (the model's load included); "
          f"launches {launches}")
    check(len(rows) == len(ids), f"from_webdataset ({label}): {len(rows)} CSV rows, not {len(ids)}")
    check([r["example_id"] for r in rows] == ids,
          f"from_webdataset ({label}): example ids {[r['example_id'] for r in rows]}")
    return rows, launches


def run_checkpoint_io(directory: str, train_shard: str, smi: str) -> None:
    """Export a seeded bf16 tree at 7B width, import it into `train()`, and
    serve the result through the WebDataset CLI twice."""
    cfg = ModelConfig.llama2_7b(num_layers=CKPT_LAYERS, param_dtype="bfloat16")
    params = init_llark_params(cfg, seed=SEED, device="cuda")
    hf_dir = os.path.join(directory, "hf")
    bin_path = os.path.join(hf_dir, "pytorch_model.bin")

    # (a) export: fp32 pytorch_model.bin, then the same state dict as two
    # bf16 safetensors shards; both must read back bitwise alike
    _, export_s = seconds(lambda: hf.save_hf_checkpoint(hf_dir, cfg, params))
    bin_gb = os.path.getsize(bin_path) / 1e9
    from_bin, bin_read_s = seconds(lambda: hf.load_hf_state_dict(bin_path))
    st_bytes, st_write_s = seconds(lambda: write_safetensors_shards(
        hf_dir, {k: v.to(torch.bfloat16) for k, v in from_bin.items()}))
    st_gb = st_bytes / 1e9

    def read_and_compare():
        from_st = hf.load_hf_state_dict(hf_dir)  # the index comes first
        check(sorted(from_st) == sorted(from_bin), "the safetensors shards hold other tensors")
        return [k for k in from_bin if from_st[k].dtype != torch.bfloat16
                or not torch.equal(from_st[k].float(), from_bin[k])]

    differ, st_read_s = seconds(read_and_compare)
    print(f"checkpoint I/O ({smi}), Llama-2-7B width, {CKPT_LAYERS} layers, bf16 params: "
          f"export {export_s:.2f} s ({bin_gb:.3f} GB fp32 pytorch_model.bin, "
          f"{bin_gb / export_s:.2f} GB/s); .bin read {bin_read_s:.2f} s "
          f"({bin_gb / bin_read_s:.2f} GB/s); safetensors write {st_write_s:.2f} s "
          f"({st_gb:.3f} GB bf16, 2 shards); safetensors read and compare {st_read_s:.2f} s "
          f"({st_gb / st_read_s:.2f} GB/s); {len(from_bin)} tensors")
    check(not differ, f"safetensors and .bin differ in {differ[:5]}")
    check("model.mm_projector.weight" in from_bin, "the export lost the projector")
    del from_bin
    imported, import_s = seconds(lambda: hf.load_pretrained_backbone(hf_dir, cfg, device="cuda"))
    print(f"  load_pretrained_backbone onto the card (safetensors, bf16): "
          f"{import_s:.2f} s ({st_gb / import_s:.2f} GB/s)")
    bad = backbone_equal(imported, params)
    check(not bad, f"the imported backbone differs from the exported tree in {bad}")
    del imported

    # (b) train() from the HF directory: the adapter stage's flags, 2 steps
    model_args, data_args, training_args = train_args(
        os.path.join(directory, "train"), train_shard, 2, freeze_backbone=True,
        tune_mm_mlp_adapter=True)
    model_args.model_name_or_path = hf_dir
    training_args.profile_dir = ""
    for fn in (attn_ops.flash_attention_fwd, attn_ops.flash_attention_bwd):
        fn.launches = 0
    native_build.calls.clear()
    with first_step_params() as seen:
        result, train_s = seconds(lambda: train(model_args, data_args, training_args,
                                                device="cuda"))
    train_tar = native_build.calls["tar_samples"]
    check(train_tar > 0, "train() read no sample through the native tar loader")
    run_cfg, tok = result["cfg"], result["bundle"].tokenizer
    losses = result["losses"]
    fwd, bwd = attn_ops.flash_attention_fwd.launches, attn_ops.flash_attention_bwd.launches
    per_step = training_args.gradient_accumulation_steps * run_cfg.num_layers
    print(f"train() from the HF directory ({smi}): {train_s:.1f} s with the import "
          f"and the checkpoint write; losses {[round(x, 4) for x in losses]}; flash forward "
          f"{fwd}, backward {bwd} launches; tokenizer {type(tok).__name__} ({len(tok)} entries)")
    check(len(seen) == 1, "train() ran no step")
    bad = backbone_equal(seen[0], params)
    check(not bad, f"train()'s first step saw a backbone other than the exported one: {bad}")
    check(result["final_step"] == 2 and all(np.isfinite(losses)), f"train(): losses {losses}")
    check(run_cfg.num_layers == CKPT_LAYERS and run_cfg.vocab_size == cfg.vocab_size,
          "train() read another configuration from config.json")
    check(bwd == 2 * per_step and fwd == 2 * per_step * 2,
          f"train(): {fwd} / {bwd} flash launches, not {4 * per_step} / {2 * per_step}")
    # the adapter stage trains the embedding's new-token rows, nothing else
    # of the backbone
    bad = backbone_equal(result["state"].params, params, top=("final_norm_scale", "lm_head"))
    check(not bad, f"the frozen backbone moved in training: {bad}")
    del result, seen
    torch.cuda.empty_cache()

    # (c) serve the run directory through the CLI: one request at a time,
    # then the engine in mode (a)'s cache (paged 128-token blocks, int8 KV,
    # chunked admission); flash decode is the serving configuration's switch
    # (phase 4 sets it too). The CLI's prompt buckets are (128, 512) in both
    # packages, and a paged cache needs a chunk that divides each: 128, where
    # phase 7 reaches 256 with buckets of (512,)
    run_dir = training_args.output_dir
    meta_path = os.path.join(run_dir, "model_config.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["model_config"]["use_flash_decode"] = True
    # a word for each of the model's ids, so that the rows compared below
    # name their tokens (name_every_id)
    shard, ids = write_eval_shard(directory, cfg)
    tok = WordTokenizer.from_dict(meta["tokenizer"])
    name_every_id(TokenizerBundle.from_tokenizer(tok, meta["tokenizer"]["model_max_length"]),
                  meta["model_config"]["vocab_size"],
                  [r["prompt"] for r in from_webdataset.iter_eval_rows([shard])])
    meta["tokenizer"] = {"type": "word", **tok.to_dict()}
    with open(meta_path, "w") as f:
        json.dump(meta, f, indent=2)
    native_build.calls.clear()
    one, one_launches = run_webdataset_cli("one at a time", run_dir, shard, ids, [], smi)
    eng, eng_launches = run_webdataset_cli(
        "engine mode (a)", run_dir, shard, ids,
        ["--continuous-batching", "8", "--kv-block-size", "128", "--kv-cache-int8",
         "--prefill-chunk", "128"], smi)
    cli_tar = native_build.calls["tar_samples"]
    NATIVE_READS["phase 17, the native tar loader"] = (
        f"train() {train_tar} samples, from_webdataset twice {cli_tar}")
    check(cli_tar == 2 * len(ids), f"from_webdataset read {cli_tar} samples through the native "
          f"tar loader, not 2 x {len(ids)}")
    check(one_launches["flash_fwd"] == CKPT_LAYERS * len(ids),
          f"one at a time: {one_launches['flash_fwd']} flash-prefill launches, not "
          f"{CKPT_LAYERS} x {len(ids)}")
    check(set(one_launches) == {"flash_fwd", "dense_bf16"},
          f"one at a time: flash decode launched in {sorted(one_launches)}")
    check(set(eng_launches) == {"flash_fwd", "paged_int8"},
          f"engine mode (a): flash decode launched in {sorted(eng_launches)}")

    # the same rows in this process, on the loaded model
    run_cfg, run_params, bundle = load_pretrained_model(run_dir, device="cuda")
    rows = list(from_webdataset.iter_eval_rows([shard]))
    gen_cfg = GenerationConfig(max_new_tokens=32, temperature=0.0, stop_text="###")
    want_one, one_s = seconds(lambda: batch_infer(rows, Generator(
        run_cfg, run_params, bundle.audio_patch_id, gen_cfg, max_cache_len=2048, device="cuda"),
        bundle))
    want_eng, eng_s = seconds(lambda: batch_infer_continuous(
        rows, dataclasses.replace(run_cfg, kv_cache_quant=True), run_params, bundle,
        gen_cfg=gen_cfg, max_batch=8, max_cache_len=2048, prefill_chunk=128,
        kv_block_size=128, device="cuda"))
    print(f"  in this process, the model loaded ({smi}): batch_infer {one_s / len(rows):.3f} s "
          f"and batch_infer_continuous {eng_s / len(rows):.3f} s per request")
    for label, got, want in (("one at a time", one, want_one), ("engine mode (a)", eng, want_eng)):
        want = [{k: str(v) for k, v in r.items()} for r in want]
        check(got == want, f"from_webdataset ({label}): CSV rows differ from the in-process run")
    print("  CLI rows equal the in-process batch_infer / batch_infer_continuous rows; "
          f"completion 0: {one[0]['model_completion'][:80]!r}")
    check_completions("from_webdataset", one + eng)
    del run_params, params
    shutil.rmtree(directory)  # the export and the run: ~11 GB
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 18: LoRA and QLoRA training at Llama-2-7B width, and serving the run
# ---------------------------------------------------------------------------

# the JAX package's QLoRA configuration (README.md): rank 64, alpha 16,
# dropout 0.05, remat, 512 positions; batch 2 x 2
LORA_SEQ = 512
# the depth of run (c), cut from 32 (its checkpoint alone was 27 GB) so
# that the script keeps inside its time limit (PERF.md section 4). (b) keeps 32:
# at 8 layers the bf16 plain step's own LoRA-B gradient lies 3.1e-2-3.4e-2
# from the same step in fp32, above the 3e-2 gate, and the kernel route
# lies nearer to fp32 than that (tools/qlora_gate_depth.py)
LORA_CUT_LAYERS = 4
LORA_FLAGS = dict(lora_enable=True, lora_r=64, lora_alpha=16, lora_dropout=0.05)
# one step against plain products and plain attention (bf16 both): the
# phase-9 gates (loss 1e-2 absolute, the gradient 3e-2 relative to max) on
# the loss and the LoRA-B gradient (see check_plain_step). The remat
# policies recompute the same ops: their LoRA gradients differ by dq's
# atomics' order alone (1e-2 relative to max)
REMAT_GRAD_TOL = 1e-2


def lora_batch(cfg: ModelConfig, shard: str):
    """One micro-batch (2 rows of LORA_SEQ positions) of the phase-10 shard
    on the card, and its tokenizer bundle."""
    _, data_args, _ = train_args("unused", shard, 1)
    bundle = TokenizerBundle.from_tokenizer(WordTokenizer(LORA_SEQ))
    batch = next(iter(make_data_module(
        bundle, data_args, batch_size=2, max_seq_len=LORA_SEQ,
        mm_hidden_size=cfg.mm_hidden_size, seed=SEED)["train_iterator"]()))
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()
            if isinstance(v, np.ndarray)}, bundle


def lora_grads(cfg: ModelConfig, params, batch, patch_id: int, names):
    """(loss, gradients of the named layer leaves) of one micro-batch, LoRA
    dropout drawn from seed 1."""
    loss, _, _ = make_loss_fn(cfg, audio_patch_id=patch_id)(params, batch, 1)
    return loss.item(), torch.autograd.grad(loss, [params["layers"][n] for n in names])


def kernel_counts() -> dict:
    return {fn.__name__: fn.launches for fn in (
        attn_ops.flash_attention_fwd, attn_ops.flash_attention_bwd,
        int8_ops.int8_matmul, int4_ops.int4_matmul)}


def plain_step_readings(cfg: ModelConfig, params, batch, patch_id: int) -> dict:
    """A LoRA tree's next step four ways: every kernel (K); the quantized
    products' kernels beside plain attention (Q); every product on its plain
    version (P), where no kernel launches; P in fp32 (P32: the compute
    dtype fp32, so the one rounding left is the weights' quantization).
    Returns the losses and the LoRA-B gradients' worst rel-to-max over the
    leaves for each pair read: "gate" Q vs P (the quantized products and
    their dx alone), "attention" K vs Q, "all" K vs P, and against P32:
    "floor" P vs P32 (the bf16 rounding of the plain step itself), "q32" Q
    vs P32."""
    names = [k for k in lora_mod.lora_keys(params) if k.endswith("_lora_b")]
    plain_attention = dataclasses.replace(cfg, use_pallas_attention=False)
    lk, gk = lora_grads(cfg, params, batch, patch_id, names)
    before = kernel_counts()
    lq, gq = lora_grads(plain_attention, params, batch, patch_id, names)
    torch.cuda.synchronize()
    after = kernel_counts()
    ran = {k: after[k] - before[k] for k in after}
    check(ran["flash_attention_fwd"] == ran["flash_attention_bwd"] == 0
          and ran["int8_matmul"] + ran["int4_matmul"] > 0,
          f"the step on plain attention launched {ran}")
    with plain_products():
        lp, gp = lora_grads(plain_attention, params, batch, patch_id, names)
        l32, g32 = lora_grads(dataclasses.replace(plain_attention, dtype="float32"), params,
                              batch, patch_id, names)
    torch.cuda.synchronize()
    check(kernel_counts() == after, "a kernel launched in the plain step")

    def worst(got, want):
        return max(rel_err(a, b)[0] for a, b in zip(got, want))

    return dict(loss_k=lk, loss_q=lq, loss_p=lp, loss_p32=l32, leaves=len(names),
                gate=worst(gq, gp), attention=worst(gk, gq), all=worst(gk, gp),
                floor=worst(gp, g32), q32=worst(gq, g32))


def check_plain_step(label: str, cfg: ModelConfig, params, batch, patch_id: int) -> None:
    """The trained run's next step (plain_step_readings). The loss holds K
    against P; the LoRA-B gradient holds Q against P, with K against Q (the
    attention routes alone) and the fp32 readings printed beside it."""
    r = plain_step_readings(cfg, params, batch, patch_id)
    print(f"  one more step: loss {r['loss_k']:.5f} (kernels) vs {r['loss_q']:.5f} (quantized "
          f"kernels, plain attention) vs {r['loss_p']:.5f} (plain) vs {r['loss_p32']:.5f} (plain, "
          f"fp32); LoRA-B gradient rel-to-max, worst of {r['leaves']} leaves: quantized routes "
          f"alone {r['gate']:.3e}, attention routes alone {r['attention']:.3e}, every kernel "
          f"against every plain version {r['all']:.3e}; against the plain step in fp32: the "
          f"plain step {r['floor']:.3e}, the quantized routes {r['q32']:.3e}")
    check(abs(r["loss_k"] - r["loss_p"]) <= TRAIN_ABS_LOSS_TOL,
          f"{label}: loss differs by {abs(r['loss_k'] - r['loss_p']):.3e}")
    check(r["gate"] <= TRAIN_GRAD_TOL,
          f"{label}: LoRA-B gradient rel err {r['gate']:.3e} > {TRAIN_GRAD_TOL}")


def check_qlora_run(label: str, result, fmt: str, steps: int, launches: dict,
                    run_dir: str) -> None:
    """A QLoRA run: its format's kernel 14 times a layer per micro-batch (7
    in the forward, 7 in remat's recompute: 448 at 32 layers), the other's
    never; the base
    still the quantized seeded init, bit for bit; every LoRA-B moved; the
    adapter files written."""
    cfg, params = result["cfg"], result["state"].params
    per_micro = 2 * 7 * cfg.num_layers
    own, other = (("int8_matmul", "int4_matmul") if fmt == "int8" else ("int4_matmul", "int8_matmul"))
    check(launches[own] == steps * 2 * per_micro,
          f"{label}: {launches[own]} {own} launches, not {steps} x 2 x {per_micro}")
    check(launches[other] == 0, f"{label}: {launches[other]} {other} launches")
    fresh = init_llark_params(cfg, seed=SEED, device="cuda")
    if fmt == "int8":
        fresh = quant.quantize_params_int8_incremental(cfg, fresh)
    else:
        fresh = quant.quantize_params_int4_incremental(
            cfg, fresh, group=min(128, cfg.hidden_size), layout="rows")
    for name in lora_mod.LORA_TARGETS:
        for key, t in params["layers"][name].items():
            check(t.dtype == fresh["layers"][name][key].dtype and torch.equal(
                t, fresh["layers"][name][key]), f"{label}: the base {name}/{key} changed")
    del fresh
    moved = [k for k in lora_mod.lora_keys(params)
             if k.endswith("_lora_b") and params["layers"][k].abs().max().item() > 0]
    check(len(moved) == 7, f"{label}: only {moved} of the LoRA-B leaves moved")
    adapter = os.path.join(run_dir, "adapter")
    check(sorted(os.listdir(adapter)) == ["adapter.npz", "non_lora_trainables.npz"],
          f"{label}: adapter files {os.listdir(adapter)}")
    print(f"  {fmt} base bit for bit the quantized seeded init; all 7 LoRA-B leaves moved; "
          f"{own} launches {launches[own]} ({launches[own] // (2 * steps)} a micro-batch)")


def check_remat_policies(cfg: ModelConfig, batch, patch_id: int) -> None:
    """One micro-batch under "full", "dots" and "dots_narrow", 4 layers,
    int8 base, rank-64 factors with B != 0: the LoRA gradients of the dots
    policies against full's; K5 launched once per product under the dots
    policies (their output kept, not recomputed) and twice under full; K1
    twice either way (recomputed: a kernel, not a product); peak memory."""
    small = dataclasses.replace(cfg, num_layers=4, lora_rank=64, lora_alpha=16.0,
                                lora_dropout=0.05)
    params = init_llark_params(small, seed=SEED, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    params = lora_mod.init_lora_params(small, gen, params)
    for name in lora_mod.lora_keys(params):
        if name.endswith("_lora_b"):
            params["layers"][name].normal_(0.0, 0.01, generator=gen)
    params = quant.quantize_params_int8_incremental(small, params)
    names = lora_mod.lora_keys(params)
    for name in names:
        params["layers"][name].requires_grad_()
    grads = {}
    for policy in ("full", "dots", "dots_narrow"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for fn in WQ_KERNELS.values():
            fn.launches = 0
        attn_ops.flash_attention_fwd.launches = 0
        loss, grads[policy] = lora_grads(dataclasses.replace(small, remat_policy=policy), params,
                                         batch, patch_id, names)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        n8, k1 = int8_ops.int8_matmul.launches, attn_ops.flash_attention_fwd.launches
        rel = max(rel_err(a, b)[0] for a, b in zip(grads[policy], grads["full"]))
        print(f"  remat {policy!r}, 4 layers: loss {loss:.5f}, K5 launches {n8}, K1 {k1}, peak "
              f"above the weights {peak:.2f} GiB, LoRA gradients vs full rel-to-max {rel:.3e}")
        want = 7 * 4 * (2 if policy == "full" else 1)
        check(n8 == want, f"remat {policy!r}: {n8} K5 launches, not {want}")
        check(k1 == 2 * 4, f"remat {policy!r}: {k1} K1 launches, not 8")
        check(rel <= REMAT_GRAD_TOL, f"remat {policy!r}: gradients rel err {rel:.3e}")
    del params, grads
    torch.cuda.empty_cache()


def check_merged(label: str, result, rows) -> None:
    """A LoRA run on the float base: the merged tree's prefill logits
    against the unmerged tree's, one request."""
    cfg, params = result["cfg"], result["state"].params
    result["state"].opt_state = None  # room for the merged copies
    torch.cuda.empty_cache()
    merged = lora_mod.merge_lora(cfg, params)
    check(not lora_mod.lora_keys(merged), f"{label}: factors left after merge_lora")
    bundle = result["bundle"]
    ids = build_prompt_ids(rows[0]["prompt"], 256, bundle)
    s = int(np.ceil(len(ids) / 128) * 128)
    input_ids = np.full((1, s), bundle.pad_token_id, np.int32)
    input_ids[0, :len(ids)] = ids
    args = (input_ids, np.array([len(ids)], np.int32), rows[0]["audio_encoding"][None],
            np.array([256], np.int32))
    gen_cfg = GenerationConfig(max_new_tokens=32)
    with torch.no_grad():
        got = Generator(cfg, merged, bundle.audio_patch_id, gen_cfg, max_cache_len=512).prefill(*args)[0]
        want = Generator(cfg, params, bundle.audio_patch_id, gen_cfg, max_cache_len=512).prefill(*args)[0]
    rel, diff = rel_err(got, want)
    print(f"  merge_lora: prefill logits of the merged tree vs the unmerged tree max|d| {diff:.3e}, "
          f"rel-to-max {rel:.3e}")
    check(rel <= LOGITS_TOL, f"{label}: merged logits rel err {rel:.3e} > {LOGITS_TOL}")
    del merged


def serve_lora_run(run_dir: str, rows) -> dict:
    """(e): the QLoRA run's directory through load_pretrained_model ->
    batch_infer, the int8 base with its factors unmerged, flash decode on:
    K1 once per layer per request, dense K2, 224 K5 launches per decode
    step and none of K6; one decode step's logits against the plain
    products; every request 32 tokens. Returns the run's launches."""
    cfg, params, bundle = load_pretrained_model(run_dir, device="cuda")
    check(cfg.lora_rank == 64 and len(lora_mod.lora_keys(params)) == 14,
          f"the run directory rebuilt rank {cfg.lora_rank}, {len(lora_mod.lora_keys(params))} leaves")
    cfg = dataclasses.replace(cfg, use_flash_decode=True)
    gen_cfg = GenerationConfig(max_new_tokens=32, stop_text="")
    generator = Generator(cfg, params, bundle.audio_patch_id, gen_cfg, max_cache_len=2048)
    attn_ops.flash_attention_fwd.launches = 0
    dec_ops.flash_decode_attention.launches = 0
    reset_wq_counts()
    results, wall = seconds(lambda: batch_infer(rows, generator, bundle))
    launches = {"flash_fwd": attn_ops.flash_attention_fwd.launches,
                "flash_decode": dec_ops.flash_decode_attention.launches,
                "int8_matmul": int8_ops.int8_matmul.launches,
                "int4_matmul": int4_ops.int4_matmul.launches}
    print(f"  (e) batch_infer from the QLoRA run: {len(results)} requests in {wall:.2f} s, "
          f"launches {launches}")
    check(len(results) == len(rows), "batch_infer lost a row")
    check(launches["flash_fwd"] == cfg.num_layers * len(rows),
          f"(e): {launches['flash_fwd']} flash-prefill launches")
    check(launches["flash_decode"] > 0, "(e): flash decode never launched")
    check_wq_counts("(e) batch_infer from the QLoRA run", "int8")
    # the 4 requests as one batch: every request runs 32 tokens
    prompts = [build_prompt_ids(row["prompt"], 256, bundle) for row in rows]
    s = int(np.ceil(max(map(len, prompts)) / 128) * 128)
    input_ids = np.full((len(rows), s), bundle.pad_token_id, np.int32)
    for i, ids in enumerate(prompts):
        input_ids[i, :len(ids)] = ids
    args = (input_ids, np.array(list(map(len, prompts)), np.int32),
            np.stack([row["audio_encoding"] for row in rows]), np.full(len(rows), 256, np.int32))
    lengths = [len(t) for t in generator.generate(*args)]
    check(lengths == [32] * len(rows), f"(e): tokens per request {lengths}")
    logits, cache = generator.prefill(*args)
    token, pos = logits.argmax(-1), torch.from_numpy(args[1]).cuda()
    reset_wq_counts()
    with torch.inference_mode():
        step_k = decode_step(cfg, params, token, cache, pos)[0]
    own = check_wq_counts("(e) one decode step", "int8")
    check(own == PRODUCTS_PER_FORWARD, f"(e): one decode step launched {own} K5 products")
    with torch.inference_mode(), plain_products():
        step_p = decode_step(dataclasses.replace(cfg, use_flash_decode=False), params, token,
                             cache, pos)[0]
    rel, diff = rel_err(step_k, step_p)
    print(f"  (e) one decode step: {own} K5 launches; logits vs plain products max|d| {diff:.3e}, "
          f"rel-to-max {rel:.3e}; every request {lengths[0]} tokens")
    check(rel <= LOGITS_TOL, f"(e): decode logits rel err {rel:.3e} > {LOGITS_TOL}")
    time_operator_dispatch(cfg, params, token, cache, pos)
    del params, generator, cache
    torch.cuda.empty_cache()
    return launches


def time_operator_dispatch(cfg: ModelConfig, params, token, cache, pos, n: int = 15) -> None:
    """One decode step (224 K5 products) with every product called through
    the operator `torch.ops.llark.int8_matmul`, as autograd needs it, and
    called directly, as `int8_matmul` does with grad mode off: host time to
    enqueue the step and its wall time, medians of `n` alternated steps."""
    def operator(x, q, scale):
        return torch.ops.llark.int8_matmul(x, q, scale.reshape(-1))

    def direct(x, q, scale):
        return int8_ops._int8_product(x, q, scale.reshape(-1))

    # the product counts its launches on whatever `int8_matmul` names
    operator.launches = direct.launches = 0
    routes = {"operator": operator, "direct": direct}
    times = {name: ([], []) for name in routes}
    saved = int8_ops.int8_matmul
    try:
        with torch.inference_mode():
            for i in range(n + 2):
                for name, product in routes.items():
                    int8_ops.int8_matmul = product
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    decode_step(cfg, params, token, cache, pos)
                    t1 = time.perf_counter()
                    torch.cuda.synchronize()
                    if i >= 2:  # two warm-up rounds
                        times[name][0].append((t1 - t0) * 1e3)
                        times[name][1].append((time.perf_counter() - t0) * 1e3)
    finally:
        int8_ops.int8_matmul = saved
    (oe, ow), (de, dw) = ([statistics.median(v) for v in times[name]] for name in routes)
    print(f"  (e) one decode step, {PRODUCTS_PER_FORWARD} K5 products: through the operator "
          f"enqueue {oe:.3f} ms, wall {ow:.3f} ms; called directly enqueue {de:.3f} ms, wall "
          f"{dw:.3f} ms; the operator's cost {(ow - dw) / PRODUCTS_PER_FORWARD * 1e3:.2f} us a "
          f"product (medians of {n})")


def run_lora(directory: str, shard: str, smi: str) -> dict:
    """Phase 18, at Llama-2-7B width (fp32 parameters, bf16 compute, remat),
    LORA_FLAGS, batch 2 x 2 x 512 positions, random weights from the seed:
    (a) QLoRA on an int8 base, 32 layers, 4 steps through `train()`, then
    (e) serving its run directory; (b) QLoRA on an int4 base (rows layout,
    group 128), 32 layers, 3 steps; (c) LoRA on the float base,
    LORA_CUT_LAYERS layers, 3 steps, then `merge_lora`; (d) one micro-batch
    under each remat policy,
    4 layers. The 3-step runs' first update runs at the warmup's lr of 0,
    so the third loss is the first after a real update. Returns the QLoRA
    runs' launches by format."""
    cfg = ModelConfig.llama2_7b()
    cut = dataclasses.replace(cfg, num_layers=LORA_CUT_LAYERS)
    batch, bundle = lora_batch(cfg, shard)
    _, rows, _ = requests(cfg)
    out = {}
    print(f"phase 18 on {smi}: rank 64, alpha 16, dropout 0.05, remat, {LORA_SEQ} positions, "
          "batch 2 x 2")
    for label, fmt, steps in (("(a) QLoRA int8, Llama-2-7B, 32 layers", "int8", 4),
                              ("(b) QLoRA int4 rows, group 128, 32 layers", "int4", 3)):
        t0 = time.perf_counter()
        path = os.path.join(directory, fmt)
        launches, result = run_training(
            label, cfg, path, shard, steps, frozen_base=True, lr=2e-3, seq=LORA_SEQ,
            train_flags=dict(LORA_FLAGS, bits=8 if fmt == "int8" else 4), keep=True,
            span=f"GeneratedBackwardFor_llark_{fmt}_matmul_defaultBackward")
        check_qlora_run(label, result, fmt, steps, launches, os.path.join(path, "out"))
        check_plain_step(label, result["cfg"], result["state"].params, batch, bundle.audio_patch_id)
        out[fmt] = launches
        del result
        torch.cuda.empty_cache()
        print(f"  {label[:3]}: {time.perf_counter() - t0:.1f} s")
        if fmt == "int8":
            _, e_s = seconds(lambda: out.update(serve=serve_lora_run(os.path.join(path, "out"), rows)))
            print(f"  (e): {e_s:.1f} s")
        shutil.rmtree(path)
    t0 = time.perf_counter()
    label = f"(c) LoRA on the float base, {LORA_CUT_LAYERS} layers"
    path = os.path.join(directory, "float")
    launches, result = run_training(label, cut, path, shard, 3, frozen_base=True, lr=2e-3,
                                    seq=LORA_SEQ, train_flags=LORA_FLAGS, keep=True)
    check(launches["int8_matmul"] == launches["int4_matmul"] == 0,
          f"{label}: a quantized product launched")
    check_merged(label, result, rows)
    del result
    shutil.rmtree(path)
    torch.cuda.empty_cache()
    print(f"  (c): {time.perf_counter() - t0:.1f} s")
    _, d_s = seconds(lambda: check_remat_policies(cfg, batch, bundle.audio_patch_id))
    print(f"  (d): {d_s:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 19: speculative decoding, beam search and the online HTTP engine
# ---------------------------------------------------------------------------

SPEC_GAMMA = 4
SPEC_NEW = 32
# A speculative stream must equal plain greedy decode up to the first step
# whose reference top-2 logit margin is below NEAR_TIE: the verify window
# (Sq = gamma + 1) and a decode step (Sq = 1) sum their products in another
# order, which can flip an argmax only where two logits nearly tie. At fp32
# (tf32 off) the window's logits read within ~1e-5 of the steps' (the
# window check below prints it), so 1e-3 leaves two orders of magnitude.
NEAR_TIE = 1e-3
BEAM_SCORE_TOL = 1e-3  # relative, beam score vs a teacher-forced log-prob


def window_counts() -> dict:
    return dict(dec_ops.flash_decode_attention.launches_by_window)


def spec_batch(bundle: TokenizerBundle, rows):
    """The 4 requests of requests() as one right-padded batch: (input_ids
    [4, S], prompt lengths, encodings [4, 256, 4800], frame counts), S the
    longest prompt rounded up to 128 positions as batch_infer pads."""
    ids = [build_prompt_ids(r["prompt"], 256, bundle) for r in rows]
    plens = np.array([len(x) for x in ids], np.int32)
    s = int(np.ceil(plens.max() / 128) * 128)
    input_ids = np.full((len(rows), s), bundle.pad_token_id, np.int32)
    for i, x in enumerate(ids):
        input_ids[i, : len(x)] = x
    audio = np.stack([r["audio_encoding"] for r in rows])
    return input_ids, plens, audio, np.full((len(rows),), audio.shape[1], np.int32)


def greedy_reference(cfg: ModelConfig, params, patch_id: int, batch, cache_len: int):
    """Plain `Generator` greedy tokens [4 x 32], and the same decode replayed
    step by step (prefill, then `decode_step`, as `decode_n` runs it) for
    each step's top-2 logit margin. Returns (tokens, margins [4, 32], the
    first near-tie step of each row, 32 where there is none)."""
    exact = GenerationConfig(max_new_tokens=SPEC_NEW, stop_text="")
    gen = Generator(cfg, params, patch_id, exact, max_cache_len=cache_len)
    ref = gen.generate(*batch)
    logits, cache = gen.prefill(*batch)
    pos = torch.as_tensor(batch[1], dtype=torch.int64, device="cuda")
    margins, toks = [], []
    for t in range(SPEC_NEW):
        top2 = logits.topk(2, dim=-1).values
        margins.append((top2[:, 0] - top2[:, 1]).cpu().numpy())
        token = logits.argmax(-1)
        toks.append(token)
        if t < SPEC_NEW - 1:
            logits, cache = decode_step(cfg, params, token, cache, pos + t)
    margins = np.stack(margins, axis=1)
    near = [int(np.argmax(m < NEAR_TIE)) if (m < NEAR_TIE).any() else SPEC_NEW for m in margins]
    print(f"  plain greedy, fp32: {len(ref)} streams x {SPEC_NEW} tokens; smallest top-2 margin "
          f"{margins.min():.3e}; first step below NEAR_TIE {NEAR_TIE:g} per row {near}")
    check_streams("the step-by-step replay of greedy decode", torch.stack(toks, dim=1).tolist(),
                  ref, near, margins)
    return ref, margins, near


def check_streams(label: str, got, ref, near, margins) -> int:
    """Each stream equals the reference up to its first near tie; returns
    the count of streams equal to it throughout."""
    equal = 0
    for i, (g, r) in enumerate(zip(got, ref)):
        same = next((t for t, (a, b) in enumerate(zip(g, r)) if a != b), min(len(g), len(r)))
        if g == r:
            equal += 1
        elif same < len(r):
            print(f"  {label}: stream {i} leaves plain greedy at step {same} (reference margin "
                  f"there {margins[i, same]:.3e}; first near tie {near[i]})")
        check(same >= min(near[i], len(r)),
              f"{label}: stream {i} differs from plain greedy at step {same}, before its first "
              f"near tie ({near[i]})")
        check(len(g) == SPEC_NEW, f"{label}: stream {i} has {len(g)} tokens")
    return equal


def replayed_acceptance(prompts, rows, gamma: int) -> float:
    """The acceptance rate a speculative generator reports for streams cut
    by the token budget, from `simulate_ngram_acceptance` over each prompt +
    stream with its last token masked (-1). The generator credits a round
    with the tokens it emitted less the one the target emits anyway; the
    replay credits every match, so in a final round that matched every
    token left in the budget it counts one more. The mask stops the
    replay's final round one short there and changes no other round (no
    round's proposals read the last token)."""
    accepted = proposed = 0
    for prompt, row in zip(prompts, rows):
        seq = list(map(int, prompt)) + list(row[:-1]) + [-1]
        rate, rounds = spec_mod.simulate_ngram_acceptance(seq, len(prompt), gamma)
        accepted += round(rate * rounds * gamma)
        proposed += rounds * gamma
    return accepted / proposed


def check_window(label: str, cfg: ModelConfig, params, tokens_in, cache, pos, mode: str,
                 wq: str = None, draft=None) -> float:
    """One verify forward over tokens_in [B, gamma+1] at `pos` against
    gamma + 1 sequential `decode_step`s on the same cache (each step
    rewrites the position it attends last, so the window's writes past it
    are never read): logits within WINDOW_TOL (LOGITS_TOL from quantized
    weights); K2 once a layer at Sq =
    gamma + 1 in the window and at Sq = 1 in the steps, in `mode` alone; with
    `wq`, 224 products in the window. With `draft` (cfg, params, cache,
    prev tokens): one proposal call of the draft from the same state, its
    K2 launches once a layer at Sq = 2, then at Sq = 1 per step, in its own
    cache's dense mode."""
    n = tokens_in.shape[1]
    dec_ops.reset_launch_counts()
    reset_wq_counts()
    win = decoder_forward(cfg, params, input_ids=tokens_in, kv_cache=cache,
                          cache_positions=pos)[0]
    torch.cuda.synchronize()
    win_counts = window_counts()
    products = {name: fn.launches for name, fn in WQ_KERNELS.items()}
    dec_ops.reset_launch_counts()
    steps = torch.stack([decode_step(cfg, params, tokens_in[:, j], cache, pos + j)[0]
                         for j in range(n)], dim=1)
    step_counts = window_counts()
    rel, diff = rel_err(win, steps)
    agree = float((win.argmax(-1) == steps.argmax(-1)).float().mean())
    print(f"  {label}: one verify window {tuple(win.shape)} vs {n} sequential decode steps: "
          f"max|d| {diff:.3e}, rel-to-max {rel:.3e}, argmax agreement {agree:.1%}; K2 launches "
          f"{win_counts} in the window, {step_counts} in the steps; products {products}")
    check(bool(torch.isfinite(win).all()), f"{label}: non-finite verify logits")
    tol = WINDOW_TOL if wq is None else LOGITS_TOL
    check(rel <= tol, f"{label}: verify-window logits rel err {rel:.3e} > {tol}")
    layers = cfg.num_layers
    check(win_counts == {(mode, n): layers},
          f"{label}: K2 launched {win_counts} in one verify window, not {layers} at Sq = {n}")
    check(step_counts == {(mode, 1): n * layers}, f"{label}: the steps launched K2 {step_counts}")
    want_products = {name: (PRODUCTS_PER_FORWARD if name == wq else 0) for name in WQ_KERNELS}
    check(products == want_products, f"{label}: products {products} in one verify window, "
          f"not {want_products}")
    if draft is not None:
        d_cfg, d_params, d_cache, prev = draft
        dec_ops.reset_launch_counts()
        last2 = torch.stack([prev, tokens_in[:, 0]], dim=1)
        props, _ = spec_mod.draft_propose(d_cfg, d_params, last2, d_cache, pos - 1, n - 1)
        torch.cuda.synchronize()
        d_counts = window_counts()
        d_mode = "dense_fp32" if d_cfg.dtype == "float32" else "dense_bf16"
        want = {(d_mode, 2): d_cfg.num_layers, (d_mode, 1): (n - 2) * d_cfg.num_layers}
        print(f"  {label}: one draft proposal call {tuple(props.shape)}: K2 launches {d_counts}")
        check(d_counts == want, f"{label}: the draft launched K2 {d_counts}, not {want}")
    return rel


def teacher_forced_logprobs(cfg: ModelConfig, params, patch_id: int, batch, beams) -> list:
    """Each beam's tokens scored through the plain attention route: one
    full forward over prompt + beam per beam (no cache) and the sum of the
    beam tokens' log-probabilities."""
    plain = dataclasses.replace(cfg, use_pallas_attention=False, use_flash_decode=False)
    input_ids, plens, audio, counts = batch
    k = len(beams[0])
    width = input_ids.shape[1] + SPEC_NEW
    ids = np.zeros((len(beams) * k, width), np.int64)
    lens = np.zeros((len(beams) * k,), np.int32)
    for i, row in enumerate(beams):
        for j, (seq, _) in enumerate(row):
            r, p = i * k + j, int(plens[i])
            ids[r, :p] = input_ids[i, :p]
            ids[r, p : p + len(seq)] = seq
            lens[r] = p + len(seq)
    t = lambda x, dtype: torch.as_tensor(x, dtype=dtype, device="cuda")
    embeds = build_inputs_embeds(plain, params, t(ids, torch.int64),
                                 t(np.repeat(audio, k, axis=0), torch.float32), patch_id,
                                 t(np.repeat(counts, k), torch.int32))
    logp = torch.log_softmax(
        decoder_forward(plain, params, inputs_embeds=embeds, seq_lengths=t(lens, torch.int32))[0],
        dim=-1)
    out = []
    for i, row in enumerate(beams):
        for j, (seq, _) in enumerate(row):
            p = int(plens[i])
            picked = logp[i * k + j, p - 1 : p - 1 + len(seq)].gather(
                1, t(seq, torch.int64)[:, None])
            out.append(float(picked.sum()))
    return out


def beam_gather_share(cfg: ModelConfig, params, patch_id: int, batch, k: int, cache_len: int):
    """torch.profiler over one beam step at K beams from the prefilled
    state: the step's device time and the cache gather's part of it (the
    index_select kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t = lambda x, dtype: torch.as_tensor(x, dtype=dtype, device="cuda")
    input_ids, plens, audio, counts = batch
    logits, cache = prefill(cfg, params, t(input_ids, torch.int64), t(plens, torch.int32),
                            t(audio, torch.float32), t(counts, torch.int32), patch_id, cache_len)
    scores, tokens = beam_mod._top_k(torch.log_softmax(logits.float(), dim=-1), k)
    cache = {n: v.repeat_interleave(k, dim=1) if n in ("k", "v", "k_scale", "v_scale") else v
             for n, v in cache.items()}
    alive = torch.ones_like(tokens, dtype=torch.bool)
    step = lambda: beam_mod.beam_step(cfg, k, -1, params, tokens, cache,
                                      t(plens, torch.int64), scores, alive)
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    gather = sum(e.self_device_time_total for e in kernels
                 if "indexSelect" in e.key or "index_select" in e.key) / 1e3
    cache_gb = sum(v.numel() * v.element_size() for n, v in cache.items()
                   if torch.is_tensor(v)) / 1e9
    if busy <= 0:
        print("  beam step device time: not measured (the profiler saw no device time)")
        return None
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    print(f"  one beam step at K = {k} ({tuple(tokens.shape)[0] * k} rows, a {cache_gb:.2f} GB "
          f"cache): device {busy:.2f} ms, the cache gather {gather:.2f} ms ({gather / busy:.1%}); "
          + "; ".join(f"{e.self_device_time_total / 1e3:.2f} ms x{e.count} {e.key[:50]}"
                      for e in top))
    return busy, gather


@torch.inference_mode()
def run_spec_fp32(cfg: ModelConfig, bundle: TokenizerBundle, rows) -> dict:
    """Phase 19 (a): an fp32 Llama-2-7B (32 layers, random weights from the
    seed, tf32 off): plain greedy with margins; speculation at gamma 4 by
    n-gram, self-draft (fused, 4 rounds) and an MPT-1B-width draft (fused);
    verify-window and draft-call launch gates; beams K = 1, K = 4 (scores vs
    teacher-forced log-probs) and K = 4 over an int8 cache."""
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    patch = bundle.audio_patch_id
    batch = spec_batch(bundle, rows)
    spec_len = batch[0].shape[1] + SPEC_NEW + SPEC_GAMMA + 2  # fused rounds' position clamp
    beam_len = batch[0].shape[1] + SPEC_NEW
    t0 = time.perf_counter()
    params = init_llark_params(cfg32, seed=SEED, device="cuda")
    draft_cfg = ModelConfig.mpt_1b(vocab_size=cfg.vocab_size, mm_hidden_size=cfg.mm_hidden_size,
                                   dtype="float32", param_dtype="float32", use_flash_decode=True)
    draft = init_llark_params(draft_cfg, seed=SEED + 1, device="cuda")
    torch.cuda.synchronize()
    print(f"  fp32 7B target ({param_bytes(params) / 1e9:.2f} GB) and MPT-1B-width draft "
          f"({draft_cfg.num_layers} layers, ALiBi, {param_bytes(draft) / 1e9:.2f} GB) made on the "
          f"card in {time.perf_counter() - t0:.1f} s; prompts {batch[1].tolist()} padded to "
          f"{batch[0].shape[1]}")
    ref, margins, near = greedy_reference(cfg32, params, patch, batch, spec_len)
    out = {}
    prompts = [batch[0][i, : batch[1][i]] for i in range(len(rows))]
    gen_cfg = GenerationConfig(max_new_tokens=SPEC_NEW, stop_text="")
    for label, kw, want_fwd in (
            ("n-gram", {}, cfg32.num_layers),
            ("self-draft, fused 4", dict(draft_cfg=cfg32, draft_params=params, fused_rounds=4),
             2 * cfg32.num_layers),
            ("MPT-1B-width draft, fused 4", dict(draft_cfg=draft_cfg, draft_params=draft,
                                                 fused_rounds=4),
             cfg32.num_layers + draft_cfg.num_layers)):
        spec = spec_mod.SpeculativeGenerator(cfg32, params, patch, gen_cfg, max_cache_len=spec_len,
                                             gamma=SPEC_GAMMA, **kw)
        dec_ops.reset_launch_counts()
        attn_ops.flash_attention_fwd.launches = 0
        got, secs = seconds(lambda: spec.generate(*batch))
        counts, fwd = window_counts(), attn_ops.flash_attention_fwd.launches
        equal = check_streams(f"speculation ({label})", got, ref, near, margins)
        rate = spec.last_acceptance_rate
        print(f"  speculation ({label}), gamma {SPEC_GAMMA}: {secs:.2f} s, acceptance {rate:.3f}, "
              f"streams equal to plain greedy {equal}/{len(ref)}; K2 launches {counts}, "
              f"K1 launches {fwd}")
        check(fwd == want_fwd, f"speculation ({label}): {fwd} K1 launches, not {want_fwd}")
        verify_n = counts.get(("dense_fp32", SPEC_GAMMA + 1), 0)
        check(verify_n > 0 and verify_n % cfg32.num_layers == 0,
              f"speculation ({label}): {verify_n} K2 launches at Sq = {SPEC_GAMMA + 1}")
        check(all(mode == "dense_fp32" for mode, _ in counts),
              f"speculation ({label}): K2 launched outside dense_fp32: {counts}")
        if not kw:
            want = replayed_acceptance(prompts, got, SPEC_GAMMA)
            print(f"  n-gram acceptance {rate:.6f}, replayed on the emitted tokens {want:.6f}")
            check(rate == want, f"n-gram acceptance {rate} is not the replay's {want}")
            check(set(counts) == {("dense_fp32", SPEC_GAMMA + 1)},
                  f"n-gram speculation launched K2 {counts}")
        out[label] = dict(seconds=secs, acceptance=rate, equal=equal)
    # the verify-window contract at this width, from the prefilled state:
    # [first token, 4 reference tokens] at each row's prompt length, and
    # the MPT draft's proposal call from its own prefilled state
    gen = Generator(cfg32, params, patch, gen_cfg, max_cache_len=spec_len)
    logits, cache = gen.prefill(*batch)
    t = lambda x: torch.as_tensor(x, dtype=torch.int64, device="cuda")
    tokens_in = t([r[: SPEC_GAMMA + 1] for r in ref])
    _, d_cache = prefill(draft_cfg, draft, t(batch[0]), t(batch[1]).int(),
                         torch.as_tensor(batch[2], device="cuda"), t(batch[3]).int(), patch,
                         spec_len)
    prev = t([p[-1] for p in prompts])
    out["window_rel"] = check_window("fp32 target", cfg32, params, tokens_in, cache,
                                     t(batch[1]).int(), "dense_fp32",
                                     draft=(draft_cfg, draft, d_cache, prev))
    del cache, d_cache, draft, logits
    torch.cuda.empty_cache()

    # beams on the same fp32 tree
    def beams(k, bcfg=cfg32):
        searcher = beam_mod.BeamSearcher(
            bcfg, params, patch, beam_mod.BeamSearchConfig(num_beams=k, max_new_tokens=SPEC_NEW,
                                                           stop_text=""),
            max_cache_len=beam_len)
        dec_ops.reset_launch_counts()
        got, secs = seconds(lambda: searcher.generate(*batch, return_all_beams=True))
        return got, secs, {m: n for m, n in dec_ops.flash_decode_attention.launches_by_mode.items()
                           if n}

    got, secs, by_mode = beams(1)
    equal = check_streams("beams K = 1", [row[0][0] for row in got], ref, near, margins)
    print(f"  beams K = 1: {secs:.2f} s, streams equal to plain greedy {equal}/{len(ref)}; "
          f"K2 by mode {by_mode}")
    got, secs, by_mode = beams(4)
    forced = teacher_forced_logprobs(cfg32, params, patch, batch, got)
    scores = [sc for row in got for _, sc in row]
    worst = max(abs(a - b) / abs(b) for a, b in zip(scores, forced))
    print(f"  beams K = 4: {secs:.2f} s; K2 by mode {by_mode}; scores {[round(s, 3) for s in scores[:4]]}"
          f"...; worst |score - teacher-forced log-prob| / |log-prob| {worst:.3e}")
    check(all(len(seq) == SPEC_NEW for row in got for seq, _ in row), "a beam is short")
    check(worst <= BEAM_SCORE_TOL, f"beam scores off the teacher-forced log-probs: {worst:.3e}")
    check(set(by_mode) == {"dense_fp32"}, f"beams K = 4 launched K2 by mode {by_mode}")
    best_fp = [row[0][0] for row in got]
    step = beam_gather_share(cfg32, params, patch, batch, 4, beam_len)
    got, secs, by_mode = beams(4, dataclasses.replace(cfg32, kv_cache_quant=True))
    same = sum(row[0][0] == b for row, b in zip(got, best_fp))
    print(f"  beams K = 4, int8 cache: {secs:.2f} s; K2 by mode {by_mode}; best beams equal to "
          f"the fp32 cache's {same}/{len(got)}")
    check(set(by_mode) == {"dense_int8"},
          f"beams over an int8 cache launched K2 by mode {by_mode}")
    check(all(len(seq) == SPEC_NEW and np.isfinite(sc) for row in got for seq, sc in row),
          "an int8-cache beam is short or its score is not finite")
    out["beam_step"] = step
    del params
    torch.cuda.empty_cache()
    return out


SPEC_SERVING = (
    # (label, what, phase-7 mode it is counted against, target cache mode,
    #  kv_cache_quant, server keywords, weights)
    ("a-ngram", "n-gram, mode (a): paged 128-token blocks, int8 KV, prefill_chunk 256", "a",
     "paged_int8", True, dict(kv_block_size=128, prefill_chunk=256, spec_mode="ngram"), None),
    ("b-ngram", "n-gram, mode (b): dense bf16 cache", "b", "dense_bf16", False,
     dict(spec_mode="ngram"), None),
    ("a-draft", "MPT-1B-width draft, spec_rounds 2, mode (a)", "a", "paged_int8", True,
     dict(kv_block_size=128, prefill_chunk=256, draft=True, spec_rounds=2), None),
    ("a-force", "n-gram, mode (a), spec_force_accept 0.8", "a", "paged_int8", True,
     dict(kv_block_size=128, prefill_chunk=256, spec_mode="ngram", spec_force_accept=0.8), None),
    ("a-int8w", "n-gram, mode (a), int8 weights", "a", "paged_int8", True,
     dict(kv_block_size=128, prefill_chunk=256, spec_mode="ngram"), "int8"),
)


@torch.inference_mode()
def run_spec_serving(cfg: ModelConfig, bundle: TokenizerBundle, bf16_serving: dict) -> dict:
    """Phase 19 (b): `BatchedServer` at 7B width, bf16 weights from the seed
    (phase 7's), 16 requests x 32 tokens, gamma 4, allow_divergent_spec, in
    each SPEC_SERVING run; (c) then serves mode (a) without speculation over
    HTTP. Returns the runs' figures."""
    params = init_llark_params(cfg, seed=SEED, device="cuda")
    draft_cfg = ModelConfig.mpt_1b(vocab_size=cfg.vocab_size, mm_hidden_size=cfg.mm_hidden_size,
                                   param_dtype="bfloat16", use_flash_decode=True)
    draft = init_llark_params(draft_cfg, seed=SEED + 1, device="cuda")
    gen_cfg = GenerationConfig(max_new_tokens=SPEC_NEW, stop_text="")
    figures = {}
    for label, what, plain_mode, own, quant_kv, extra, wq in SPEC_SERVING:
        kw = dict(SERVING_BASE, tokenizer=bundle.tokenizer, gamma=SPEC_GAMMA,
                  allow_divergent_spec=True, **extra)
        if kw.pop("draft", False):
            kw.update(draft_cfg=draft_cfg, draft_params=draft)
        if wq == "int8":
            del draft
            params = quant.quantize_params_int8_incremental(cfg, params)
        mcfg = dataclasses.replace(cfg, kv_cache_quant=quant_kv)
        server = BatchedServer(mcfg, params, bundle.audio_patch_id, gen_cfg, **kw)
        reqs = serving_requests(cfg, bundle, 16, SEED)
        dec_ops.reset_launch_counts()
        reset_wq_counts()
        _, wall = seconds(lambda: server.serve(reqs))
        by_mode = {m: n for m, n in dec_ops.flash_decode_attention.launches_by_mode.items() if n}
        counts, products = window_counts(), {n: fn.launches for n, fn in WQ_KERNELS.items()}
        stats = server.stats(reqs)
        equal = sum(r.tokens == p for r, p in zip(reqs, bf16_serving[plain_mode]["tokens"]))
        print(f"serving ({label}) {what}: 16 requests x {SPEC_NEW} tokens in {wall:.2f} s, "
              f"{stats['tokens_per_sec']:.1f} tokens/s, mean TTFT {stats['mean_ttft_s']:.3f} s, "
              f"spec_acceptance {stats.get('spec_acceptance')}, streams equal to phase 7's plain "
              f"tokens in mode ({plain_mode}) {equal}/16; K2 launches {counts}; products "
              f"{products}")
        check(all(r.done and r.error is None and len(r.tokens) == SPEC_NEW for r in reqs),
              f"serving ({label}): a request did not finish with {SPEC_NEW} tokens")
        allowed = {own, "dense_bf16"} if "draft_cfg" in kw else {own}
        check(set(by_mode) <= allowed and by_mode.get(own, 0) > 0,
              f"serving ({label}): K2 launched by cache mode {by_mode}, not in {allowed} alone")
        verify_n = counts.get((own, SPEC_GAMMA + 1), 0)
        check(verify_n > 0 and verify_n % cfg.num_layers == 0,
              f"serving ({label}): {verify_n} K2 launches at Sq = {SPEC_GAMMA + 1}")
        if "draft_cfg" in kw:
            check(counts.get(("dense_bf16", 2), 0) > 0,
                  f"serving ({label}): the draft never launched K2 at Sq = 2")
        if wq is None:
            check(products == {n: 0 for n in WQ_KERNELS}, f"serving ({label}): products {products}")
        else:
            check(products["int4"] == 0, f"serving ({label}): K6 launched {products['int4']} times")
            check_wq_counts(f"serving ({label})", wq)

        # 8 admitted slots: one verify window against sequential steps (the
        # draft's proposal call too), then a speculative round's device split
        server._queue = serving_requests(cfg, bundle, 8, SEED + 1)
        for r in server._queue:
            r.submitted_at = time.time()
        server._admit()
        server._refresh_tables()
        t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int64, device="cuda")
        props = [spec_mod.ngram_propose(list(map(int, r.input_ids)) + r.tokens, SPEC_GAMMA)
                 for r in server._slot_req]
        tokens_in = t([[int(server._tokens_in_flight[i])] + props[i] for i in range(8)])
        pos = t(server._write_pos).int()
        d = None
        if "draft_cfg" in kw:
            d = (server.draft_cfg, server.draft_params, server._d_cache, t(server._prev_tok))
        rel = check_window(f"serving ({label})", server.cfg, server.params, tokens_in,
                           server._cache, pos, own, wq=wq, draft=d)
        wall_ms, busy_ms, top = profile_round(server)
        plain = bf16_serving[plain_mode]
        idle = None if busy_ms is None else 1 - busy_ms / wall_ms
        print(f"  one speculative round (8 slots): wall {wall_ms:.1f} ms, device "
              f"{'not measured' if busy_ms is None else f'{busy_ms:.1f} ms'}, idle share "
              f"{'not measured' if idle is None else f'{idle:.1%}'}; {top}")
        device = plain["round_device_ms"]
        print(f"  beside phase 7 mode ({plain_mode}) plain: {plain['tokens_per_sec']:.1f} tokens/s, "
              f"mean TTFT {plain['mean_ttft_s']:.3f} s, a decode round of 8 tokens: wall "
              f"{plain['round_wall_ms']:.1f} ms, device "
              f"{'not measured' if device is None else f'{device:.1f} ms'}")
        figures[label] = dict(wall_s=wall, tokens_per_sec=stats["tokens_per_sec"],
                              mean_ttft_s=stats["mean_ttft_s"],
                              acceptance=stats.get("spec_acceptance"), equal=equal,
                              window_rel=rel, round_wall_ms=wall_ms, round_device_ms=busy_ms)
        del server
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    figures["http"] = run_http(cfg, bundle, bf16_serving["a"]["tokens"])
    return figures


def run_http(cfg: ModelConfig, bundle: TokenizerBundle, plain_tokens: list) -> dict:
    """Phase 19 (c): mode (a) of phase 7 (bf16 weights, no speculation)
    behind `OnlineEngine` + `serve_http` on 127.0.0.1 (port 0) in this
    process: 16 requests from 8 client threads with base64 .npy encodings,
    then one body whose encoding has the wrong width, then one more valid
    request. `plain_tokens` are phase 7's mode (a) tokens of the 16."""
    import base64
    import concurrent.futures
    import io
    import urllib.error
    import urllib.request

    from llark_tpu_torch.inference.http_server import serve_http

    params = init_llark_params(cfg, seed=SEED, device="cuda")
    server = BatchedServer(dataclasses.replace(cfg, kv_cache_quant=True), params,
                           bundle.audio_patch_id,
                           GenerationConfig(max_new_tokens=SPEC_NEW, stop_text=""),
                           tokenizer=bundle.tokenizer, kv_block_size=128, prefill_chunk=256,
                           **SERVING_BASE)
    httpd, engine = serve_http(server, bundle, host="127.0.0.1", port=0)
    port = httpd.server_address[1]
    listener = threading.Thread(target=httpd.serve_forever, daemon=True)
    listener.start()
    def body(i, enc):
        buf = io.BytesIO()
        np.save(buf, enc)
        return json.dumps({"prompt": PROMPTS[i % 4],
                           "audio_encoding": base64.b64encode(buf.getvalue()).decode()}).encode()

    def post(data):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=data,
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    reqs = serving_requests(cfg, bundle, 16, SEED)
    bodies = [body(i, r.audio_encoding) for i, r in enumerate(reqs)]
    try:
        dec_ops.reset_launch_counts()
        with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
            replies, wall = seconds(lambda: list(pool.map(post, bodies)))
        by_mode = {m: n for m, n in dec_ops.flash_decode_attention.launches_by_mode.items() if n}
        bad_code, bad = post(body(0, np.zeros((3, cfg.mm_hidden_size + 2), np.float32)))
        last_code, last = post(bodies[1])
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
        listener.join(timeout=30)
    ttft = [out.get("ttft_s", float("nan")) for _, out in replies]
    p50, p90 = np.percentile(ttft, 50), np.percentile(ttft, 90)
    tokens = sum(len(out.get("tokens", [])) for _, out in replies)
    equal = sum(out.get("tokens") == p for (_, out), p in zip(replies, plain_tokens))
    print(f"http (mode (a), bf16, no speculation): 16 requests from 8 threads in {wall:.2f} s, "
          f"{tokens / wall:.1f} tokens/s, TTFT p50 {p50:.3f} s, p90 {p90:.3f} s; "
          f"malformed body -> {bad_code} ({bad.get('error', '')[:60]}), next request -> "
          f"{last_code}; /health {health}; K2 by mode {by_mode}; streams equal to phase 7's "
          f"mode (a) {equal}/16")
    check(all(code == 200 and len(out["tokens"]) == SPEC_NEW for code, out in replies),
          f"http: a request failed: {[(c, o.get('error')) for c, o in replies if c != 200]}")
    check(bad_code == 400, f"http: the malformed body got {bad_code}, not 400")
    check(last_code == 200 and len(last["tokens"]) == SPEC_NEW,
          f"http: the request after the malformed one got {last_code}")
    check(health == {"status": "ok", "slots_free": 8, "queued": 0}, f"http: /health {health}")
    check(not engine._thread.is_alive() and server.driver is None,
          "http: stop() did not join the engine thread")
    check(set(by_mode) == {"paged_int8"}, f"http: K2 launched by cache mode {by_mode}")
    del server, params
    torch.cuda.empty_cache()
    return dict(wall_s=wall, tokens_per_sec=tokens / wall, ttft_p50_s=p50, ttft_p90_s=p90)


def run_speculation(cfg: ModelConfig, bundle: TokenizerBundle, rows, bf16_serving: dict,
                    smi: str) -> dict:
    """Phase 19: (a) fp32 speculation and beams, (b) bf16 speculative
    serving, (c) the HTTP engine, each part's seconds printed."""
    print(f"phase 19 on {smi}: gamma {SPEC_GAMMA}, {SPEC_NEW} new tokens, greedy")
    fp32, a_s = seconds(lambda: run_spec_fp32(cfg, bundle, rows))
    print(f"  (a): {a_s:.1f} s")
    serving, b_s = seconds(lambda: run_spec_serving(cfg, bundle, bf16_serving))
    print(f"  (b) and (c): {b_s:.1f} s")
    return dict(fp32=fp32, serving=serving)


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# phase 20: the CLAP path: WAV files -> HTSAT-base embeddings -> answers
# ---------------------------------------------------------------------------

# 8 crops as LLark's CLAP variant reads them: 16-bit PCM at 44.1 kHz, so
# read_wav resamples to 48 kHz; (seconds, channels) each
CLAP_WAVS = ((3.0, 1), (3.0, 2), (7.0, 1), (7.0, 2), (10.0, 1), (10.0, 2), (12.5, 2), (25.0, 1))
# the card's unit-norm embeddings against the CPU plain path's, absolute:
# both compute in fp32 (cuFFT and cuBLAS without TF32 against pocketfft
# and the CPU's GEMM), so they differ by summation order alone. The phase
# also reads the card with TF32 products, which must land above it
CLAP_TOL = 1e-6
ANSWER_LAYERS = 4  # the answer half's depth at Llama-2-7B width in phases 20, 21, as phase 17


def write_clap_wavs(directory: str) -> list:
    """The 8 WAVs: a chord under noise each, made from the seed."""
    rng = np.random.RandomState(SEED + 20)
    os.makedirs(directory)
    names = []
    for i, (secs, channels) in enumerate(CLAP_WAVS):
        n = int(secs * DEFAULT_SR)
        t = np.arange(n) / DEFAULT_SR
        chord = sum(np.sin(2 * np.pi * f * t) for f in rng.uniform(80, 4000, 3)) / 3
        x = 0.4 * chord[:, None] + 0.05 * rng.randn(n, channels)
        names.append(f"crop{i}-start0.000-end{secs:.3f}.wav")
        write_wav(os.path.join(directory, names[-1]), x, DEFAULT_SR)
    return names


def run_extract(wavs: str, out: str, device: str, profile: bool = False) -> tuple:
    """`extract_cli clap` at batch 8 on `device`, through the CLI's own
    parser; returns its `ClapRun` (seconds in all, read + resample +
    prepare, embed) and, with `profile`, the card's kernel ms in that same
    run (torch.profiler; None if it saw none)."""
    ns = extract_cli.build_parser().parse_args(
        ["clap", "--input-dir", wavs, "--output-dir", out, "--batch-size", "8",
         "--device", device])
    runs, busy_ms = [], None
    if profile:
        busy_ms = profile_device(lambda: runs.append(ns.fn(ns)), None, top=4,
                                 what="  (d) extract_cli on the card, the encoder's init included")
    else:
        runs.append(ns.fn(ns))
    check(runs[0].n == len(CLAP_WAVS),
          f"extract_cli on {device}: {runs[0].n} embeddings, not {len(CLAP_WAVS)}")
    return runs[0], busy_ms


@contextlib.contextmanager
def tf32_products():
    """cuBLAS and cuDNN in TF32 inside the block (the script runs fp32
    products in full precision), restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def embedding_diff(names: list, got_dir: str, want_dir: str) -> tuple:
    """The worst |got - want| over the embeddings, and its file; checks the
    file names, shape (1, 512), fp32 and finite values on both sides, and
    every norm within 1e-5 of 1."""
    want = sorted(n.replace(".wav", ".npy") for n in names)
    worst, worst_name, bad_norm = 0.0, None, 0.0
    for d in (got_dir, want_dir):
        check(sorted(os.listdir(d)) == want, f"{d} holds {sorted(os.listdir(d))}")
    for name in want:
        got, ref = np.load(os.path.join(got_dir, name)), np.load(os.path.join(want_dir, name))
        for where, arr in ((got_dir, got), (want_dir, ref)):
            check(arr.shape == (1, 512) and arr.dtype == np.float32,
                  f"{where}/{name}: {arr.shape} {arr.dtype}, not (1, 512) float32")
            check(bool(np.isfinite(arr).all()), f"{where}/{name}: non-finite values")
            bad_norm = max(bad_norm, abs(float(np.linalg.norm(arr)) - 1.0))
        err = float(np.abs(got - ref).max())
        if err >= worst:
            worst, worst_name = err, name
    check(bad_norm <= 1e-5, f"an embedding's norm is {bad_norm:.2e} from 1")
    return worst, worst_name, bad_norm


def name_every_id(bundle: TokenizerBundle, vocab_size: int, prompts) -> None:
    """Give the bundle's word tokenizer one word of its own for each id of
    the model, after the words the prompts' template needs: a completion
    then names every token it holds, so two runs' rows are equal only if
    their tokens are (with a smaller vocabulary most of a random model's
    tokens decode as <unk>, and the rows compare nothing)."""
    tok = bundle.tokenizer
    for p in prompts:
        build_prompt_ids(p, 1, bundle)
    tok.add_tokens([f"w{i}" for i in range(len(tok), vocab_size)])
    for p in prompts:  # the prompts intern no further word
        build_prompt_ids(p, 1, bundle)
    check(len(tok) == vocab_size, f"the tokenizer has {len(tok)} words for {vocab_size} ids")


def check_completions(label: str, rows: list) -> None:
    """Every completion is non-empty and names its tokens (no <unk>)."""
    check(all(r["model_completion"] for r in rows),
          f"{label}: an empty completion: the rows compare nothing")
    check(not any("<unk>" in r["model_completion"] for r in rows),
          f"{label}: a completion holds <unk>: the rows do not name their tokens")


def encodings_answers(directory: str, emb_dir: str, smi: str, label: str,
                      mm_hidden: int) -> dict:
    """Phase 20 (e), phase 21 (e): an LLark of `mm_hidden`-wide encodings at
    Llama-2-7B width, ANSWER_LAYERS layers, bf16, written as a run directory
    with a tokenizer that names each of its ids; `from_encodings.main` over
    the .npy files against `batch_infer` on the same encodings and params.
    Returns the CLI's launch counts."""
    cfg = ModelConfig.llama2_7b(num_layers=ANSWER_LAYERS, mm_hidden_size=mm_hidden,
                                param_dtype="bfloat16", use_flash_decode=True)
    prompt = "Describe the audio."
    bundle = TokenizerBundle.from_tokenizer(WordTokenizer(2048))
    name_every_id(bundle, cfg.vocab_size, [prompt])
    params = init_llark_params(cfg, seed=SEED, device="cuda")
    run_dir = os.path.join(directory, "run")
    save_model_metadata(run_dir, cfg, bundle)
    _, save_s = seconds(lambda: CheckpointManager(run_dir).save(0, TrainState(params, {}, 0)))
    out_csv = os.path.join(directory, "answers.csv")
    attn_ops.flash_attention_fwd.launches = 0
    dec_ops.reset_launch_counts()
    _, cli_s = seconds(lambda: from_encodings.main(
        ["--checkpoint-dir", run_dir, "--encodings-dir", emb_dir, "--output", out_csv,
         "--prompt", prompt, "--max-new-tokens", "32", "--max-cache-len", "2048",
         "--device", "cuda"]))
    cli = {"flash_fwd": attn_ops.flash_attention_fwd.launches,
           **{k: v for k, v in dec_ops.flash_decode_attention.launches_by_mode.items() if v}}
    with open(out_csv, newline="") as f:
        got = list(csv.DictReader(f))

    files = sorted(os.listdir(emb_dir))
    rows = [{"example_id": os.path.splitext(n)[0], "prompt": prompt,
             "audio_encoding": np.load(os.path.join(emb_dir, n))} for n in files]
    gen = Generator(cfg, params, bundle.audio_patch_id,
                    GenerationConfig(max_new_tokens=32, temperature=0.0, stop_text="###"),
                    max_cache_len=2048, device="cuda")
    attn_ops.flash_attention_fwd.launches = 0
    dec_ops.reset_launch_counts()
    want, direct_s = seconds(lambda: batch_infer(rows, gen, bundle))
    direct = {"flash_fwd": attn_ops.flash_attention_fwd.launches,
              **{k: v for k, v in dec_ops.flash_decode_attention.launches_by_mode.items() if v}}
    want = [{k: str(v) for k, v in r.items()} for r in want]
    print(f"  (e) {label} LLark ({smi}), Llama-2-7B width, {ANSWER_LAYERS} layers, bf16, "
          f"mm_hidden_size {mm_hidden}, a word for each of its {cfg.vocab_size} ids: run "
          f"directory written in {save_s:.2f} s; from_encodings {cli_s:.2f} s for {len(got)} rows "
          f"(the model's load included), batch_infer {direct_s:.2f} s; launches CLI {cli}, "
          f"batch_infer {direct}, expected K1 {ANSWER_LAYERS} x {len(rows)} = "
          f"{ANSWER_LAYERS * len(rows)}, K2 in dense_bf16 alone, at most {ANSWER_LAYERS} x 31 x "
          f"{len(rows)} = {ANSWER_LAYERS * 31 * len(rows)}")
    print(f"  completion 0: {got[0]['model_completion'][:80]!r}" if got else "  no rows")
    check(got == want, "from_encodings' CSV rows differ from batch_infer on the same "
                       "encodings and params")
    check_completions("from_encodings", got)
    check(cli == direct, f"from_encodings launched {cli}, batch_infer {direct}")
    check(cli["flash_fwd"] == ANSWER_LAYERS * len(rows),
          f"from_encodings: {cli['flash_fwd']} flash-prefill launches, not "
          f"{ANSWER_LAYERS} x {len(rows)}")
    check(set(cli) == {"flash_fwd", "dense_bf16"} and cli["dense_bf16"] > 0,
          f"from_encodings: flash decode launched as {cli}")
    del params, gen
    torch.cuda.empty_cache()
    return cli


def run_clap_path(directory: str, smi: str) -> None:
    """Phase 20: WAV files -> extract_cli on the card and on the CPU ->
    unit-norm [1, 512] HTSAT-base embeddings -> from_encodings' answers."""
    print(f"phase 20 on {smi}: HTSAT-base (embed 128, depths (2, 2, 12, 2), window 8, "
          f"64 mels), seeded random weights, {len(CLAP_WAVS)} WAVs, batch 8")
    wavs = os.path.join(directory, "wavs")
    names = write_clap_wavs(wavs)
    audio_s = sum(s for s, _ in CLAP_WAVS)
    card_dir, cpu_dir = os.path.join(directory, "card"), os.path.join(directory, "cpu")
    # (b) and (d): the card's run, profiled, so that its device time and
    # idle share are this run's
    native_build.calls.clear()
    run, busy_ms = run_extract(wavs, card_dir, "cuda", profile=True)
    calls = dict(native_build.calls)
    NATIVE_READS["phase 20, extract_cli clap on the card"] = (
        f"native calls {calls}; {run.seconds:.3f} s for {run.n} WAVs, read + resample + prepare "
        f"{run.host_s:.3f} s, {run.host_s / run.seconds:.1%} of it (PR 17 on the numpy routes: "
        f"5.547-7.041 s, 85.2-96.5 %)")
    check(calls.get("parse_wav") == len(names) and calls.get("resample") == len(names),
          f"extract_cli clap read its WAVs with native calls {calls}")
    print(f"  (b) extract_cli on the card ({smi}): {len(names)} WAVs ({audio_s} s of 44.1 kHz "
          f"audio) in {run.seconds:.3f} s after the encoder's init, profiled: "
          f"{run.n / run.seconds:.3f} clips/s; read + resample + prepare {run.host_s:.3f} s on "
          f"the host ({run.host_s / run.seconds:.1%}), embed (mel + HTSAT at batch 8, to the "
          f"host; the process's first call) {run.embed_s:.3f} s; the card's kernels "
          + ("not measured" if busy_ms is None else f"{busy_ms:.1f} ms of the run"))
    cpu_run, _ = run_extract(wavs, cpu_dir, "cpu")
    print(f"  (c) extract_cli on the CPU (plain path, {torch.get_num_threads()} threads): "
          f"{cpu_run.seconds:.3f} s, embed {cpu_run.embed_s:.3f} s, read + resample + prepare "
          f"{cpu_run.host_s:.3f} s")
    worst, worst_name, bad_norm = embedding_diff(names, card_dir, cpu_dir)
    print(f"  card vs CPU plain path: worst max|d| {worst:.3e} ({worst_name}); norms within "
          f"{bad_norm:.2e} of 1")
    check(worst <= CLAP_TOL, f"the card's embedding of {worst_name} is {worst:.3e} from the "
          f"CPU's, over CLAP_TOL {CLAP_TOL}")
    # the control: the same run with TF32 products must fail the gate
    tf32_dir = os.path.join(directory, "card_tf32")
    with tf32_products():
        run_extract(wavs, tf32_dir, "cuda")
    tf32_worst, tf32_name, _ = embedding_diff(names, tf32_dir, cpu_dir)
    print(f"  control, the card with TF32 products: worst max|d| {tf32_worst:.3e} ({tf32_name}), "
          f"{tf32_worst / max(worst, 1e-30):.0f}x the fp32 reading; CLAP_TOL {CLAP_TOL}")
    check(tf32_worst > CLAP_TOL, f"TF32 products read {tf32_worst:.3e}, within CLAP_TOL "
          f"{CLAP_TOL}: the gate cannot tell them from fp32")
    torch.cuda.empty_cache()
    encodings_answers(directory, card_dir, smi, "CLAP-width", 512)


# ---------------------------------------------------------------------------
# phase 21: the Jukebox path: WAV files -> pooled [T, 4800] encodings -> answers
# ---------------------------------------------------------------------------

JUKEBOX_FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                           "jukebox_parity")
# 8 WAVs, 16-bit PCM at 44.1 kHz, (seconds, channels) each: the window is
# 2^20 samples (23.78 s), so the last two are cropped and the rest padded
JUKEBOX_WAVS = ((3.0, 1), (6.0, 2), (9.5, 1), (14.0, 2), (19.0, 1), (23.0, 2), (30.0, 1),
                (40.0, 2))
JUKEBOX_WIDE_WAV = 7  # (b)'s window: the 40 s clip's first 2^20 samples
JUKEBOX_DEPTH_WAV = 6  # (d)'s clip: the 30 s one, a full window
# (a): the parity fixture on the card against the torch oracle's goldens,
# absolute: the JAX package's bar (tests/test_jukebox_parity.py:86,97)
JUKEBOX_GOLD_ATOL = 1e-6
# (b): full width cut to one attention cycle, fp32, card vs the CPU plain
# path, relative to max. Both sum fp32 products in another order (~1e-6
# relative expected); TF32 products keep 10 mantissa bits (~5e-4 a product
# over 4800 terms), and the phase holds them above this limit
JUKEBOX_WIDE_TOL = 1e-4
# (b): a code may differ where the CPU's two nearest codewords are closer
# than this, relative to |x_t| max|k_j| (the size of a distance term): the
# card's fp32 latent differs from the CPU's by ~1e-6 of its norm
JUKEBOX_MARGIN_EPS = 1e-5
# (d): the CLI's bf16 output against fp32 on the same codes and weights,
# relative to max: the repo's bf16 logits gate
JUKEBOX_BF16_TOL = LOGITS_TOL


def prior_window_flops(cfg: JukeboxPriorConfig) -> float:
    """Multiply-adds x 2 of the prior's projections over one n_ctx window
    (the attention's own products, ~0.3 % more at full width, left out)."""
    w, aw, mw = cfg.width, cfg.attn_width, cfg.mlp_width
    return 2.0 * cfg.n_ctx * cfg.depth * (w * 3 * aw + aw * w + 2 * w * mw)


def write_jukebox_wavs(directory: str) -> list:
    """The 8 WAVs: a chord under noise each, made from the seed."""
    rng = np.random.RandomState(SEED + 21)
    os.makedirs(directory)
    names = []
    for i, (secs, channels) in enumerate(JUKEBOX_WAVS):
        n = int(secs * DEFAULT_SR)
        t = np.arange(n) / DEFAULT_SR
        chord = sum(np.sin(2 * np.pi * f * t) for f in rng.uniform(60, 3000, 3)) / 3
        x = 0.4 * chord[:, None] * (1 + 0.5 * np.sin(2 * np.pi * 0.25 * t))[:, None] \
            + 0.05 * rng.randn(n, channels)
        names.append(f"clip{i}.wav")
        write_wav(os.path.join(directory, names[-1]), x, DEFAULT_SR)
    return names


def jukebox_fixture_run(npz: str, meta: dict, gold, clips) -> tuple:
    """(a)'s run: the fixture bundle on the card in fp32 -> (codes differing
    from the goldens, worst |d| of the pooled embeddings, of the prior's
    activations on the goldens' codes)."""
    enc = JukeboxEncoder.from_npz(npz, pool_frames_per_second=meta["fps"], device="cuda")
    flipped, pooled_err = 0, 0.0
    for name in ("full", "short", "stereo"):
        audio = jb_encode.pad_or_crop(jb_encode.prepare_audio(clips[name]), enc.samples_per_ctx)
        codes = jb_vqvae.encode_top(enc.vq_cfg, enc.vq_params,
                                    torch.from_numpy(audio[None]).cuda())[0, : meta["n_ctx"]]
        flipped += int((codes.cpu().numpy() != gold[f"{name}.codes"]).sum())
        pooled = enc.get_acts_from_audio(clips[name])
        check(pooled.shape == gold[f"{name}.pooled"].shape,
              f"(a) {name}: {pooled.shape[0]} frames, the goldens {gold[f'{name}.pooled'].shape[0]}")
        pooled_err = max(pooled_err, float(np.abs(pooled - gold[f"{name}.pooled"]).max()))
    acts = jb_prior.prior_encode(enc.prior_cfg, enc.prior_params,
                                 torch.from_numpy(gold["full.codes"][None]).cuda(),
                                 *(torch.from_numpy(gold[k]).cuda() for k in ("x_cond", "y_cond")))
    return flipped, pooled_err, float(np.abs(acts[0].cpu().numpy() - gold["full.acts"]).max())


def jukebox_fixture_parity(directory: str) -> None:
    """(a): the parity fixture's state dicts through the port's importer,
    fp32 on the card: codes equal to the goldens, activations and pooled
    embeddings within JUKEBOX_GOLD_ATOL; the same run with TF32 products
    must fall outside."""
    with open(os.path.join(JUKEBOX_FIX, "meta.json")) as f:
        meta = json.load(f)
    npz = os.path.join(directory, "mid.npz")
    jb_import.main(["--vqvae", os.path.join(JUKEBOX_FIX, "vqvae_sd.pt"), "--prior",
                    os.path.join(JUKEBOX_FIX, "prior_sd.pt"), "--output", npz,
                    *meta["import_args"]])
    gold = np.load(os.path.join(JUKEBOX_FIX, "goldens.npz"))
    clips = np.load(os.path.join(JUKEBOX_FIX, "audio.npz"))
    flipped, pooled_err, acts_err = jukebox_fixture_run(npz, meta, gold, clips)
    with tf32_products():
        tf32 = jukebox_fixture_run(npz, meta, gold, clips)
    print(f"  (a) parity fixture (width {meta['width']}, n_ctx {meta['n_ctx']}), fp32 on the card: "
          f"{flipped} codes of 3 x {meta['n_ctx']} differ from the goldens, pooled worst |d| "
          f"{pooled_err:.3e}, acts on the goldens' codes {acts_err:.3e} (gate "
          f"{JUKEBOX_GOLD_ATOL}); control, TF32 products: {tf32[0]} codes differ, pooled "
          f"{tf32[1]:.3e}, acts {tf32[2]:.3e}")
    check(flipped == 0, f"(a): {flipped} codes differ from the goldens")
    check(max(pooled_err, acts_err) <= JUKEBOX_GOLD_ATOL,
          f"(a): pooled {pooled_err:.3e}, acts {acts_err:.3e} over {JUKEBOX_GOLD_ATOL}")
    check(tf32[0] > 0 or max(tf32[1:]) > JUKEBOX_GOLD_ATOL,
          "(a) control: TF32 products flip no code and read within the gate: it cannot "
          "tell them from fp32")


def jukebox_wide_cycle(wav: str) -> None:
    """(b): full width cut to one attention cycle (row, column, previous
    row), fp32, one window, weights drawn on the CPU from the seed: codes
    and activations on the card against the CPU plain path."""
    vq_cfg, pr_cfg = JukeboxVQVAEConfig(), JukeboxPriorConfig(depth=3)
    (vq, pr), draw_s = seconds(lambda: (jb_vqvae.init_vqvae_params(vq_cfg, SEED, "cpu"),
                                             jb_prior.init_prior_params(pr_cfg, SEED, "cpu")))
    samples, _ = read_wav(wav, jb_encode.JUKEBOX_SAMPLE_RATE)
    audio = torch.from_numpy(jb_encode.pad_or_crop(jb_encode.prepare_audio(samples))[None])
    with torch.inference_mode():
        # the CPU: the latent, its codes and each position's top-2 margin
        def cpu_codes():
            x = audio[:, None, :]
            for level in range(vq_cfg.levels):
                x = jb_vqvae.encoder_conv_block(x, vq["levels"][level], vq_cfg, level)
            book = vq["codebooks"][-1]
            dist = 0.5 * book.square().sum(-1) - torch.matmul(x.transpose(1, 2), book.t())
            top2 = dist.topk(2, dim=-1, largest=False).values[0]
            eps = JUKEBOX_MARGIN_EPS * x[0].norm(dim=0) * book.norm(dim=-1).max()
            return dist.argmin(-1)[0], top2[:, 1] - top2[:, 0] < eps

        (codes, near), vq_cpu_s = seconds(cpu_codes)
        acts, cpu_s = seconds(lambda: jb_prior.prior_encode(pr_cfg, pr, codes[None]))
        vq_gpu = jb_encode.tree_to(vq, torch.device("cuda"))
        pr_gpu = jb_encode.tree_to(pr, torch.device("cuda"))
        card_codes = jb_vqvae.encode_top(vq_cfg, vq_gpu, audio.cuda())[0].cpu()
        card = jb_prior.prior_encode(pr_cfg, pr_gpu, codes[None].cuda()).cpu()
        with tf32_products():
            card_tf32 = jb_prior.prior_encode(pr_cfg, pr_gpu, codes[None].cuda()).cpu()
    differ = card_codes != codes
    err, _ = rel_err(card, acts)
    tf32_err, _ = rel_err(card_tf32, acts)
    print(f"  (b) full width, depth 3 (row, column, previous row), fp32, one window: CPU plain path "
          f"({torch.get_num_threads()} threads) weights drawn in {draw_s:.2f} s, VQ-VAE "
          f"{vq_cpu_s:.2f} s, prior {cpu_s:.2f} s "
          f"({prior_window_flops(pr_cfg) / cpu_s / 1e12:.2f} TFLOP/s); codes: {int(differ.sum())} "
          f"of {len(codes)} differ, {int(near.sum())} under the margin eps "
          f"({JUKEBOX_MARGIN_EPS} x |x||k|max), {len(set(codes.tolist()))} distinct; acts "
          f"rel-to-max {err:.3e} (gate {JUKEBOX_WIDE_TOL}); control, TF32 products {tf32_err:.3e}")
    check(not bool((differ & ~near).any()),
          f"(b): {int((differ & ~near).sum())} codes differ where the CPU's margin is above eps")
    check(err <= JUKEBOX_WIDE_TOL, f"(b): acts {err:.3e} over {JUKEBOX_WIDE_TOL}")
    check(tf32_err > JUKEBOX_WIDE_TOL, f"(b) control: TF32 products read {tf32_err:.3e}, "
          f"within {JUKEBOX_WIDE_TOL}: the gate cannot tell them from fp32")


def run_jukebox_cli(wavs: str, out: str, skip_existing: bool = False, profile: bool = False):
    """`extract_cli jukebox` on the card at its defaults (random full-width
    weights from the seed, bf16 prior, batch 2, int16 upload, bf16 readback,
    fps 10), through the CLI's own parser: (its JukeboxRun, the card's
    kernel ms in that run with `profile`, the namespace)."""
    ns = extract_cli.build_parser().parse_args(
        ["jukebox", "--input-dir", wavs, "--output-dir", out, "--device", "cuda"]
        + (["--skip-existing"] if skip_existing else []))
    runs, busy_ms = [], None
    if profile:
        busy_ms = profile_device(lambda: runs.append(ns.fn(ns)), None, top=6,
                                 what="  (c) extract_cli jukebox on the card, the encoder's "
                                      "init included")
    else:
        runs.append(ns.fn(ns))
    return runs[0], busy_ms, ns


def check_jukebox_files(names: list, out: str) -> dict:
    """Each .npy: [floor(floor(8192 n / 2^20) / 34), 4800] fp32, finite,
    where n is the WAV's sample count after the 2^20 crop; returns the
    frame counts."""
    check(sorted(os.listdir(out)) == sorted(n.replace(".wav", ".npy") for n in names),
          f"{out} holds {sorted(os.listdir(out))}")
    frames = {}
    for name, (secs, _) in zip(names, JUKEBOX_WAVS):
        arr = np.load(os.path.join(out, name.replace(".wav", ".npy")))
        n = min(int(secs * DEFAULT_SR), jb_encode.JUKEBOX_EXPECTED_SAMPLES_LEN)
        want = ((8192 * n // jb_encode.JUKEBOX_EXPECTED_SAMPLES_LEN) // 34,
                JukeboxPriorConfig().width)
        check(arr.shape == want and arr.dtype == np.float32,
              f"{name}: {arr.shape} {arr.dtype}, not {want} float32")
        check(bool(np.isfinite(arr).all()), f"{name}: non-finite values")
        frames[name] = arr.shape[0]
    return frames


def jukebox_depth_check(enc, wav: str, npy: str) -> dict:
    """(d): one clip's codes through the 36-layer weights in fp32 on the
    card; the CLI's bf16 .npy against it, and the fp32 run on the codes
    rolled by one position (the control) against it; and one warm bf16
    window's device time."""
    samples, _ = read_wav(wav, jb_encode.JUKEBOX_SAMPLE_RATE)
    prepared = jb_encode.prepare_audio(samples)
    audio = enc._prepare_transfer(jb_encode.pad_or_crop(prepared, enc.samples_per_ctx)[None])
    fp32_cfg = dataclasses.replace(enc.prior_cfg, dtype="float32")
    frame_len = jb_encode.pooled_frame_len(enc.pool_frames_per_second)
    with torch.inference_mode():
        codes = jb_vqvae.encode_top(enc.vq_cfg, enc.vq_params, audio.cuda().float() / 32767.0)

        def pooled(cfg, c):
            return jb_encode.windowed_average(
                jb_prior.prior_encode(cfg, enc.prior_params, c, *enc._conds), frame_len)[0].cpu()

        fp32 = pooled(fp32_cfg, codes)
        rolled = pooled(fp32_cfg, codes.roll(1, dims=1))
        window_ms = median_ms(lambda: jb_prior.prior_encode(enc.prior_cfg, enc.prior_params,
                                                            codes, *enc._conds), n=3)
    got = torch.from_numpy(np.load(npy))
    t = got.shape[0]
    err, _ = rel_err(got, fp32[:t])
    ctl, _ = rel_err(rolled[:t], fp32[:t])
    print(f"  (d) {os.path.basename(npy)} ({t} frames): the CLI's bf16 output against fp32 on the "
          f"same codes and 36-layer weights, rel-to-max {err:.3e} (gate {JUKEBOX_BF16_TOL}); "
          f"control, fp32 on the codes rolled by one {ctl:.3e}")
    check(err <= JUKEBOX_BF16_TOL, f"(d): bf16 {err:.3e} over {JUKEBOX_BF16_TOL}")
    check(ctl > JUKEBOX_BF16_TOL, f"(d) control: rolled codes read {ctl:.3e}, within "
          f"{JUKEBOX_BF16_TOL}: the gate cannot tell a shifted token stream")
    return dict(err=err, ctl=ctl, window_ms=window_ms)


def run_jukebox_path(directory: str, smi: str) -> None:
    """Phase 21: the parity fixture on the card; full width at depth 3 on
    the card and the CPU; WAV files -> `extract_cli jukebox` at full width
    and depth -> pooled [T, 4800] encodings; bf16 against fp32; the
    encodings -> from_encodings' answers."""
    print(f"phase 21 on {smi}: Jukebox, the 5B prior at full width (4800 wide, 36 layers, 8 "
          f"heads of 150, n_ctx 8192 in 128 blocks), the top VQ-VAE encoder (32 channels, "
          f"hop 128, 2048 codes), seeded random weights, {len(JUKEBOX_WAVS)} WAVs, batch 2")
    timings = {}
    _, timings["a"] = seconds(lambda: jukebox_fixture_parity(directory))
    wavs = os.path.join(directory, "wavs")
    names = write_jukebox_wavs(wavs)
    _, timings["b"] = seconds(
        lambda: jukebox_wide_cycle(os.path.join(wavs, names[JUKEBOX_WIDE_WAV])))
    torch.cuda.empty_cache()

    out = os.path.join(directory, "card")
    t0 = time.perf_counter()
    native_build.calls.clear()
    run, busy_ms, ns = run_jukebox_cli(wavs, out, profile=True)
    calls = dict(native_build.calls)
    NATIVE_READS["phase 21, extract_cli jukebox on the card"] = (
        f"native calls {calls}; {run.seconds:.3f} s for {run.n} WAVs, read + prepare "
        f"{run.host_s:.3f} s, {run.host_s / run.seconds:.1%} of it (PR 18 on the numpy parse: "
        f"5.939-6.493 clips/s, 12.0-13.8 %)")
    check(calls.get("parse_wav") == len(names) and not calls.get("resample"),
          f"extract_cli jukebox read its WAVs with native calls {calls}")
    frames = check_jukebox_files(names, out)
    mtimes = {n: os.path.getmtime(os.path.join(out, n)) for n in os.listdir(out)}
    again, _, _ = run_jukebox_cli(wavs, out, skip_existing=True)
    check(again.n == 0 and {n: os.path.getmtime(os.path.join(out, n))
                            for n in os.listdir(out)} == mtimes,
          f"--skip-existing: {again.n} files written again")
    timings["c"] = time.perf_counter() - t0
    audio_s = sum(s for s, _ in JUKEBOX_WAVS)
    print(f"  (c) extract_cli jukebox on the card ({smi}): {run.n} WAVs ({audio_s} s of 44.1 kHz "
          f"audio, {len(names) // 2} windows of 2) in {run.seconds:.3f} s after the encoder's init, "
          f"profiled: {run.n / run.seconds:.3f} clips/s; read + prepare {run.host_s:.3f} s on the "
          f"host ({run.host_s / run.seconds:.1%}), waiting on the device {run.encode_s:.3f} s; "
          f"the card's kernels " + ("not measured" if busy_ms is None else
                                    f"{busy_ms:.1f} ms of the run") +
          f"; frames {sorted(frames.values())}; --skip-existing wrote {again.n}")

    enc, init_s = seconds(lambda: extract_cli.build_jukebox_encoder(ns))
    t0 = time.perf_counter()
    d = jukebox_depth_check(enc, os.path.join(wavs, names[JUKEBOX_DEPTH_WAV]),
                            os.path.join(out, names[JUKEBOX_DEPTH_WAV].replace(".wav", ".npy")))
    timings["d"] = time.perf_counter() - t0
    flops = prior_window_flops(enc.prior_cfg)
    print(f"  the prior, one warm bf16 window on the card ({smi}): {d['window_ms']:.2f} ms for "
          f"{flops / 1e12:.2f} TFLOP of projections, {flops / (d['window_ms'] / 1e3) / 1e12:.1f} "
          f"TFLOP/s, {flops / (d['window_ms'] / 1e3) / PEAK_BF16_FLOPS:.1%} of 989 TFLOP/s; "
          f"the encoder's init {init_s:.2f} s")
    del enc
    torch.cuda.empty_cache()
    _, timings["e"] = seconds(
        lambda: encodings_answers(directory, out, smi, "Jukebox-width", 4800))
    print("  (a)-(e) seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in timings.items()))


# ---------------------------------------------------------------------------
# phase 22: Mixture-of-Experts at Mixtral-8x7B width
# ---------------------------------------------------------------------------

# Mixtral-8x7B's widths, from the public mistralai/Mixtral-8x7B-v0.1
# config.json: hidden 4096, intermediate 14336, 32 query heads over 8 KV
# heads (head_dim 128), 8 experts of which 2 a token, rope_theta 1e6; with
# LLark's vocabulary (32000 + 4) and projector (4800). A layer holds 1.451 B
# parameters (1.409 B of them experts): 32 layers in bf16 are 93 GB, more
# than the card holds, so serving runs 8 layers (23.8 GB) and training, whose
# parameters are fp32, 2.
MOE_SERVE_LAYERS = 8
MOE_TRAIN_LAYERS = 2
# (b) one layer's moe_ffn in fp32 (TF32 off), the card against the CPU's
# plain path on the same weights, relative to max; TF32 products must land
# above it. A token whose router probabilities on the CPU hold two of its
# top k + 1 within MOE_MARGIN_EPS may choose another expert (or order) on the
# card: such tokens are counted and their rows left out of the comparison.
MOE_TOL = 1e-4
MOE_MARGIN_EPS = 1e-5
# the bf16 routes of (c)-(e): the plain route follows the kernel route's
# expert choices (pinned_routes); its own choices may differ from them where
# its router probabilities hold two of its top k + 1 within this (the two
# routes' hidden states differ by bf16 rounding, unit roundoff 3.9e-3); a
# flip at a wider margin fails the gate (pinned_flips)
MOE_BF16_MARGIN_EPS = 1e-2
MOE_BLOCK_SHAPE = (2, 64)  # (b)'s tokens: 2 sequence rows (capacity groups) of 64
# (d)'s fp32 engine runs, whose streams are held: 2 layers of fp32 weights
MOE_FP32_LAYERS = 2


def mixtral_cfg(**kw) -> ModelConfig:
    base = dict(vocab_size=32004, hidden_size=4096, intermediate_size=14336,
                num_layers=MOE_SERVE_LAYERS, num_heads=32, num_kv_heads=8, max_seq_len=32768,
                rope_theta=1e6, rms_norm_eps=1e-5, moe_num_experts=8, moe_top_k=2,
                mm_hidden_size=4800)
    base.update(kw)
    return ModelConfig(**base)


def moe_products(cfg: ModelConfig) -> int:
    """int8 products a forward launches: the 4 attention projections and
    each expert's 3 of every layer (experts run one K5 launch a product)."""
    return cfg.num_layers * (4 + 3 * cfg.moe_num_experts)


def control(what: str, err: float, limit: float) -> None:
    """A control must fail the gate it stands beside."""
    print(f"  control, {what}: {err:.3e}, must exceed {limit:g}")
    check(err > limit, f"control {what}: {err:.3e} passed the gate ({limit:g})")


def rolled_heads(t: torch.Tensor) -> torch.Tensor:
    """K/V (or their scales) with the KV heads rolled by one: every query
    group reads its neighbour's head, the fault a wrong GQA mapping makes."""
    return torch.roll(t, 1, dims=1)


def check_gqa_kernels(gen: torch.Generator, plen: int) -> None:
    """(a) K1 and K2 at GQA group 4, head_dim 128, the Mixtral shapes: each
    held per row against its plain version; the control reads the plain
    version over rolled KV heads."""
    q = bf16_randn(gen, 1, 32, 384, 128)
    k, v = bf16_randn(gen, 1, 8, 384, 128), bf16_randn(gen, 1, 8, 384, 128)
    kv = torch.tensor([plen], dtype=torch.int32, device="cuda")
    got = attn_ops.flash_attention_fwd(q, k, v, kv_lengths=kv)
    torch.cuda.synchronize()
    kw = dict(causal=True, kv_lengths=kv, slopes=None)
    check_close("flash_fwd", f"GQA group 4, q [1,32,384,128] over k/v [1,8,384,128], kv_len {plen}",
                got, attn_ops._flash_attention_fwd_plain(q, k, v, **kw))
    wrong = attn_ops._flash_attention_fwd_plain(q, rolled_heads(k), rolled_heads(v), **kw)
    control("K1 against its plain version over rolled KV heads (row)", row_err(got, wrong),
            ROW_TOL["flash_fwd"])
    for mode, bs, name in (("bf16", 128, "dense bf16"), ("paged_int8", 128,
                                                         "paged int8, 128-token blocks")):
        q, k, v, kw = k2_inputs(gen, mode, hkv=8, bs=bs)
        got = dec_ops.flash_decode_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        check_close("flash_decode", f"GQA group 4, q [8,32,1,128] over a {name} cache "
                    f"[8,8,2048,128], kv_len 300-340", got, k2_plain(q, k, v, kw))
        wrong = dict(kw)
        for key in ("k_scale", "v_scale"):
            if key in kw:
                wrong[key] = rolled_heads(kw[key])
        control(f"K2 {name} against its plain version over rolled KV heads (row)",
                row_err(got, k2_plain(q, rolled_heads(k), rolled_heads(v), wrong)),
                ROW_TOL["flash_decode"])


def moe_choices(cfg: ModelConfig, router: torch.Tensor, y: torch.Tensor):
    """The experts each token chooses, in order ([B, S, K]), and whether two
    of its top k + 1 router probabilities lie within MOE_MARGIN_EPS ([B, S])."""
    probs = torch.softmax(torch.matmul(y.float(), router.float()), dim=-1)
    top = probs.topk(cfg.moe_top_k + 1, dim=-1)
    gaps = top.values[..., :-1] - top.values[..., 1:]
    return top.indices[..., :-1], gaps.min(-1).values < MOE_MARGIN_EPS


def check_moe_block() -> None:
    """(b) One full-width layer's moe_ffn in fp32, on the card and on the
    CPU, with the same weights (drawn on the card from the seed, a copy on
    the host: a CPU draw of 1.41 B values took 9.6-12.8 s): "switch" routing
    at capacity factor 1 (tokens drop) and "mixtral" (none do)."""
    b, s = MOE_BLOCK_SHAPE
    one = mixtral_cfg(num_layers=1, dtype="float32", param_dtype="float32")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    lp_card = {k: w[0] for k, w in moe_mod.init_moe_layer_params(
        one, lambda shape, fan_in: torch.randn(shape, generator=g, device="cuda").div_(
            fan_in ** 0.5)).items()}
    y_card = torch.randn((b, s, one.hidden_size), generator=g, device="cuda")
    lp, y = {k: w.cpu() for k, w in lp_card.items()}, y_card.cpu()
    draw_s = time.perf_counter() - t0
    print(f"  (b) one layer's experts, {sum(w.numel() for w in lp.values()) / 1e9:.3f} B fp32 "
          f"values drawn on the card from the seed and copied to the host in {draw_s:.1f} s; "
          f"tokens [{b}, {s}, 4096]")
    for routing, cf in (("switch", 1.0), ("mixtral", 4.0)):
        cfg = dataclasses.replace(one, moe_routing=routing, moe_capacity_factor=cf)
        with torch.inference_mode():
            t0 = time.perf_counter()
            out_cpu, m_cpu = moe_mod.moe_ffn(cfg, lp, y)
            cpu_s = time.perf_counter() - t0
            out_card, m_card = moe_mod.moe_ffn(cfg, lp_card, y_card)
            with tf32_products():
                out_tf32, _ = moe_mod.moe_ffn(cfg, lp_card, y_card)
            want, near = moe_choices(cfg, lp["moe_router"], y)
            got, _ = moe_choices(cfg, lp_card["moe_router"], y_card)
        flips = (got.cpu() != want).any(-1)
        check(not bool((flips & ~near).any()),
              f"(b) {routing}: {int((flips & ~near).sum())} tokens chose other experts on the card "
              f"with a CPU top-k margin above {MOE_MARGIN_EPS:g}")
        # a flip moves the capacity slots of the later tokens of its row:
        # rows with a near tie are left out
        rows = ~near.any(-1)
        check(bool(rows.any()), f"(b) {routing}: every row holds a near tie")
        err, diff = rel_err(out_card.cpu()[rows], out_cpu[rows])
        tf32_err, _ = rel_err(out_tf32.cpu()[rows], out_cpu[rows])
        print(f"  (b) {routing}, capacity factor {cf:g} (C = {moe_mod.expert_capacity(s, cfg)}): "
              f"card vs CPU rel-to-max {err:.3e} (max|d| {diff:.3e}) over {int(rows.sum())} of {b} "
              f"rows; near ties (margin < {MOE_MARGIN_EPS:g}) {int(near.sum())}, choices flipped "
              f"{int(flips.sum())}; aux_loss {float(m_card['aux_loss']):.6f} (CPU "
              f"{float(m_cpu['aux_loss']):.6f}), dropped_frac {float(m_card['dropped_frac']):.6f} "
              f"(CPU {float(m_cpu['dropped_frac']):.6f}); the CPU's moe_ffn {cpu_s:.2f} s")
        check(bool(torch.isfinite(out_card).all()), f"(b) {routing}: non-finite output")
        check(err <= MOE_TOL, f"(b) {routing}: card vs CPU {err:.3e} > {MOE_TOL}")
        control(f"(b) {routing} with TF32 products, card vs CPU (rel-to-max)", tf32_err, MOE_TOL)
        if routing == "switch":
            check(float(m_cpu["dropped_frac"]) > 0, "(b) switch at cf 1 dropped no token")
        else:
            check(float(m_card["dropped_frac"]) == 0.0, "(b) mixtral dropped a token")
    del lp, lp_card
    torch.cuda.empty_cache()


def moe_decode_bytes(cfg: ModelConfig) -> tuple:
    """Weight bytes one decode step reads in bf16 at batch 1: (the port's
    dispatch, every expert of every layer; only the k chosen ones)."""
    h, i, e = cfg.hidden_size, cfg.intermediate_size, cfg.moe_num_experts
    attn = 2 * h * (cfg.num_heads + cfg.num_kv_heads) * cfg.head_dim  # wq, wk, wv, wo
    expert = 3 * h * i
    head = h * cfg.vocab_size
    dense = 2 * (cfg.num_layers * (attn + e * expert + h * e) + head)
    chosen = 2 * (cfg.num_layers * (attn + cfg.moe_top_k * expert + h * e) + head)
    return dense, chosen


@contextlib.contextmanager
def recorded_routes():
    """Inside, every MoE layer's router probabilities [B, S, E] and expert
    choices [B, S, K] are appended to the yielded list as (probs, choices),
    in call order."""
    real, seen = moe_mod.top_k_experts, []

    def top_k_experts(cfg, probs):
        seen.append((probs.detach(), real(cfg, probs)))
        return seen[-1][1]

    moe_mod.top_k_experts = top_k_experts
    try:
        yield seen
    finally:
        moe_mod.top_k_experts = real


@contextlib.contextmanager
def pinned_routes(seen: list):
    """Inside, the MoE layers choose the experts that `seen` (recorded_routes)
    holds, in call order, each with its own router probabilities for the
    gates; the yielded list records what each layer would have chosen, as
    recorded_routes does. `pinned_flips` of the two lists shows that pinning
    moved only near-tied choices."""
    real, calls, own = moe_mod.top_k_experts, iter(seen), []

    def top_k_experts(cfg, probs):
        chosen = next(calls)[1]
        check(chosen.shape == probs.shape[:-1] + (cfg.moe_top_k,), "pinned routes do not fit")
        own.append((probs.detach(), real(cfg, probs)))
        return chosen

    moe_mod.top_k_experts = top_k_experts
    try:
        yield own
    finally:
        moe_mod.top_k_experts = real
    check(next(calls, None) is None, "a pinned route was left over")


@contextlib.contextmanager
def rolled_kv_attention():
    """Inside, the decoder's multi-token attention reads K and V with the KV
    heads rolled by one (`rolled_heads`): the fault a wrong GQA mapping
    makes, which the routed gates must catch."""
    real = decoder_mod.multihead_attention
    decoder_mod.multihead_attention = lambda q, k, v, **kw: real(q, rolled_heads(k),
                                                                 rolled_heads(v), **kw)
    try:
        yield
    finally:
        decoder_mod.multihead_attention = real


def pinned_flips(pinned, own) -> dict:
    """Where a route pinned to another's expert choices (pinned_routes) would
    have chosen otherwise, layer by layer (lists of (probs, choices) in call
    order, as recorded_routes and pinned_routes give them): {"near": flips
    where the pinned route's own router probabilities hold two of its top
    k + 1 within MOE_BF16_MARGIN_EPS, a near tie that rounding flips;
    "widest near": the widest such margin; "wide": every other flip}."""
    check(len(pinned) == len(own), "the two routes ran different numbers of MoE layers")
    flips = {"near": 0, "widest near": 0.0, "wide": 0}
    for (_, chosen), (probs, would) in zip(pinned, own):
        top = probs.topk(would.shape[-1] + 1, dim=-1).values
        margin = (top[..., :-1] - top[..., 1:]).min(-1).values  # [B, S]
        flip = (chosen != would).any(-1)
        near = flip & (margin < MOE_BF16_MARGIN_EPS)
        flips["near"] += int(near.sum())
        flips["wide"] += int((flip & ~near).sum())
        if near.any():
            flips["widest near"] = max(flips["widest near"], margin[near].max().item())
    return flips


def flips_text(flips: dict) -> str:
    return (f"its own expert choices differ from the pinned ones at a near tie {flips['near']} "
            f"times (widest margin {flips['widest near']:.2e}), wider {flips['wide']}")


def pinned_rel_err(got, want, pinned, own) -> tuple:
    """Next-token logits [B, V] of a route against a reference route pinned
    to its expert choices (every row; a dense model has no choices), and
    the reference's own choices against the pinned ones (pinned_flips).
    Returns (whether the gate passes: no wide flip and rel-to-max within
    LOGITS_TOL, the reading as text)."""
    rel, diff = rel_err(got, want)
    text = f"rel-to-max {rel:.3e} (max|d| {diff:.3e})"
    if not pinned:
        return rel <= LOGITS_TOL, text
    flips = pinned_flips(pinned, own)
    return flips["wide"] == 0 and rel <= LOGITS_TOL, f"{text}; {flips_text(flips)}"


def moe_one_request(cfg: ModelConfig, bundle: TokenizerBundle, rows, params, wq=None) -> None:
    """(c) `batch_infer` over the 4 requests and its launches; the 4 requests
    as one batch, prefill and one decode step, through the kernel route
    against the plain route (plain attention for bf16 weights, the plain
    products for a quantized tree) pinned to its expert choices; then batch-1
    prefill and decode times, and from bf16 weights the device split of a
    short generate."""
    label = "bf16 weights" if wq is None else f"{wq} weights"
    generator = Generator(cfg, params, bundle.audio_patch_id, GenerationConfig(max_new_tokens=32),
                          max_cache_len=2048)
    attn_ops.flash_attention_fwd.launches = 0
    dec_ops.reset_launch_counts()
    reset_wq_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = batch_infer(rows, generator, bundle)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = attn_ops.flash_attention_fwd.launches
    k2 = {m: n for m, n in dec_ops.flash_decode_attention.launches_by_mode.items() if n}
    own = WQ_KERNELS[wq].launches if wq else 0
    print(f"  (c) batch_infer ({label}): {len(results)} requests in {wall:.2f} s; K1 {k1}, K2 by "
          f"cache mode {k2}" + (f", {wq} products {own}" if wq else ""))
    check(len(results) == len(rows), "(c) batch_infer lost a row")
    check_completions(f"(c) batch_infer ({label})", results)
    check(k1 == cfg.num_layers * len(rows),
          f"(c) {k1} flash-prefill launches, not {cfg.num_layers} x {len(rows)}")
    check(set(k2) == {"dense_bf16"} and k2["dense_bf16"] % cfg.num_layers == 0,
          f"(c) flash-decode launches {k2}: not dense bf16 alone, once a layer a step")
    if wq is None:
        check(all(fn.launches == 0 for fn in WQ_KERNELS.values()),
              "(c) bf16 weights launched a quantized product")
    else:
        check(own > 0 and own % moe_products(cfg) == 0,
              f"(c) {own} {wq} launches is no positive multiple of {moe_products(cfg)}")

    # kernel route against the plain route, the 4 requests as one batch;
    # the control, the plain route over rolled KV heads
    marks = [time.perf_counter()]
    batch = spec_batch(bundle, rows)
    plen = batch[1]
    exact = GenerationConfig(max_new_tokens=32, stop_text="")
    if wq is None:
        plain_cfg = dataclasses.replace(cfg, use_pallas_attention=False, use_flash_decode=False)
        plain, plain_name = contextlib.nullcontext, "the plain attention path"
    else:
        plain_cfg, plain, plain_name = cfg, plain_products, "the plain products"
    # the plain and control routes follow the kernel route's expert choices
    # (pinned); "unpinned", the plain route on its own choices, is printed
    routes = {"kernel": (cfg, [contextlib.nullcontext]), "plain": (plain_cfg, [plain]),
              "control": (plain_cfg, [plain, rolled_kv_attention]),
              "unpinned": (plain_cfg, [plain])}
    logits, chosen = {}, {}
    pos = torch.as_tensor(plen, dtype=torch.int64, device="cuda")
    with torch.inference_mode():
        for route, (c, ctxs) in routes.items():
            pin = route in ("plain", "control")
            with contextlib.ExitStack() as stack:
                for ctx in ctxs:
                    stack.enter_context(ctx())
                seen = stack.enter_context(pinned_routes(chosen["kernel"]) if pin else
                                           recorded_routes())
                gen = Generator(c, params, bundle.audio_patch_id, exact, max_cache_len=2048)
                first, cache = gen.prefill(*batch)
                token = (first if route == "kernel" else logits["kernel"][0]).argmax(-1)
                if route == "kernel":
                    reset_wq_counts()
                    dec_ops.reset_launch_counts()
                step = decode_step(c, params, token, cache, pos)[0]
                if route == "kernel":
                    n2 = dec_ops.flash_decode_attention.launches
                    check(n2 == cfg.num_layers, f"(c) one decode step: {n2} K2 launches")
                    if wq:
                        n = WQ_KERNELS[wq].launches
                        check(n == moe_products(cfg), f"(c) one decode step: {n} {wq} launches, "
                              f"not {moe_products(cfg)}")
                del cache
            logits[route], chosen[route] = (first, step), seen
    check(all(bool(torch.isfinite(t).all()) for t in logits["kernel"]), "(c) non-finite logits")
    n_prefill = len(chosen["kernel"]) // 2  # the prefill's layers, then the step's
    for i, what, part in ((0, "prefill", slice(0, n_prefill)),
                          (1, "one decode step", slice(n_prefill, None))):
        readings = {route: pinned_rel_err(logits["kernel"][i], logits[route][i],
                                          chosen["kernel"][part], chosen[route][part])
                    for route in ("plain", "control")}
        ok, reading = readings["plain"]
        print(f"  (c) {label}, the 4 requests as a batch (prompts {plen.tolist()} padded to "
              f"{batch[0].shape[1]}): {what} logits, kernel route vs {plain_name} pinned to its "
              f"expert choices: {reading}")
        check(ok, f"(c) {label}: {what} logits {reading}")
        ok, reading = readings["control"]
        print(f"  control, (c) {label}, {what}: against {plain_name} over rolled KV heads, "
              f"pinned alike: {reading}")
        check(not ok, f"control (c) {label} {what}: the faulty route passed the gate")
        rel, _ = rel_err(logits["kernel"][i], logits["unpinned"][i])
        flips = pinned_flips(chosen["kernel"][part], chosen["unpinned"][part])
        print(f"  (c) {label}, {what}, {plain_name} on its own expert choices (not gated): "
              f"logits rel-to-max {rel:.3e}; its choices differ from the kernel route's at "
              f"{flips['near']} near ties and {flips['wide']} wider (a token that flipped "
              f"follows other experts from there on, and so do those attending to it)")
    # batch 1: prefill and decode speed, as batch_infer runs a request
    marks.append(time.perf_counter())
    args = tuple(a[:1] for a in batch)
    gen_k = Generator(cfg, params, bundle.audio_patch_id, exact, max_cache_len=2048)
    prefill_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            _, cache = gen_k.prefill(*args)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        del cache
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = gen_k.generate(*args)[0]
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t0) * 1e3
    p_ms = statistics.median(prefill_ms)
    decode_ms = (gen_ms - p_ms) / (len(toks) - 1)
    marks.append(time.perf_counter())
    if wq is None:
        # the device split of a short generate: the profiler's own cost grows
        # with the events (32 tokens took it 40 s)
        short = Generator(cfg, params, bundle.audio_patch_id,
                          GenerationConfig(max_new_tokens=4, stop_text=""), max_cache_len=2048)
        _, short_s = seconds(lambda: short.generate(*args))
        profile_device(lambda: short.generate(*args), short_s * 1e3,
                       what="one generate (prefill + 3 decode steps)")
    marks.append(time.perf_counter())
    print(f"  (c) {label}: prefill {p_ms:.2f} ms, decode {decode_ms:.2f} ms/token "
          f"({1e3 / decode_ms:.1f} tok/s) at batch 1, parameters {param_bytes(params) / 1e9:.2f} "
          f"GB; seconds: batch_infer {wall:.1f}, the routes {marks[1] - marks[0]:.1f}, batch-1 "
          f"timing {marks[2] - marks[1]:.1f}, the profiled generate {marks[3] - marks[2]:.1f}")


def moe_reference_streams(cfg: ModelConfig, params, patch_id: int, reqs) -> tuple:
    """batch_infer's streams of the serving requests: each request alone
    through the Generator (prefill, then 31 decode steps) in `cfg`'s cache
    format. Returns (streams, each step's top-2 logit margin [n, 32])."""
    exact = GenerationConfig(max_new_tokens=32, stop_text="")
    gen = Generator(cfg, params, patch_id, exact, max_cache_len=2048)
    streams, margins = [], []
    for r in reqs:
        plen = len(r.input_ids)
        s = int(np.ceil(plen / 128) * 128)
        ids = np.zeros((1, s), np.int32)
        ids[0, :plen] = r.input_ids
        logits, cache = gen.prefill(ids, np.array([plen], np.int32), r.audio_encoding[None],
                                    np.array([r.audio_encoding.shape[0]], np.int32))
        toks, m = [], []
        for t in range(32):
            top2 = logits.topk(2, dim=-1).values[0]
            m.append(float(top2[0] - top2[1]))
            toks.append(int(logits.argmax(-1)))
            if t < 31:
                logits, cache = decode_step(cfg, params, logits.argmax(-1), cache,
                                            torch.tensor([plen + t], device="cuda"))
        del cache
        streams.append(toks)
        margins.append(m)
    return streams, np.array(margins)


def first_difference(got, ref) -> int:
    return next((t for t, (a, b) in enumerate(zip(got, ref)) if a != b), min(len(got), len(ref)))


def moe_serving(cfg: ModelConfig, bundle: TokenizerBundle, params) -> None:
    """(d) BatchedServer in modes (a) and (b) from bf16 weights, 16 requests
    x 32 tokens, with phase 7's gates; the first wave's 8 streams beside
    batch_infer's (one request at a time), printed. Not gated: at bf16 a wave of 8 and a single
    request round their products differently, which flips an expert choice
    whose router probabilities nearly tie, and the token then follows other
    experts (its logits move by O(1), far past any top-2 margin); mode (a)
    also reads its prompt back from int8 K/V. `moe_fp32_streams` holds the
    streams at fp32."""
    launches, figures = run_serving_engine(cfg, bundle, params, modes="ab")
    with torch.inference_mode():  # the first wave's 8 requests
        ref, _ = moe_reference_streams(cfg, params, bundle.audio_patch_id,
                                       serving_requests(cfg, bundle, 8, SEED))
    for label in "ab":
        got = figures[label]["tokens"][:8]
        print(f"  (d) mode ({label}), bf16: {sum(g == r for g, r in zip(got, ref))} of 8 streams "
              f"equal batch_infer's throughout; the first step that differs, per stream "
              f"{[first_difference(g, r) for g, r in zip(got, ref)]} (not gated: routing flips "
              f"under bf16 rounding); K2 by cache mode "
              f"{ {m: n for m, n in launches[label].items() if n} }")


# (d)'s fp32 engine runs: (label, what, K2's cache mode, the engine's options,
# whether batch_infer's reference prefills through K1). One-shot admission
# prefills through K1, which rounds fp32 operands to bf16 (PR 7), and is held
# against batch_infer through K1; chunked admission attends through the
# plain route in fp32, and is held against batch_infer on the plain route.
MOE_FP32_MODES = (
    ("b", "one-shot admission, dense fp32 cache", "dense_fp32", {}, True),
    ("a", "mode (a)'s geometry: paged 128-token blocks, prefill_chunk 256, the pool in fp32",
     "paged_fp32", dict(kv_block_size=128, prefill_chunk=256), False),
)


def moe_fp32_streams(bundle: TokenizerBundle) -> None:
    """(d) at fp32 (TF32 off), MOE_FP32_LAYERS layers, 16 requests x 32
    tokens through the engine in each of MOE_FP32_MODES: every stream equal
    to batch_infer's (one request at a time, its prefill attending as the
    engine's admission does) up to its first step whose top-2 margin is
    under NEAR_TIE; K2 in the run's cache mode alone. The control: each
    stream against the next request's reference."""
    cfg = mixtral_cfg(num_layers=MOE_FP32_LAYERS, dtype="float32", param_dtype="float32",
                      use_flash_decode=True, moe_routing="mixtral", moe_capacity_factor=4.0)
    params = init_llark_params(cfg, seed=SEED, device="cuda")
    gen_cfg = GenerationConfig(max_new_tokens=32, stop_text="")
    for label, name, own_mode, extra, k1_reference in MOE_FP32_MODES:
        ref_cfg = cfg if k1_reference else dataclasses.replace(cfg, use_pallas_attention=False)
        with torch.inference_mode():
            ref, margins = moe_reference_streams(ref_cfg, params, bundle.audio_patch_id,
                                                 serving_requests(cfg, bundle, 16, SEED))
        near = [int(np.argmax(m < NEAR_TIE)) if (m < NEAR_TIE).any() else 32 for m in margins]
        server = BatchedServer(cfg, params, bundle.audio_patch_id, gen_cfg,
                               **dict(SERVING_BASE, tokenizer=bundle.tokenizer, **extra))
        reqs = serving_requests(cfg, bundle, 16, SEED)
        dec_ops.reset_launch_counts()
        attn_ops.flash_attention_fwd.launches = 0
        with torch.inference_mode():
            _, wall = seconds(lambda: server.serve(reqs))
        by_mode = {m: n for m, n in dec_ops.flash_decode_attention.launches_by_mode.items() if n}
        k1 = attn_ops.flash_attention_fwd.launches
        got = [r.tokens for r in reqs]
        check(all(r.done and r.error is None and len(r.tokens) == 32 for r in reqs),
              f"(d) fp32 ({label}): a request did not finish with 32 tokens")
        check(set(by_mode) == {own_mode}, f"(d) fp32 ({label}): flash-decode launches {by_mode}")
        # one-shot admission: one launch a layer a wave; chunks attend plainly
        want_k1 = 0 if "prefill_chunk" in extra else 2 * cfg.num_layers
        check(k1 == want_k1, f"(d) fp32 ({label}): {k1} flash-prefill launches, not {want_k1}")
        differ = [first_difference(g, r) for g, r in zip(got, ref)]
        equal = sum(g == r for g, r in zip(got, ref))
        print(f"  (d) fp32 ({label}), {cfg.num_layers} layers, {name}: 16 requests x 32 tokens in "
              f"{wall:.2f} s; {equal} of 16 streams equal batch_infer's (prefill "
              f"{'through K1' if k1_reference else 'on the plain route'}) throughout; per stream, "
              f"the first step that differs {differ} and batch_infer's first near tie (top-2 "
              f"margin < {NEAR_TIE:g}) {near}; smallest margin {margins.min():.3e}; K1 {k1}, K2 by "
              f"cache mode {by_mode}")
        for i, (d, n) in enumerate(zip(differ, near)):
            if d < n:
                check(False, f"(d) fp32 ({label}): stream {i} leaves batch_infer's at step {d} "
                      f"(reference margin {margins[i, d]:.3e}) before its first near tie ({n})")
        shifted = [first_difference(g, r) for g, r in zip(got, ref[1:] + ref[:1])]
        caught = sum(d < n for d, n in zip(shifted, near))
        print(f"  control, (d) fp32 ({label}) against the next request's streams: {caught} of 16 "
              f"leave them before their first near tie")
        check(caught > 0, f"control (d) fp32 ({label}): every shifted stream passed")
        del server
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()


def moe_training(directory: str, cfg: ModelConfig) -> None:
    """(e) The adapter stage at Mixtral width, 2 layers, "switch" routing at
    capacity factor 1.25: one step's loss and projector gradient through the
    kernels against the plain attention path pinned to the kernel route's
    expert choices (under "switch" a flipped choice reshuffles the capacity
    slots of the row's later tokens), where the plain route's own choices
    may differ from the pinned ones only at near ties (pinned_flips; the
    control: the plain route over rolled KV heads, pinned alike), then
    train() for 3 steps with the flash launch gates, its MoE metrics and
    MFU."""
    t0 = time.perf_counter()
    shard = write_shards(directory, cfg)
    model_args, data_args, _ = train_args(os.path.join(directory, "grad"), shard, 1)
    bundle = TokenizerBundle.from_tokenizer(WordTokenizer(1024))
    batch = next(iter(make_data_module(
        bundle, data_args, batch_size=2, max_seq_len=1024, mm_hidden_size=cfg.mm_hidden_size,
        seed=SEED)["train_iterator"]()))
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items() if isinstance(v, np.ndarray)}
    params = init_llark_params(cfg, seed=SEED, device="cuda")
    proj = params["mm_projector"]["kernel"].requires_grad_()
    results = {}
    # one forward without remat, so that each layer routes once
    kernel = dataclasses.replace(cfg, remat=False)
    plain = dataclasses.replace(kernel, use_pallas_attention=False)
    seen = []
    for route, c, fault in (("kernel", kernel, None), ("plain", plain, None),
                            ("control", plain, rolled_kv_attention)):
        attn_ops.flash_attention_bwd.launches = 0
        ctx = recorded_routes() if route == "kernel" else pinned_routes(seen)
        with ctx as recorded, (fault or contextlib.nullcontext)():
            loss, _, moe = make_loss_fn(c, audio_patch_id=bundle.audio_patch_id)(params, batch)
            loss = train_loss(c, loss, moe)
            (grad,) = torch.autograd.grad(loss, [proj])
        if route == "kernel":
            seen = recorded
        results[route] = (loss.item(), grad, attn_ops.flash_attention_bwd.launches,
                          {k: float(v.detach()) for k, v in moe.items()}, recorded)
    lk, gk, nk, mk, _ = results["kernel"]
    check(nk == cfg.num_layers, "(e) the kernel route did not run the flash backward")
    check(all(np.isfinite(v) for v in mk.values()) and mk["moe_dropped_frac"] < 1,
          f"(e) MoE metrics {mk}")

    def gate(route):
        lp, gp, _, _, own = results[route]
        rel, _ = rel_err(gk, gp)
        flips = pinned_flips(seen, own)
        ok = abs(lk - lp) <= TRAIN_ABS_LOSS_TOL and rel <= TRAIN_GRAD_TOL and flips["wide"] == 0
        return ok, (f"loss {lk:.5f} (kernels) vs {lp:.5f}, projector gradient rel-to-max "
                    f"{rel:.3e}; {flips_text(flips)}")

    ok, reading = gate("plain")
    print(f"  (e) one step, batch 2 x 1024, {len(seen)} layers routed, the plain route pinned to "
          f"the kernel route's choices: {reading}; flash backward launches {nk}; MoE {mk}")
    check(ok, f"(e) {reading}")
    ok, reading = gate("control")
    print(f"  control, (e) the plain route over rolled KV heads, pinned alike: {reading}")
    check(not ok, "control (e): the faulty route passed the gate")
    del params, proj, batch, results
    torch.cuda.empty_cache()
    print(f"  (e) the one-step gates: {time.perf_counter() - t0:.1f} s")
    run_dir = os.path.join(directory, "adapter")
    _, result = run_training(f"  (e) adapter stage, Mixtral-8x7B width, {cfg.num_layers} layers",
                             cfg, run_dir, shard, 3, frozen_base=True, lr=1e-3, keep=True,
                             freeze_backbone=True, tune_mm_mlp_adapter=True)
    with open(os.path.join(run_dir, "out", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f if '"loss"' in line]
    aux = [r["moe_aux_loss"] for r in records]
    dropped = [r["moe_dropped_frac"] for r in records]
    print(f"  (e) moe_aux_loss per step {aux}; moe_dropped_frac per step {dropped}")
    check(len(aux) == 3 and all(np.isfinite(aux + dropped)),
          "(e) MoE metrics missing or non-finite")
    del result
    shutil.rmtree(run_dir)
    torch.cuda.empty_cache()


def moe_checkpoint(directory: str, cfg: ModelConfig) -> None:
    """(f) save_hf_checkpoint -> load_pretrained_backbone of a 1-layer
    full-width Mixtral: bit for bit, "mixtral" routing with capacity factor
    E / K selected; the control, the experts rolled by one."""
    one = dataclasses.replace(cfg, num_layers=1)
    params = init_llark_params(one, seed=SEED, device="cuda")
    path = os.path.join(directory, "mixtral-1layer")
    _, export_s = seconds(lambda: hf.save_hf_checkpoint(path, one, params))
    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)
    check(config["architectures"] == ["MixtralForCausalLM"] and config["num_local_experts"] == 8,
          f"(f) config.json {config}")
    named = train_mod.model_config_from_name(path, ModelArguments(mm_hidden_size=4800))
    fields = ("hidden_size", "intermediate_size", "num_heads", "num_kv_heads", "rope_theta",
              "moe_num_experts", "moe_top_k")
    check(all(getattr(named, f) == getattr(one, f) for f in fields),
          f"(f) model_config_from_name: {named}")
    switch = dataclasses.replace(one, moe_routing="switch", moe_capacity_factor=1.25)
    got, import_s = seconds(lambda: hf.load_pretrained_backbone(path, switch, device="cuda"))
    check((switch.moe_routing, switch.moe_capacity_factor) == ("mixtral", 4.0),
          f"(f) the import selected {switch.moe_routing} at cf {switch.moe_capacity_factor}")
    bad = backbone_equal(got, params)
    check(not bad, f"(f) the import differs from the exported params at {bad}")
    rolled = dict(params, layers=dict(params["layers"],
                                      moe_w_up=params["layers"]["moe_w_up"].roll(1, dims=1)))
    wrong = backbone_equal(got, rolled)
    print(f"  control, (f) the import against the experts rolled by one: differs at {wrong}")
    check(wrong == ["layers/moe_w_up"], f"control (f): {wrong}")
    size = os.path.getsize(os.path.join(path, "pytorch_model.bin")) / 1e9
    print(f"  (f) 1-layer Mixtral-width export {size:.2f} GB (fp32) in {export_s:.2f} s, import "
          f"onto the card in {import_s:.2f} s, bit for bit; routing {switch.moe_routing}, capacity "
          f"factor {switch.moe_capacity_factor:g}")
    shutil.rmtree(path)
    del params, got, rolled
    torch.cuda.empty_cache()


def run_moe_path(directory: str, smi: str) -> None:
    """Phase 22: the Mixture-of-Experts path at Mixtral-8x7B width."""
    cfg = mixtral_cfg(use_flash_decode=True, param_dtype="bfloat16", moe_routing="mixtral",
                      moe_capacity_factor=4.0)
    dense, chosen = moe_decode_bytes(cfg)
    print(f"phase 22 on {smi}: Mixtral-8x7B width (hidden 4096, 14336 intermediate, 32 query "
          f"heads over 8 KV heads, 8 experts, top-2), {cfg.num_layers} layers for serving, "
          f"{MOE_TRAIN_LAYERS} for training, seeded random weights; a decode step at batch 1 "
          f"reads {dense / 1e9:.2f} GB of bf16 weights in the port's dispatch (every expert: "
          f"floor {dense / PEAK_BYTES_S * 1e3:.2f} ms at 3.35 TB/s), {chosen / 1e9:.2f} GB if "
          f"only the 2 chosen experts were read ({chosen / PEAK_BYTES_S * 1e3:.2f} ms)")
    timings = {}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    bundle, rows, plen = requests(cfg)
    name_every_id(bundle, cfg.vocab_size, PROMPTS)
    _, timings["a"] = seconds(lambda: check_gqa_kernels(gen, plen))
    _, timings["b"] = seconds(check_moe_block)

    t0 = time.perf_counter()
    params = init_llark_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"  {param_bytes(params) / 1e9:.2f} GB of bf16 parameters on the card, init "
          f"{time.perf_counter() - t0:.2f} s")
    moe_one_request(cfg, bundle, rows, params)
    timings["c"] = time.perf_counter() - t0
    _, timings["d"] = seconds(lambda: moe_serving(cfg, bundle, params))
    t0 = time.perf_counter()
    params = quant.quantize_params_int8_incremental(cfg, params)
    torch.cuda.synchronize()
    print(f"  int8 tree quantized on the card in {time.perf_counter() - t0:.2f} s: "
          f"{param_bytes(params) / 1e9:.2f} GB")
    moe_one_request(cfg, bundle, rows, params, wq="int8")
    timings["c"] += time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    _, fp32_s = seconds(lambda: moe_fp32_streams(bundle))
    timings["d"] += fp32_s

    train_cfg = mixtral_cfg(num_layers=MOE_TRAIN_LAYERS)  # fp32 parameters, bf16 compute, remat
    _, timings["e"] = seconds(lambda: moe_training(os.path.join(directory, "train"), train_cfg))
    _, timings["f"] = seconds(lambda: moe_checkpoint(directory, cfg))
    print("  (a)-(f) seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in sorted(timings.items())))


# ---------------------------------------------------------------------------
# phase 23: native I/O, annotation and preprocessing
# ---------------------------------------------------------------------------

# the native read against the numpy routes, in the interior (the middle
# three quarters: the two resamplers treat the edges otherwise), as the JAX
# package states it; peak normalisation, x * (1 / peak) against x / peak
NATIVE_READ_TOL = 1e-4
PEAK_TOL = 1e-6
# BeatNet and KeyNet on the card against the same modules on the CPU,
# relative to max: both fp32 with TF32 off (cuDNN and cuBLAS against the
# CPU's kernels), so they differ by summation order alone. The phase also
# reads the card with TF32 products, which must land above it
ANNOTATOR_TOL = 1e-5
PREP_SECONDS = 30.0  # the pipeline's crop length
PREP_FAMILIES = synthbench.FAMILIES + synthbench.FAMILIES[:2]  # 8 clips, every family
PREP_ENCODING = (250, 4800)  # a 25 s crop's pooled Jukebox frames at 10 fps
# what phases 17, 20 and 21 read through the native library, for (d)
NATIVE_READS: dict = {}


def start_native_builds(pool, directory: str) -> list:
    """Both libraries compiled afresh into `directory`, each in its own
    thread of `pool` (the loaded ones stay as they are): futures of
    (source, seconds)."""
    src_dir = os.path.dirname(os.path.abspath(native_build.__file__))
    os.makedirs(directory, exist_ok=True)

    def build(src):
        t0 = time.perf_counter()
        native_build.compile_native(os.path.join(src_dir, src), os.path.join(directory, src + ".so"),
                                    native_build.EXTRA_FLAGS[src])
        return src, time.perf_counter() - t0

    return [pool.submit(build, src) for src in native_build.EXTRA_FLAGS]


def numpy_read(path: str, sr: int) -> np.ndarray:
    """read_wav through the numpy routes, called by name."""
    with open(path, "rb") as f:
        samples, src_sr = audio_io._parse_wav_numpy(f.read())
    if src_sr != sr:
        samples = audio_io._resample_numpy(samples, src_sr, sr)
    return samples.astype(np.float32)


def native_reads(directory: str, smi: str) -> None:
    """(a): phase 20's WAVs at 48 kHz and phase 21's at 44.1 kHz through
    read_wav (the native library) and through the numpy routes; samples
    within NATIVE_READ_TOL in the interior, peak_normalize within PEAK_TOL."""
    # the builds run while the WAVs are written, and end before the reads;
    # the libraries this process uses are loaded (built at first use) then
    # too, so no read below pays for a build
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        builds = start_native_builds(pool, os.path.join(directory, "build"))
        loads = [pool.submit(native_build.load, src) for src in native_build.EXTRA_FLAGS]
        sets = (("phase 20's", write_clap_wavs(os.path.join(directory, "clap")), CLAP_WAVS, 48000),
                ("phase 21's", write_jukebox_wavs(os.path.join(directory, "jukebox")),
                 JUKEBOX_WAVS, DEFAULT_SR))
        builds = dict(f.result() for f in builds)
        for f in loads:
            f.result()
    print(f"  (a) native build ({smi}): " + ", ".join(f"{k} {v:.2f} s" for k, v in builds.items())
          + f" (g++ {' '.join(native_build.CXX_FLAGS)}, in parallel)")
    for label, names, wavs, sr in sets:
        paths = [os.path.join(directory, "clap" if sr == 48000 else "jukebox", n) for n in names]
        audio_s = sum(s for s, _ in wavs)
        native_build.calls.clear()
        native, native_s = seconds(lambda: [read_wav(p, sr)[0] for p in paths])
        calls = dict(native_build.calls)
        plain, numpy_s = seconds(lambda: [numpy_read(p, sr) for p in paths])
        worst, worst_peak = 0.0, 0.0
        for got, want in zip(native, plain):
            check(got.shape == want.shape and got.dtype == np.float32,
                  f"{label} read: {got.shape} {got.dtype} against the numpy route's {want.shape}")
            n = len(got)
            worst = max(worst, float(np.abs(got[n // 8: n - n // 8] - want[n // 8: n - n // 8]).max()))
            keep = got.copy()
            normed = audio_io.peak_normalize(got)
            check(np.array_equal(got, keep), "peak_normalize changed its input")
            worst_peak = max(worst_peak, float(np.abs(normed - got / np.abs(got).max()).max()))
        print(f"  (a) {label} {len(paths)} WAVs ({audio_s} s of 44.1 kHz audio) to {sr} Hz on the "
              f"host ({smi}): native {native_s:.3f} s ({native_s / audio_s:.2e} s a second of "
              f"audio), numpy routes {numpy_s:.3f} s ({numpy_s / audio_s:.2e}), "
              f"{numpy_s / native_s:.1f}x; native calls {calls}; worst interior |d| {worst:.3e} "
              f"(gate {NATIVE_READ_TOL}); peak_normalize against x / max|x| {worst_peak:.3e} "
              f"(gate {PEAK_TOL})")
        check(calls.get("parse_wav") == len(paths) and calls.get("resample", 0) == (
            len(paths) if sr != DEFAULT_SR else 0), f"{label} read: native calls {calls}")
        check(worst <= NATIVE_READ_TOL, f"{label} read: native and numpy differ by {worst:.3e}")
        check(worst_peak <= PEAK_TOL, f"peak_normalize differs from x / max|x| by {worst_peak:.3e}")


def pipeline_cli(*args: str) -> tuple:
    """`python -m llark_tpu_torch.preprocessing.pipeline_cli` as a user runs
    it, from the repo root: (its last line of output, its wall seconds,
    Python's start-up and imports included)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "llark_tpu_torch.preprocessing.pipeline_cli",
                           *args], cwd=root, env=env, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"pipeline_cli {args[0]} exited {proc.returncode}:\n"
          f"{proc.stderr[-2000:]}")
    return proc.stdout.strip().splitlines()[-1], wall


def read_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def preprocessing_run(directory: str, smi: str) -> tuple:
    """(b): 8 seeded synthbench clips of 30 s (every family) as 44.1 kHz
    WAVs -> `pipeline_cli crop --multicrop`, `annotate` (the DSP chain, a
    worker a core), `crop-annotations` -> `pack_webdataset` -> the shards
    read back natively and in Python. Returns (the clips' truths, the
    annotate rows by clip)."""
    raw, crops = os.path.join(directory, "raw"), os.path.join(directory, "crops")
    os.makedirs(raw)
    truths, rows = [], []
    for i, family in enumerate(PREP_FAMILIES):
        audio, truth = synthbench.make_clip(SEED + 2300 + i, PREP_SECONDS, sr=DEFAULT_SR,
                                            family=family)
        write_wav(os.path.join(raw, f"clip{i}.wav"), audio, DEFAULT_SR)
        truths.append(truth)
        rows.append({"id": f"clip{i}", "family": family})
    with open(os.path.join(directory, "rows.jsonl"), "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    n = len(rows)
    ann, cropped = os.path.join(directory, "ann.jsonl"), os.path.join(directory, "cropped.jsonl")
    said, crop_s = pipeline_cli("crop", "--input-dir", raw, "--output-dir", crops, "--multicrop")
    want = [f"clip{i}-start0.000-end30.000.wav" for i in range(n)]
    check(sorted(os.listdir(crops)) == sorted(want), f"crop wrote {sorted(os.listdir(crops))}")
    said_ann, ann_s = pipeline_cli("annotate", "--input-jsonl", os.path.join(directory, "rows.jsonl"),
                                   "--audio-dir", raw, "--output", ann)
    annotated = sorted(read_jsonl(ann), key=lambda r: int(r["id"][4:]))
    check([r["id"] for r in annotated] == [r["id"] for r in rows], f"annotate: {said_ann}")
    fields = ("key", "tempo_in_beats_per_minute_madmom", "tempo_in_beats_per_minute_librosa",
              "downbeats_librosa", "downbeats_madmom", "chords")
    check(all(all(k in r for k in fields) for r in annotated), "annotate: a field is missing")
    said_crop, crop_ann_s = pipeline_cli("crop-annotations", "--annotations-file", ann,
                                         "--audio-dir", crops, "--output", cropped)
    crop_rows = read_jsonl(cropped)
    check(sorted(r["id"] for r in crop_rows) == sorted(w[:-4] for w in want)
          and all(r["end_secs"] == 25.0 for r in crop_rows), f"crop-annotations: {said_crop}")
    workers = os.cpu_count()
    print(f"  (b) pipeline_cli on the host ({smi}; {workers} workers, each CLI's wall with "
          f"Python's start-up): crop --multicrop {n} WAVs of {PREP_SECONDS:.0f} s in "
          f"{crop_s:.2f} s ({n / crop_s:.2f} rows/s); annotate (DSP chain) {ann_s:.2f} s "
          f"({n / ann_s:.2f} rows/s, {ann_s / (n * PREP_SECONDS):.2e} s a second of audio); "
          f"crop-annotations {crop_ann_s:.2f} s ({n / crop_ann_s:.2f} rows/s)")

    # pack_webdataset over the cropped rows, with an encoding and two
    # questions each, then the shards read back both ways
    rng = np.random.RandomState(SEED + 23)
    enc_dir = os.path.join(directory, "encs")
    os.makedirs(enc_dir)
    instruct = os.path.join(directory, "instruct.jsonl")
    with open(instruct, "w") as f:
        for r in crop_rows:
            np.save(os.path.join(enc_dir, r["id"] + ".npy"),
                    rng.randn(*PREP_ENCODING).astype(np.float32))
            r["response"] = [
                {"question": "What is the key of this piece?", "answer": r["key"]},
                {"question": "What is the tempo?",
                 "answer": f"{r['tempo_in_beats_per_minute_madmom']} BPM"}]
            f.write(json.dumps(r) + "\n")
    pattern = os.path.join(directory, "shards", "train-%05d.tar")
    _, pack_s = seconds(lambda: pack_webdataset.main(
        ["--instruct-jsonl", instruct, "--encodings-dir", enc_dir, "--output-pattern", pattern,
         "--max-count", "4"]))
    shards = sorted(os.path.join(os.path.dirname(pattern), p)
                    for p in os.listdir(os.path.dirname(pattern)))
    native_build.calls.clear()
    native, native_s = seconds(lambda: list(TarShardReader(shards)))
    tar_samples = native_build.calls["tar_samples"]
    plain, plain_s = seconds(lambda: list(TarShardReader(shards, use_native=False)))
    check(tar_samples == n and native_build.calls["tar_samples"] == n,
          f"the native tar loader read {tar_samples} samples, the Python reader's run "
          f"{native_build.calls['tar_samples'] - tar_samples}")
    check([s["__key__"] for s in native] == [s["__key__"] for s in plain]
          and len(native) == n, "the two readers gave other keys")
    for a, b in zip(native, plain):
        check(sorted(a) == sorted(b) and a["json"] == b["json"]
              and np.array_equal(a["audio_encoding.pyd"], b["audio_encoding.pyd"]),
              f"sample {a['__key__']} differs between the native and the Python reader")
    mb = sum(os.path.getsize(s) for s in shards) / 1e6
    print(f"  (b) pack_webdataset {n} rows ({PREP_ENCODING[0]} x {PREP_ENCODING[1]} fp32 "
          f"encodings) into {len(shards)} shards ({mb:.1f} MB) in {pack_s:.2f} s "
          f"({n / pack_s:.1f} rows/s); read back native {native_s:.3f} s ({n / native_s:.1f} "
          f"rows/s), Python tarfile {plain_s:.3f} s ({n / plain_s:.1f} rows/s); samples equal")
    return truths, annotated


@contextlib.contextmanager
def shared_features(clips: list, feats: list):
    """The neural annotators' host features computed once a clip and
    shared by the card's chain and the CPU's (the same numpy on the same
    audio), so the phase pays for them once."""
    by_id = {id(a): f for a, f in zip(clips, feats)}
    saved = neural.beat_features, neural.key_features

    def beat(audio, sr, *args, **kw):
        return by_id[id(audio)][0] if id(audio) in by_id else saved[0](audio, sr, *args, **kw)

    def key(audio, sr, *args, **kw):
        return by_id[id(audio)][1] if id(audio) in by_id else saved[1](audio, sr, *args, **kw)

    neural.beat_features, neural.key_features = beat, key
    try:
        yield
    finally:
        neural.beat_features, neural.key_features = saved


def neural_on_card(clips: list, smi: str) -> list:
    """(c): BeatNet and KeyNet on the card against the same modules on the
    CPU for each clip, with the TF32 control; the neural chain on the card
    and on the CPU, equal. Returns the card's elements."""
    sr = DEFAULT_SR
    with concurrent.futures.ThreadPoolExecutor(len(clips)) as pool:
        feats, feat_s = seconds(lambda: list(pool.map(
            lambda a: (neural.beat_features(a, sr), neural.key_features(a, sr)), clips)))
    card_nets, cpu_nets = neural.load_nets(device="cuda"), neural.load_nets(device="cpu")
    worst, ctl, chain_s = {}, {}, {}
    for f_beat, f_key in feats:
        for i, (name, x, run) in enumerate((("BeatNet", f_beat, neural.beat_activations),
                                            ("KeyNet", f_key, neural.key_logits))):
            card, cpu = card_nets[i], cpu_nets[i]
            want = torch.from_numpy(run(cpu, x))
            with tf32_products():
                got = torch.from_numpy(run(card, x))  # the net keeps TF32 off itself
                with torch.no_grad():
                    tf32 = card.compute(torch.from_numpy(x).cuda()).cpu()
            for d, err in ((worst, rel_err(got, want)[0]), (ctl, rel_err(tf32, want)[0])):
                d[name] = max(d.get(name, 0.0), err)
    print(f"  (c) BeatNet / KeyNet on the card ({smi}) against the CPU, fp32 with TF32 off, "
          f"{len(clips)} clips (features {feat_s:.2f} s on the host, a thread a clip): worst "
          f"rel-to-max {worst['BeatNet']:.3e} / {worst['KeyNet']:.3e} (gate {ANNOTATOR_TOL}); "
          f"control, TF32 products {ctl['BeatNet']:.3e} / {ctl['KeyNet']:.3e}")
    for name in worst:
        check(worst[name] <= ANNOTATOR_TOL, f"{name}: the card reads {worst[name]:.3e} from the "
              f"CPU, over {ANNOTATOR_TOL}")
        check(ctl[name] > ANNOTATOR_TOL, f"{name}: TF32 products read {ctl[name]:.3e}, within "
              f"{ANNOTATOR_TOL}: the gate cannot tell them from fp32")
    elems = {}
    with shared_features(clips, feats):
        for where, device in (("card", "cuda"), ("CPU", "cpu")):
            chain = neural.neural_annotators(device=device)[1:]  # chords: the DSP stage
            elems[where], chain_s[where] = seconds(lambda: [
                annotate_elem({"audio": a, "audio_sample_rate": sr}, annotators=chain)
                for a in clips])
    fields = ("key", "tempo_in_beats_per_minute_madmom", "tempo_in_beats_per_minute_librosa",
              "downbeats_librosa", "downbeats_madmom")
    differ = [(i, k) for i, (a, b) in enumerate(zip(elems["card"], elems["CPU"]))
              for k in fields if a[k] != b[k]]
    beats = sum(len(e["downbeats_librosa"]) for e in elems["card"])
    print(f"  (c) the neural chain (key, beats, downbeats, tempo) on the card {chain_s['card']:.2f} s, "
          f"on the CPU {chain_s['CPU']:.2f} s (features shared): {beats} beats; fields that differ "
          f"{differ or 'none'}")
    check(not differ, f"the neural chain differs between the card and the CPU in {differ}")
    return elems["card"]


def native_paths_report(smi: str) -> None:
    """(d): what phases 17, 20 and 21 read through the native library in
    this run, and the CLIs' host shares."""
    if not NATIVE_READS:
        print("  (d) phases 17, 20 and 21 did not run in this call")
        return
    for label, reading in NATIVE_READS.items():
        print(f"  (d) {label} ({smi}): {reading}")


def run_native_phase(directory: str, smi: str) -> None:
    """Phase 23: native I/O, annotation and preprocessing."""
    print(f"phase 23 on {smi}: the native audio and tar libraries (g++ on the host), the "
          f"preprocessing CLIs, the DSP and neural annotators ({len(PREP_FAMILIES)} synthbench "
          f"clips of {PREP_SECONDS:.0f} s)")
    timings = {}
    _, timings["a"] = seconds(lambda: native_reads(os.path.join(directory, "a"), smi))
    (truths, dsp_rows), timings["b"] = seconds(
        lambda: preprocessing_run(os.path.join(directory, "b"), smi))
    raw = os.path.join(directory, "b", "raw")
    clips = [read_wav(os.path.join(raw, f"clip{i}.wav"))[0] for i in range(len(truths))]
    card, timings["c"] = seconds(lambda: neural_on_card(clips, smi))
    # the neural chain's chord stage is the DSP one: the rows' chords
    for elem, row in zip(card, dsp_rows):
        elem["chords"] = row["chords"]
    label = f"{len(truths)} clips of {len(set(PREP_FAMILIES))} families"
    for name, elems in (("DSP chain (annotate's rows)", dsp_rows), ("neural chain, the card", card)):
        scores = synthbench.score_annotations(zip(elems, truths), PREP_SECONDS, family=label)
        print(f"  (c) synthbench scores, {name}: " + json.dumps(
            {k: (round(v, 4) if isinstance(v, float) else v) for k, v in scores.items()}))
    native_paths_report(smi)
    print("  (a)-(c) seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in timings.items()))


def checkpoint_io_alone(directory: str, smi: str) -> None:
    """Phase 17 without the phases before it: its training shard first."""
    shard = write_shards(directory, ModelConfig.llama2_7b())
    run_checkpoint_io(os.path.join(directory, "ckpt"), shard, smi)


# phases that `--phase N` runs alone: (label, fn(scratch directory, smi))
ALONE = {17: ("checkpoint I/O and the WebDataset CLI", checkpoint_io_alone),
         20: ("CLAP path", run_clap_path),
         21: ("Jukebox path", run_jukebox_path),
         22: ("Mixture-of-Experts at Mixtral-8x7B width", run_moe_path),
         23: ("native I/O, annotation and preprocessing", run_native_phase)}


def set_up_card() -> tuple:
    """Read the card's name and power limit, build every kernel, and keep
    fp32 products in full precision (no TF32 in cuBLAS or cuDNN). Returns
    (the nvidia-smi line, the device's name)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; nvidia-smi: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for src, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi, kind


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Drive the port on one NVIDIA GPU.")
    ap.add_argument("--phase", type=int, choices=sorted(ALONE), default=None,
                    help="run this phase alone, without the kernels line and the final line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi, kind = set_up_card()
    if args.phase is not None:
        label, fn = ALONE[args.phase]
        with tempfile.TemporaryDirectory() as tmp:
            _, phase_s = seconds(lambda: fn(tmp, smi))
        print(f"phase {args.phase} ({label}): {phase_s:.1f} s")
        print(smi)
        return 0

    print_wq_kernel_split()

    cfg = ModelConfig.llama2_7b(use_flash_decode=True, param_dtype="bfloat16")
    bundle, rows, plen = requests(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    fwd_err = check_flash_fwd(gen, plen)
    dec_err = check_flash_decode(gen, plen)
    launches, bf16_main = run_main_path(cfg, bundle, rows)
    k2_err = check_flash_decode_modes(gen)
    dec_err = max(dec_err, k2_err["flash_decode"])
    admitted = [len(r.input_ids) for r in serving_requests(cfg, bundle, 8, SEED)]
    fwd_err = max(fwd_err, check_flash_fwd_admission(gen, admitted))
    serving, bf16_serving = run_serving_engine(cfg, bundle)
    print(f"phases 1-7: {time.perf_counter() - t_start:.1f} s since the card was found")

    wq_err = check_wq_matmul(gen)
    wq_serving = {
        "int8": run_quantized_serving(cfg, bundle, rows, "int8", "ab", bf16_main, bf16_serving),
        "int4": run_quantized_serving(cfg, bundle, rows, "int4", "a", bf16_main, bf16_serving),
    }
    check_int4_cols(cfg)
    print(f"phases 1-7, 13-16: {time.perf_counter() - t_start:.1f} s since the card was found")

    bwd_err = check_flash_bwd(gen)
    check_fp32_kernels(gen)
    train_cfg = ModelConfig.llama2_7b()  # fp32 parameters, bf16 compute, remat
    with tempfile.TemporaryDirectory() as tmp:
        shard = write_shards(tmp, train_cfg)
        check_gradient_through_kernels(train_cfg, os.path.join(tmp, "grad"), shard)
        adapter = run_training(
            f"adapter stage, Llama-2-7B width, {ADAPTER_LAYERS} layers",
            dataclasses.replace(train_cfg, num_layers=ADAPTER_LAYERS), os.path.join(tmp, "adapter"),
            shard, 6, frozen_base=True, lr=1e-3, freeze_backbone=True, tune_mm_mlp_adapter=True)
        run_training(
            f"run-of-record flags, 7B width, {FULL_LAYERS} layers",
            dataclasses.replace(train_cfg, num_layers=FULL_LAYERS), os.path.join(tmp, "full"),
            shard, 6, frozen_base=False, lr=1e-4, tune_mm_mlp_adapter=True)
        print(f"and phases 8-11: {time.perf_counter() - t_start:.1f} s since the card was found")
        _, phase_s = seconds(lambda: run_checkpoint_io(os.path.join(tmp, "ckpt"), shard, smi))
        print(f"phase 17 (checkpoint I/O and the WebDataset CLI): {phase_s:.1f} s")
        _, phase_s = seconds(lambda: run_lora(os.path.join(tmp, "lora"), shard, smi))
        print(f"phase 18 (LoRA and QLoRA training, serving the run): {phase_s:.1f} s")
    _, phase_s = seconds(lambda: run_speculation(cfg, bundle, rows, bf16_serving, smi))
    print(f"phase 19 (speculative decoding, beam search, the HTTP engine): {phase_s:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        _, phase_s = seconds(lambda: run_clap_path(tmp, smi))
    print(f"phase 20 (CLAP path): {phase_s:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        _, phase_s = seconds(lambda: run_jukebox_path(tmp, smi))
    print(f"phase 21 (Jukebox path): {phase_s:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        _, phase_s = seconds(lambda: run_moe_path(tmp, smi))
    print(f"phase 22 (Mixture-of-Experts at Mixtral-8x7B width): {phase_s:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        _, phase_s = seconds(lambda: run_native_phase(tmp, smi))
    print(f"phase 23 (native I/O, annotation and preprocessing) on {smi}: {phase_s:.1f} s")
    launches["flash_bwd"] = adapter["flash_attention_bwd"]

    kernels = []
    for name, src, replaces, err, time_fn, length in (
        ("flash_fwd", "llark_tpu_torch/csrc/flash_fwd.cu",
         "llark_tpu/ops/attention.py:319", fwd_err, time_flash_fwd, plen),
        # the decode steps' live length runs from plen to plen + 31: the middle
        ("flash_decode", "llark_tpu_torch/csrc/flash_decode.cu",
         "llark_tpu/ops/decode_attention.py:495", dec_err, time_flash_decode, plen + 16),
    ):
        # batch 1 is what batch_infer gives the kernel: the JSON line reports
        # it; batch 4 is printed beside it
        for b in (4, 1):
            ms, plain_ms, lib_ms, (bound_ms, bound_by), shape = time_fn(gen, length, b)
            print(f"{name} at {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"SDPA {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
                  f"{bound_ms / ms:.1%} of bound")
        if name == "flash_decode":
            print(f"flash_decode host enqueue at {shape}: {k2_host_us(gen, length):.1f} us a call")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms,
        })
    # K1 at one-shot admission (serving modes (b), (d)), printed beside it
    ms, plain_ms, lib_ms, (bound_ms, bound_by), shape = time_flash_fwd_at(gen, 512, admitted)
    print(f"flash_fwd at one-shot admission {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"SDPA {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound")
    # K2 in dense bf16 at the phase-6 shape (printed), beside the other modes
    ms, plain_ms, sdpa_ms, (bound_ms, bound_by), shape = time_flash_decode_mode(gen, "bf16", 0)
    print(f"flash_decode at {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
          f"{sdpa_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound")
    # K2': each cache mode at the phase-6 shape, launches from the serving
    # mode that runs it
    for name, mode, bs, label, cache_mode in K2_ROWS:
        ms, plain_ms, sdpa_ms, (bound_ms, bound_by), shape = time_flash_decode_mode(gen, mode, bs)
        print(f"{name} at {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA over a "
              f"dense bf16 view {sdpa_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{bound_ms / ms:.1%} of bound")
        kernels.append({
            "name": name, "route": "cuda", "source": "llark_tpu_torch/csrc/flash_decode.cu",
            "replaces": "llark_tpu/ops/decode_attention.py:495",
            "launches": serving[label][cache_mode], "max_abs_err": k2_err[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
        })
    # the flash backward at the training path's shape; its launches are the
    # adapter stage's (ADAPTER_LAYERS x 2 micro-batches x 6 steps)
    ms, plain_ms, lib_ms, (bound_ms, bound_by), shape = time_flash_bwd(gen)
    print(f"flash_bwd at {shape}: delta + products + dq rounding {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"SDPA backward {lib_ms:.4f} ms (dq, dk and dv; same mask), bound {bound_ms:.4f} ms "
          f"({bound_by}), {bound_ms / ms:.1%} of bound")
    kernels.append({
        "name": "flash_bwd", "route": "cuda", "source": "llark_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "llark_tpu/ops/attention.py:536, llark_tpu/ops/attention.py:570",
        "launches": launches["flash_bwd"], "max_abs_err": bwd_err["flash_bwd"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": lib_ms,
    })
    print(f"flash_fwd log-sum-exp, worst |d| {bwd_err['flash_fwd_lse']:.3e}")
    # the quantized products at the serving engine's decode shape; their
    # launches are those of the run-of-record mode (a) served from each format
    wq_times, wq_kernel_ms = time_wq_matmul(gen)
    wq_library = time_wq_library(gen, wq_kernel_ms)
    for fmt, (ms, plain_ms, (bound_ms, bound_by)) in wq_times.items():
        kernels.append({
            "name": f"{fmt}_matmul", "route": "cuda",
            "source": f"llark_tpu_torch/csrc/{fmt}_matmul.cu",
            "replaces": f"llark_tpu/ops/{fmt}_matmul.py:{88 if fmt == 'int8' else 106}",
            "launches": wq_serving[fmt]["a"][f"{fmt}_matmul"],
            "max_abs_err": wq_err[f"{fmt}_matmul"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": wq_library[fmt],
        })

    print(f"chip_smoke.py: {time.perf_counter() - t_start:.1f} s after the card was found")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
