"""Batch embedding extraction: a directory of WAVs -> one .npy per file
(counterpart of llark_tpu/encoders/extract_cli.py).

  python -m llark_tpu_torch.encoders.extract_cli jukebox \
      --input-dir wavs/ --output-dir embeds/ \
      [--checkpoint bundle.npz | --checkpoint vqvae.pth.tar --prior-checkpoint prior.pth.tar] \
      [--batch-size 2] [--num-shards 8 --shard-index 0] [--skip-existing] [--device cpu]

  python -m llark_tpu_torch.encoders.extract_cli clap \
      --input-dir wavs/ --output-dir embeds/ [--checkpoint <HF CLAP dir>] \
      [--batch-size 16] [--num-shards 8 --shard-index 0] [--skip-existing] \
      [--device cpu]

Output: `{basename}.npy`: fp32 [T_pooled, 4800] for Jukebox (fps 10),
[1, 512] unit vectors for CLAP, the format LLark's encodings directories
hold. A fleet is N processes with --num-shards N --shard-index i. The
model runs on the GPU unless --device cpu is given. --data-parallel splits
each batch over the ranks of a launched world (torchrun; one process alone
is a world of one) and writes the same files as a run without it.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys
import time
from typing import Iterator, List, NamedTuple

import numpy as np

from llark_tpu_torch import storage

log = logging.getLogger("llark_tpu_torch.extract")


def list_shard(input_dir: str, num_shards: int, shard_index: int,
               skip_existing: bool, output_dir: str) -> List[str]:
    """This shard's WAV names (every num_shards-th of the sorted list),
    without those whose .npy exists when skip_existing."""
    files = [f for f in storage.listdir(input_dir) if f.lower().endswith(".wav")]
    files = files[shard_index::num_shards]
    if skip_existing:
        files = [
            f for f in files
            if not storage.exists(storage.join(output_dir, _npy_name(f)))
        ]
    return files


def _npy_name(wav_name: str) -> str:
    return os.path.splitext(wav_name)[0] + ".npy"


def _save_npy(path, arr):
    """np.save through the storage seam."""
    storage.makedirs_for(path)
    with storage.fopen(path, "wb") as f:
        np.save(f, arr)


def _batched(seq: List[str], n: int) -> Iterator[List[str]]:
    for i in range(0, len(seq), n):
        yield seq[i : i + n]


class ClapRun(NamedTuple):
    """What `run_clap` did: embeddings written, and seconds in all, on the
    host (read + resample + prepare) and in `embed_batch` (to the host)."""

    n: int
    seconds: float
    host_s: float
    embed_s: float


@contextlib.contextmanager
def _data_parallel(ns):
    """--data-parallel: a (world, 1, 1) mesh over the launched ranks
    (torchrun; one process alone is a world of one), whose ranks split each
    batch (llark_tpu/encoders/extract_cli.py:87-95, 216-221); None without
    the flag. Every rank reads and prepares every clip; rank 0 writes."""
    if not ns.data_parallel:
        yield None
        return
    from llark_tpu_torch.parallel.mesh import mesh_session

    with mesh_session((None, 1, 1), device=ns.device) as mesh:
        log.info("data-parallel encode over %d ranks", mesh.shape[0])
        yield mesh


def _writer(mesh) -> bool:
    import torch.distributed as dist

    return mesh is None or dist.get_rank() == 0


# ---------------------------------------------------------------------------
# Jukebox
# ---------------------------------------------------------------------------


class JukeboxRun(NamedTuple):
    """What `run_jukebox` did: encodings written, and seconds in all, on the
    host (read + prepare, overlapped with the device) and waiting on
    `encode_stream` for results beyond that."""

    n: int
    seconds: float
    host_s: float
    encode_s: float


def _load_state_dict(path: str) -> dict:
    import torch

    from llark_tpu_torch.encoders.jukebox.import_torch import strip_module

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd and not any("." in k for k in sd):
        sd = sd["model"]  # the official checkpoints wrap: {"model": state_dict}
    return strip_module(sd)


def build_jukebox_encoder(ns, mesh=None):
    """The encoder `run_jukebox` runs: an importer's .npz bundle, openai
    state dicts (--checkpoint + --prior-checkpoint), --tiny, or random
    full-width weights; the prior computes in bf16 on every route but
    --tiny, as the JAX package's CLI sets it."""
    from llark_tpu_torch.encoders.jukebox.config import JukeboxPriorConfig, JukeboxVQVAEConfig
    from llark_tpu_torch.encoders.jukebox.encode import JukeboxEncoder, reference_conds

    kw = dict(pool_frames_per_second=ns.fps, transfer_dtype=ns.transfer_dtype,
              output_dtype=ns.output_dtype, device=ns.device, mesh=mesh)
    if ns.checkpoint and ns.checkpoint.endswith(".npz"):
        # an importer's bundle (weights + conditioner tables)
        enc = JukeboxEncoder.from_npz(ns.checkpoint, **kw)
        enc.prior_cfg.dtype = "bfloat16"
        return enc
    if ns.checkpoint:
        from llark_tpu_torch.encoders.jukebox.conditioner import convert_conditioner
        from llark_tpu_torch.encoders.jukebox.import_torch import (
            convert_prior,
            convert_vqvae,
            infer_prior_config,
        )

        vq_sd = _load_state_dict(ns.checkpoint)
        pr_sd = _load_state_dict(ns.prior_checkpoint)
        vq_cfg = JukeboxVQVAEConfig()
        pr_cfg = infer_prior_config(pr_sd, depth=ns.prior_depth)
        pr_cfg.dtype = "bfloat16"
        # x_cond / y_cond from the checkpoint's label conditioner; zeros only
        # where the tables are absent (truncated test fixtures)
        try:
            cond_params = convert_conditioner(pr_sd)
        except KeyError:
            log.warning("prior checkpoint has no y_emb.* conditioner tables; "
                        "using zero x_cond/y_cond")
        else:
            kw["x_cond"], kw["y_cond"] = reference_conds(vq_cfg, pr_cfg, cond_params)
        return JukeboxEncoder(vq_cfg, pr_cfg, convert_vqvae(vq_sd, vq_cfg),
                              convert_prior(pr_sd, pr_cfg), **kw)
    log.warning("no --checkpoint given: RANDOM weights (throughput/dev only)")
    if ns.tiny:
        return JukeboxEncoder.random_init(JukeboxVQVAEConfig.tiny(), JukeboxPriorConfig.tiny(),
                                          **kw)
    return JukeboxEncoder.random_init(JukeboxVQVAEConfig(dtype="bfloat16"),
                                      JukeboxPriorConfig(dtype="bfloat16"), **kw)


def run_jukebox(ns) -> JukeboxRun:
    with _data_parallel(ns) as mesh:
        return _run_jukebox(ns, build_jukebox_encoder(ns, mesh), _writer(mesh))


def _run_jukebox(ns, enc, write: bool) -> JukeboxRun:
    from llark_tpu_torch.audio.io import read_wav
    from llark_tpu_torch.encoders.jukebox.encode import (
        JUKEBOX_SAMPLE_RATE,
        pad_or_crop,
        prepare_audio,
    )

    os.makedirs(ns.output_dir, exist_ok=True)
    files = list_shard(ns.input_dir, ns.num_shards, ns.shard_index,
                       ns.skip_existing, ns.output_dir)
    log.info("shard %d/%d: %d files", ns.shard_index, ns.num_shards, len(files))
    host_s = 0.0

    def batches():
        nonlocal host_s
        for group in _batched(files, ns.batch_size):
            t1 = time.perf_counter()
            audio = np.zeros((ns.batch_size, enc.samples_per_ctx), np.float32)
            lengths = np.zeros((ns.batch_size,), np.int64)
            for i, name in enumerate(group):
                samples, _ = read_wav(storage.join(ns.input_dir, name), JUKEBOX_SAMPLE_RATE)
                prepared = prepare_audio(samples)
                lengths[i] = min(len(prepared), enc.samples_per_ctx)
                audio[i] = pad_or_crop(prepared, enc.samples_per_ctx)
            host_s += time.perf_counter() - t1
            yield audio, lengths

    t0 = time.perf_counter()
    n_done = 0
    encode_s = 0.0
    stream = enc.encode_stream(batches())
    for group in _batched(files, ns.batch_size):
        t1, host_before = time.perf_counter(), host_s
        acts, counts = next(stream)  # asks batches() for the next group first
        encode_s += time.perf_counter() - t1 - (host_s - host_before)
        for i, name in enumerate(group):
            if write:
                _save_npy(storage.join(ns.output_dir, _npy_name(name)),
                          acts[i, : counts[i]].astype(np.float32))
            n_done += 1
    run = JukeboxRun(n_done, time.perf_counter() - t0, host_s, encode_s)
    log.info("wrote %d embeddings in %.3f s (%.3f clips/s): read + prepare %.3f s, "
             "waiting on the device %.3f s", run.n, run.seconds,
             run.n / max(run.seconds, 1e-9), run.host_s, run.encode_s)
    return run


# ---------------------------------------------------------------------------
# CLAP
# ---------------------------------------------------------------------------


def run_clap(ns) -> ClapRun:
    from llark_tpu_torch.encoders.clap.encode import ClapEncoder
    from llark_tpu_torch.encoders.clap.htsat import HTSATConfig

    with _data_parallel(ns) as mesh:
        if ns.checkpoint:
            from llark_tpu_torch.encoders.clap.import_hf import load_clap_encoder

            cfg, params = load_clap_encoder(ns.checkpoint, ns.device)
            enc = ClapEncoder(cfg, params, ns.device, mesh)
        elif ns.tiny:
            enc = ClapEncoder.random_init(HTSATConfig.tiny(), device=ns.device, mesh=mesh)
        else:
            log.warning("no --checkpoint given: RANDOM weights (throughput/dev only)")
            enc = ClapEncoder.random_init(device=ns.device, mesh=mesh)
        return _run_clap(ns, enc, _writer(mesh))


def _run_clap(ns, enc, write: bool) -> ClapRun:
    from llark_tpu_torch.audio.io import read_wav
    from llark_tpu_torch.encoders.clap.encode import CLAP_SAMPLE_RATE, prepare_clip, quantize_roundtrip

    os.makedirs(ns.output_dir, exist_ok=True)
    files = list_shard(ns.input_dir, ns.num_shards, ns.shard_index,
                       ns.skip_existing, ns.output_dir)
    log.info("shard %d/%d: %d files", ns.shard_index, ns.num_shards, len(files))
    t0 = time.perf_counter()
    n_done = 0
    host_s = embed_s = 0.0
    # one RandomState across the run, as the JAX package draws rand_trunc's
    # windows: the same files in the same order crop alike
    trunc_rng = np.random.RandomState(0)
    for group in _batched(files, ns.batch_size):
        t1 = time.perf_counter()
        clips = []
        for name in group:
            samples, _ = read_wav(storage.join(ns.input_dir, name), CLAP_SAMPLE_RATE)
            clips.append(prepare_clip(quantize_roundtrip(samples), rng=trunc_rng))
        t2 = time.perf_counter()
        emb = enc.embed_batch(np.stack(clips))  # returns on the host: the device is done
        host_s += t2 - t1
        embed_s += time.perf_counter() - t2
        for i, name in enumerate(group):
            if write:
                _save_npy(storage.join(ns.output_dir, _npy_name(name)),
                          emb[i : i + 1].astype(np.float32))
            n_done += 1
    run = ClapRun(n_done, time.perf_counter() - t0, host_s, embed_s)
    log.info("wrote %d embeddings in %.3f s (%.3f clips/s): read + resample + prepare "
             "%.3f s, embed %.3f s", run.n, run.seconds, run.n / max(run.seconds, 1e-9),
             run.host_s, run.embed_s)
    return run


def build_parser() -> argparse.ArgumentParser:
    """The CLI's parser; `parse_args(argv)` gives a namespace whose `fn(ns)`
    runs the subcommand (`run_jukebox` returns its `JukeboxRun`, `run_clap`
    its `ClapRun`)."""
    p = argparse.ArgumentParser("llark_tpu_torch.encoders.extract_cli")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in (("jukebox", run_jukebox), ("clap", run_clap)):
        c = sub.add_parser(name)
        c.add_argument("--input-dir", required=True)
        c.add_argument("--output-dir", required=True)
        c.add_argument("--checkpoint", default=None)
        c.add_argument("--batch-size", type=int, default=2 if name == "jukebox" else 16)
        c.add_argument("--num-shards", type=int, default=1)
        c.add_argument("--shard-index", type=int, default=0)
        c.add_argument("--skip-existing", action="store_true")
        c.add_argument("--tiny", action="store_true", help="tiny configs (tests)")
        c.add_argument("--data-parallel", action="store_true",
                       help="split each clip batch over the ranks of the launched world "
                            "(torchrun; one process alone is a world of one)")
        c.add_argument("--device", default="cuda",
                       help="device to run on (default: the GPU; 'cpu' runs the plain "
                            "PyTorch path)")
        if name == "jukebox":
            c.add_argument("--prior-checkpoint", default=None)
            c.add_argument("--prior-depth", type=int, default=36)
            c.add_argument("--fps", type=float, default=10.0)
            c.add_argument("--transfer-dtype", default="int16")
            c.add_argument("--output-dtype", default="bfloat16")
        c.set_defaults(fn=fn)
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ns = build_parser().parse_args(argv)
    ns.fn(ns)
    return 0


if __name__ == "__main__":
    sys.exit(main())
