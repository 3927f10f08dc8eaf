"""Batch embedding extraction: a directory of WAVs -> one .npy per file
(counterpart of llark_tpu/encoders/extract_cli.py).

  python -m llark_tpu_torch.encoders.extract_cli clap \
      --input-dir wavs/ --output-dir embeds/ [--checkpoint <HF CLAP dir>] \
      [--batch-size 16] [--num-shards 8 --shard-index 0] [--skip-existing] \
      [--device cpu]

Output: `{basename}.npy`, fp32 [1, 512] unit vectors for CLAP, the
format LLark's encodings directories hold. A fleet is N processes with
--num-shards N --shard-index i. The model runs on the GPU unless
--device cpu is given. The `jukebox` subcommand takes the JAX package's
flags and raises: the Jukebox encoder is Queue A item 5 of the port, and
--data-parallel (a device mesh) is item 9.
"""

from __future__ import annotations

import argparse
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


def _refuse_data_parallel(ns) -> None:
    if ns.data_parallel:
        raise NotImplementedError(
            "--data-parallel (a device mesh) is Queue A item 9 (parallelism) of the port; "
            "run one process per card with --num-shards / --shard-index")


def run_jukebox(ns) -> int:
    _refuse_data_parallel(ns)
    raise NotImplementedError(
        "the Jukebox encoder is Queue A item 5 of the port; the JAX package's "
        "`python -m llark_tpu.encoders.extract_cli jukebox` extracts these encodings")


def run_clap(ns) -> ClapRun:
    from llark_tpu_torch.audio.io import read_wav
    from llark_tpu_torch.encoders.clap.encode import (
        CLAP_SAMPLE_RATE,
        ClapEncoder,
        prepare_clip,
        quantize_roundtrip,
    )
    from llark_tpu_torch.encoders.clap.htsat import HTSATConfig

    _refuse_data_parallel(ns)
    if ns.checkpoint:
        from llark_tpu_torch.encoders.clap.import_hf import load_clap_encoder

        cfg, params = load_clap_encoder(ns.checkpoint, ns.device)
        enc = ClapEncoder(cfg, params, ns.device)
    elif ns.tiny:
        enc = ClapEncoder.random_init(HTSATConfig.tiny(), device=ns.device)
    else:
        log.warning("no --checkpoint given: RANDOM weights (throughput/dev only)")
        enc = ClapEncoder.random_init(device=ns.device)
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
    runs the subcommand (`run_clap` returns its `ClapRun`)."""
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
                       help="shard the clip batch over all local devices")
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
