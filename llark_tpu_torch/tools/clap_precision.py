"""Read how far the CLAP encoder on one CUDA card lands from the CPU plain
path, with fp32 products and with TF32 products, at the comparisons the
card tests make (`tests/test_torch_cuda.py` CLAP_TOL, HTSAT_TOL).

    python -m llark_tpu_torch.tools.clap_precision

HTSAT-base on 2 seeded mel clips (relative to max), then `read_wav` ->
`embed_clip` on a 12 s stereo 44.1 kHz clip (absolute, unit vectors). A
limit between the two readings tells fp32 from TF32.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from llark_tpu_torch.audio.io import read_wav, write_wav
from llark_tpu_torch.encoders.clap.encode import CLAP_SAMPLE_RATE, ClapEncoder
from llark_tpu_torch.encoders.clap.htsat import HTSATConfig, htsat_embed, init_htsat_params


@contextlib.contextmanager
def products(tf32: bool):
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), torch.__version__)
    cfg = HTSATConfig.base()
    mel = torch.from_numpy(
        (10 * np.random.RandomState(9).randn(2, cfg.n_frames, cfg.n_mels) - 40).astype(np.float32))
    want = htsat_embed(cfg, init_htsat_params(cfg, 0, "cpu"), mel)
    params = init_htsat_params(cfg, 0, "cuda")
    for tf32 in (False, True):
        with products(tf32):
            got = htsat_embed(cfg, params, mel.cuda()).cpu()
        rel = float((got - want).abs().max() / want.abs().max())
        print(f"htsat_embed, HTSAT-base, 2 clips, tf32={tf32}: {rel:.3e} relative to max")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "clip.wav")
        write_wav(path, 0.3 * np.random.RandomState(10).randn(12 * 44100, 2), 44100)
        samples, _ = read_wav(path, CLAP_SAMPLE_RATE)
    want = ClapEncoder.random_init(seed=1, device="cpu").embed_clip(samples,
                                                                     np.random.RandomState(0))
    enc = ClapEncoder.random_init(seed=1, device="cuda")
    for tf32 in (False, True):
        with products(tf32):
            got = enc.embed_clip(samples, np.random.RandomState(0))
        print(f"read_wav -> embed_clip, tf32={tf32}: max|d| {float(np.abs(got - want).max()):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
