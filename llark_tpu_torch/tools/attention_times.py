"""Time the attention kernels of a checkout of this repository on one CUDA
card, at chip_smoke.py's shapes, bf16.

    python llark_tpu_torch/tools/attention_times.py [--repo PATH]

Run as a script (not with -m, which would import this checkout's package
first), it imports `chip_smoke` and `llark_tpu_torch` from PATH (default:
this checkout), builds that checkout's kernels, and prints one line `TIMES
{json}` of medians from its `chip_smoke.median_ms` (L2 flushed before each
launch, the host enqueue hidden): K1 at the serving prefill [1,32,384,128]
(297 live keys) and with its log-sum-exp at the training shape
[2,32,1024,128] (kv_len [1024, 700]), the flash backward (K3+K4) there, and
K2 at q [1,32,1,128] over a 2048-position bf16 cache (313 live), and K2's
host enqueue time there in us (the least of five `chip_smoke.host_us`). To compare
two checkouts, run it in turns, one process each (A, B, B, A), on one
card: e.g. the parent unpacked by `git archive` into a
git-ignored directory, beside this one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), help="root of the checkout to time")
    root = os.path.abspath(ap.parse_args().repo)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from llark_tpu_torch.ops import _build
    from llark_tpu_torch.ops import attention as attn_ops
    from llark_tpu_torch.ops import decode_attention as dec_ops

    if not os.path.abspath(attn_ops.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {attn_ops.__file__}, not the checkout at {root}")
    _build.build_all()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(smoke.SEED)
    times = {}
    q, k, v = (smoke.bf16_randn(gen, 1, 32, 384, 128) for _ in range(3))
    kv = torch.tensor([297], dtype=torch.int32, device="cuda")
    times["K1 [1,32,384,128] kv 297"] = smoke.median_ms(
        lambda: attn_ops.flash_attention_fwd(q, k, v, causal=True, kv_lengths=kv))
    q, k, v, do = (smoke.bf16_randn(gen, 2, 32, 1024, 128) for _ in range(4))
    kw = dict(causal=True, kv_lengths=torch.tensor([1024, 700], dtype=torch.int32, device="cuda"))
    times["K1+LSE [2,32,1024,128] kv [1024,700]"] = smoke.median_ms(
        lambda: attn_ops.flash_attention_fwd(q, k, v, return_lse=True, **kw))
    out, lse = attn_ops.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    times["K3+K4 [2,32,1024,128] kv [1024,700]"] = smoke.median_ms(
        lambda: attn_ops.flash_attention_bwd(q, k, v, out, lse, do, **kw))
    q = smoke.bf16_randn(gen, 1, 32, 1, 128)
    kc, vc = (smoke.bf16_randn(gen, 1, 32, 2048, 128) for _ in range(2))
    kvl = torch.tensor([313], dtype=torch.int32, device="cuda")
    times["K2 [1,32,1,128] cache 2048 kv 313"] = smoke.median_ms(
        lambda: dec_ops.flash_decode_attention(q, kc, vc, kv_lengths=kvl))
    # the host's speed varies with its other load: the least of five runs
    times["K2 host enqueue us"] = min(smoke.host_us(
        lambda: dec_ops.flash_decode_attention(q, kc, vc, kv_lengths=kvl)) for _ in range(5))
    print("TIMES", json.dumps(times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
