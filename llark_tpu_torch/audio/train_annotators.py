"""Train the neural annotators (BeatNet TCN + KeyNet chroma CNN) on the
seeded synthetic corpus and save their weights; counterpart of the JAX
package's scripts/train_annotators.py.

madmom-architecture parity step (reference m2t/annotation.py:29-111 uses
madmom's TRAINED RNN/CNN models): small networks trained on synthesis,
decoded by the same dynamic programs the DSP annotators use. Training
seeds (>= 1e6) are disjoint from the synthbench evaluation seeds
(family_seed * 10_000 + i with small seeds).

The networks are `audio.neural`'s `BeatNet` / `KeyNet` modules, trained on
the card unless the caller asks for the CPU, in fp32 with TF32 off
(`device.full_fp32`), under `torch.optim.Adam` (beta 0.9 / 0.999, eps
1e-8, as `optax.adam`). The batches are drawn from one
`np.random.RandomState` in the JAX trainer's order and the losses are its
own, so from the same initial weights both trainers take the same steps.
Without initial weights the nets draw theirs from a `torch.Generator`
seeded 0 (beat) / 1 (key), where the JAX trainer uses PRNGKey(0) / (1).

    python -m llark_tpu_torch.audio.train_annotators [--steps-beat 3000] \\
        [--steps-key 2500] [--out weights.npz] [--device cpu]

Writes an npz in the JAX package's keys and layout ([k, c_in, c_out]
convolutions, [in, out] dense weights, fp32), by default the port's
`neural.WEIGHTS_PATH`, and prints held-out validation scores per family.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from llark_tpu_torch.audio import neural
from llark_tpu_torch.audio.synthbench import FAMILIES, SR, make_clip, run_benchmark
from llark_tpu_torch.device import full_fp32, resolve_device

TRAIN_SEED_BASE = 1_000_000  # synthbench eval seeds are seed*10_000 + i
BEAT_POS_WEIGHT = (8.0, 16.0)  # positives are ~3% (beat) / ~1% (downbeat) of frames
CLIP_THREADS = 8  # clips made at once (synthesis and features are numpy)

Tree = Dict[str, np.ndarray]


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


def smear_targets(times, n_frames, fps):
    """Frame targets: 1 at event frames, 0.5 at +-1 frame."""
    t = np.zeros(n_frames, np.float32)
    for s in times:
        f = int(round(s * fps))
        if 0 <= f < n_frames:
            t[f] = 1.0
            for df in (-1, 1):
                g = f + df
                if 0 <= g < n_frames:
                    t[g] = max(t[g], 0.5)
    return t


def _clip_seeds(n_per_family: int, seed_base: int, families, skip=()) -> List[Tuple[int, str]]:
    """(seed, family) of each clip, in the JAX trainer's order."""
    return [(seed_base + fi * 1000 + i, fam)
            for fi, fam in enumerate(FAMILIES)
            if fam not in skip and (families is None or fam in families)
            for i in range(n_per_family)]


def _examples(n_per_family, seed_base, seconds, families, n_frames,
              beat: bool = True, key: bool = True) -> list:
    """Each clip made once, on CLIP_THREADS threads, in the JAX trainer's
    order: (its beat example or None, its key example or None). The key
    dataset draws the beat dataset's seeds and leaves percussion out (no
    tonal content)."""

    def one(item):
        seed, fam = item
        audio, truth = make_clip(seed, seconds, family=fam)
        b = k = None
        if beat:
            f = neural.beat_features(audio, SR)
            b = f, np.stack([smear_targets(truth["beats"], len(f), neural.BEAT_FPS),
                             smear_targets(truth["downbeats"], len(f), neural.BEAT_FPS)], axis=1)
        if key and fam != "perc":
            c = neural.key_features(audio, SR)
            if len(c) < n_frames:
                c = np.pad(c, ((0, n_frames - len(c)), (0, 0)))
            k = c[:n_frames], neural.key_index(truth["key"])
        return b, k

    items = _clip_seeds(n_per_family, seed_base, families, skip=() if beat else ("perc",))
    with concurrent.futures.ThreadPoolExecutor(CLIP_THREADS) as pool:
        return list(pool.map(one, items))


def _beat_set(examples) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    return [f for (f, _), _ in examples], [t for (_, t), _ in examples]


def _key_set(examples) -> Tuple[np.ndarray, np.ndarray]:
    ks = [k for _, k in examples if k is not None]
    return np.stack([c for c, _ in ks]), np.array([y for _, y in ks], np.int32)


def build_beat_dataset(n_per_family, seed_base, seconds=12.0, families=None):
    """Beat features [T, n_mels] and smeared (beat, downbeat) targets [T, 2]
    a clip."""
    return _beat_set(_examples(n_per_family, seed_base, seconds, families, 0, key=False))


def build_key_dataset(n_per_family, seed_base, seconds=12.0, n_frames=120, families=None):
    """Key features [n_frames, 12] (padded or cut) and key indices; the
    percussion family has no tonal content and is left out."""
    return _key_set(_examples(n_per_family, seed_base, seconds, families, n_frames, beat=False))


def build_datasets(n_per_family, seed_base, seconds=12.0, n_frames=120, families=None):
    """(build_beat_dataset's, build_key_dataset's) from one pass: each clip
    is made once and serves both."""
    examples = _examples(n_per_family, seed_base, seconds, families, n_frames)
    return _beat_set(examples), _key_set(examples)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def init_tree(shapes: Dict[str, Tuple[int, ...]], generator: torch.Generator) -> Tree:
    """He-normal weights (fan-in of the JAX layout: k * c_in, or in) and zero
    biases, drawn in `shapes`' order from `generator`."""
    tree: Tree = {}
    for name, shape in shapes.items():
        if name.endswith("_b"):
            tree[name] = np.zeros(shape, np.float32)
        else:
            fan_in = int(np.prod(shape[:-1]))
            w = torch.randn(shape, generator=generator, dtype=torch.float32)
            tree[name] = (w * (2.0 / fan_in) ** 0.5).numpy()
    return tree


def params_from_nets(beat: Optional[neural.BeatNet] = None,
                     key: Optional[neural.KeyNet] = None) -> Tree:
    """The inverse of `neural.nets_from_params`: the nets' weights as the
    JAX package's numpy tree, fp32 on the host ("beat/conv0_w" [k, c_in,
    c_out], "key/fc0_w" [in, out], ...), beat first, in the shapes' order."""
    tree: Tree = {}
    for prefix, net, shapes in (("beat", beat, neural.beat_param_shapes()),
                                ("key", key, neural.key_param_shapes())):
        if net is None:
            continue
        state = net.state_dict()
        for name in shapes:
            layer, kind = name.split("/")[1].rsplit("_", 1)
            module = f"convs.{layer[len('conv'):]}" if layer.startswith("conv") else layer
            t = state[f"{module}.{'weight' if kind == 'w' else 'bias'}"].detach()
            arr = t.to("cpu", torch.float32).numpy()
            if kind == "w":  # [c_out, c_in, k] -> [k, c_in, c_out]; [out, in] -> [in, out]
                arr = arr.transpose(2, 1, 0) if arr.ndim == 3 else arr.T
            tree[name] = np.ascontiguousarray(arr)
    return tree


def trainable_net(prefix: str, init: Optional[Tree] = None, device="cuda") -> torch.nn.Module:
    """BeatNet ("beat") or KeyNet ("key") in training mode on `device`, from
    the "<prefix>/*" leaves of the numpy tree `init`, else from a
    torch.Generator seeded 0 (beat) / 1 (key)."""
    shapes = neural.beat_param_shapes() if prefix == "beat" else neural.key_param_shapes()
    if init is None:
        init = init_tree(shapes, torch.Generator().manual_seed(0 if prefix == "beat" else 1))
    tree = {k: v for k, v in init.items() if k.startswith(prefix + "/")}
    if set(tree) != set(shapes):
        raise ValueError(f"initial {prefix} weights hold {sorted(tree)}, expected {sorted(shapes)}")
    from llark_tpu_torch.interop.from_jax import annotator_params_from_numpy

    net = neural.BeatNet() if prefix == "beat" else neural.KeyNet()
    net.load_state_dict(annotator_params_from_numpy(tree, "cpu")[prefix])
    return net.to(resolve_device(device)).train()


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

Batches = Callable[[], Tuple[np.ndarray, np.ndarray]]


def beat_batches(feats, targs, batch: int, crop: int, rng) -> Batches:
    """Draws a batch a call from `rng`: `batch` random crops of `crop`
    frames (zero-padded where a clip is shorter), features and targets."""
    n = len(feats)

    def draw():
        xb = np.zeros((batch, crop, neural.BEAT_N_MELS), np.float32)
        tb = np.zeros((batch, crop, 2), np.float32)
        for b in range(batch):
            ci = rng.randint(n)
            f, t = feats[ci], targs[ci]
            if len(f) > crop:
                o = rng.randint(len(f) - crop)
                xb[b], tb[b] = f[o:o + crop], t[o:o + crop]
            else:
                xb[b, :len(f)], tb[b, :len(f)] = f, t
        return xb, tb

    return draw


def key_batches(xs, ys, batch: int, rng) -> Batches:
    """Draws a batch a call from `rng`: `batch` clips, each rolled by a
    random number of semitones with its label transposed to match."""
    n = len(xs)

    def draw():
        idx = rng.randint(n, size=batch)
        rolls = rng.randint(12, size=batch)
        xb = np.stack([np.roll(xs[i], r, axis=1) for i, r in zip(idx, rolls)])
        # chroma rolled UP by r semitones transposes the tonic up by r
        yb = ((ys[idx] // 2 + rolls) % 12) * 2 + ys[idx] % 2
        return xb, yb.astype(np.int64)

    return draw


def beat_loss(net: neural.BeatNet, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Weighted BCE over every frame: positives weighted BEAT_POS_WEIGHT."""
    w = torch.where(t > 0, torch.tensor(BEAT_POS_WEIGHT, device=t.device), 1.0)
    bce = F.binary_cross_entropy_with_logits(net.logits(x), t, reduction="none")
    return (w * bce).mean()


def key_loss(net: neural.KeyNet, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy with integer labels, the batch mean."""
    return F.cross_entropy(net.logits(x), y)


@dataclasses.dataclass
class TrainRun:
    """A trained net with its run's record."""

    net: torch.nn.Module
    params: Tree  # its weights in the JAX package's keys and layout
    losses: List[float]  # a step each
    seconds: float  # the loop's wall time
    batch_seconds: float  # of it, building batches on the host


def _train(net, loss_fn, batches, steps: int, lr: float, label: str,
           log_every: int = 200) -> TrainRun:
    """Adam steps over host batches; losses read back at each log line and
    at the end (one sync each, not one a step)."""
    dev = next(net.parameters()).device
    opt = torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    pending: List[torch.Tensor] = []
    losses: List[float] = []
    batch_s = 0.0
    t0 = time.perf_counter()
    with full_fp32():
        for it in range(steps):
            tb = time.perf_counter()
            xb, yb = batches()
            batch_s += time.perf_counter() - tb
            xb, yb = torch.from_numpy(xb).to(dev), torch.from_numpy(yb).to(dev)
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(net, xb, yb)
            loss.backward()
            opt.step()
            pending.append(loss.detach())
            if (it + 1) % log_every == 0 or it + 1 == steps:
                losses += torch.stack(pending).tolist()
                pending = []
                if (it + 1) % log_every == 0:
                    print(f"  {label} step {it + 1}/{steps} loss "
                          f"{np.mean(losses[-log_every:]):.4f}", flush=True)
    seconds = time.perf_counter() - t0
    print(f"  {label}: {steps} steps in {seconds:.2f} s ({steps / seconds:.1f} steps/s), "
          f"building batches on the host {batch_s / seconds:.1%} of it", flush=True)
    net.eval()
    prefix = "beat" if isinstance(net, neural.BeatNet) else "key"
    params = params_from_nets(**{prefix: net})
    return TrainRun(net, params, losses, seconds, batch_s)


def train_beat(feats, targs, steps, batch, crop, lr, rng, init: Optional[Tree] = None,
               device="cuda") -> TrainRun:
    """BeatNet from `init` (the "beat/*" leaves of a numpy tree; else drawn
    from a torch.Generator seeded 0), `steps` Adam steps on random crops of
    `crop` frames, `batch` a step, drawn from `rng`."""
    net = trainable_net("beat", init, device)
    return _train(net, beat_loss, beat_batches(feats, targs, batch, crop, rng), steps, lr, "beat")


def train_key(xs, ys, steps, batch, lr, rng, init: Optional[Tree] = None,
              device="cuda") -> TrainRun:
    """KeyNet from `init` (the "key/*" leaves; else a torch.Generator seeded
    1), `steps` Adam steps on `batch` rolled clips a step, drawn from `rng`."""
    net = trainable_net("key", init, device)
    return _train(net, key_loss, key_batches(xs, ys, batch, rng), steps, lr, "key")


def save_params(path: str, params: Tree) -> None:
    """The npz `neural.load_params` of either package reads."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **{k: np.asarray(v, np.float32) for k, v in params.items()})


def _clear_weight_caches() -> None:
    neural._PARAMS_CACHE.clear()
    neural._NETS_CACHE.clear()


LOFO_OUT = os.path.join(os.path.dirname(__file__), "results_lofo_annotators.json")


def run_lofo(ns):
    """Leave-one-family-out: for each family F, train on FAMILIES - {F}
    and score on F (disjoint eval seeds). Compares against the committed
    all-family model and the DSP baseline on the same clips."""
    score_keys = ("beat_f", "downbeat_f", "tempo_acc2", "key_mirex")
    results = []
    for excl in FAMILIES:
        rng = np.random.RandomState(0)
        train_fams = [f for f in FAMILIES if f != excl]
        print(f"\n=== LOFO: excluding '{excl}' (train on {train_fams}) ===",
              flush=True)
        (feats, targs), (xs, ys) = build_datasets(ns.clips_per_family, TRAIN_SEED_BASE,
                                                  families=train_fams)
        beat = train_beat(feats, targs, ns.steps_beat, ns.batch, ns.crop, ns.lr, rng,
                          device=ns.device)
        key = train_key(xs, ys, ns.steps_key, 64, ns.lr, rng, device=ns.device)
        with tempfile.NamedTemporaryFile(suffix=".npz", delete=False) as tf:
            lofo_path = tf.name
        save_params(lofo_path, {**beat.params, **key.params})
        _clear_weight_caches()
        lofo_scores = run_benchmark(
            ns.eval_n, 12.0, seed=777, family=excl,
            annotators=neural.neural_annotators(weights=lofo_path, device=ns.device),
        )
        all_scores = (
            run_benchmark(ns.eval_n, 12.0, seed=777, family=excl,
                          annotators=neural.neural_annotators(device=ns.device))
            if os.path.exists(neural.WEIGHTS_PATH) else {}
        )
        dsp_scores = run_benchmark(ns.eval_n, 12.0, seed=777, family=excl)
        os.unlink(lofo_path)
        row = {"excluded_family": excl}
        for k in score_keys:
            for tag, scores in (("lofo", lofo_scores), ("allfam", all_scores),
                                ("dsp", dsp_scores)):
                if k in scores:  # perc has no tonal truth -> no key_mirex
                    row[f"{tag}_{k}"] = round(float(scores[k]), 3)
        print("  " + json.dumps(row), flush=True)
        results.append(row)

    os.makedirs(os.path.dirname(os.path.abspath(ns.lofo_out)), exist_ok=True)
    with open(ns.lofo_out, "w") as f:
        json.dump({"clips_per_family": ns.clips_per_family,
                   "eval_n": ns.eval_n, "rows": results}, f, indent=2)
    print(f"\nwrote {ns.lofo_out}")
    return results


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clips-per-family", type=int, default=40)
    ap.add_argument("--steps-beat", type=int, default=3000)
    ap.add_argument("--steps-key", type=int, default=2500)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--crop", type=int, default=1000)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default=neural.WEIGHTS_PATH)
    ap.add_argument("--eval-n", type=int, default=10,
                    help="held-out clips per family for the post-train score")
    ap.add_argument("--lofo", action="store_true",
                    help="leave-one-family-out generalization study: train "
                         "len(FAMILIES) models, each with one family fully "
                         "EXCLUDED from training, and score each on its "
                         "excluded family. Writes --lofo-out; does NOT touch "
                         "the weights at --out")
    ap.add_argument("--lofo-out", default=LOFO_OUT,
                    help="where --lofo writes its JSON (default: beside this module)")
    ap.add_argument("--device", default="cuda",
                    help="device to train on (default: the GPU; 'cpu' trains on the host)")
    ns = ap.parse_args(argv)
    resolve_device(ns.device)
    rng = np.random.RandomState(0)

    if ns.lofo:
        return run_lofo(ns)

    t0 = time.time()
    print("building the beat and key datasets...", flush=True)
    (feats, targs), (xs, ys) = build_datasets(ns.clips_per_family, TRAIN_SEED_BASE)
    print(f"  {len(feats)} beat clips, {len(xs)} key clips in {time.time() - t0:.1f}s", flush=True)
    beat = train_beat(feats, targs, ns.steps_beat, ns.batch, ns.crop, ns.lr, rng,
                      device=ns.device)
    key = train_key(xs, ys, ns.steps_key, 64, ns.lr, rng, device=ns.device)

    params = {**beat.params, **key.params}
    save_params(ns.out, params)
    size_kb = os.path.getsize(ns.out) / 1024
    print(f"saved {ns.out} ({size_kb:.0f} KB, "
          f"{sum(v.size for v in params.values())} params)")

    if ns.eval_n:
        _clear_weight_caches()  # pick up the fresh weights
        chain = neural.neural_annotators(weights=ns.out, device=ns.device)
        print("\nheld-out validation (seeds disjoint from train AND from "
              "the synthbench eval):")
        for fam in FAMILIES:
            scores = run_benchmark(ns.eval_n, 12.0, seed=777, family=fam,
                                   annotators=chain)
            line = " ".join(
                f"{k}={v:.3f}" for k, v in scores.items()
                if isinstance(v, float)
            )
            print(f"  {fam}: {line}", flush=True)
    return beat, key


if __name__ == "__main__":
    main()
