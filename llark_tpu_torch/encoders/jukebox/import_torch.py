"""openai/jukebox 5B checkpoints into the port's parameter trees;
counterpart of llark_tpu/encoders/jukebox/import_torch.py.

`convert_vqvae` / `convert_prior` map openai-named state dicts straight
into the trees the port's encoder takes (fp32 tensors on the state dict's
device). The same trees travel as an npz bundle:

  python -m llark_tpu_torch.encoders.jukebox.import_torch \
      --vqvae vqvae.pth.tar --prior prior_level_2.pth.tar \
      --depth 36 --output jukebox5b_36.npz [--conds conds.npz]

writes the keys the JAX package's importer writes, and `load_npz` reads
either package's bundle. The reference loads the 72-layer prior with
strict=False after patching prior_depth=36 (jukebox/make_models.py.patch,
jukebox/main.py:188-199): layers >= depth are dropped here explicitly.

Name mapping (openai/jukebox state dicts -> the trees):
  VQ-VAE (the top encoder's chain only):
    encoders.{top}.level_blocks.{l}.model.{i}.*  downsample convs + resnets
    bottleneck.level_blocks.{l}.k                codebook [bins, emb]
  Prior ('prior.' or bare names; 'module.' stripped):
    x_emb.weight [bins, width], pos_emb.pos_emb [n_ctx, width]
    transformer._attn_mods.{d}.{ln_0,attn.c_attn,attn.c_proj,ln_1,mlp.c_fc,mlp.c_proj}.*
  jukebox Conv1D stores w as [n_in, n_out] (x @ w), the trees' layout.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
from typing import Any, Dict

import numpy as np
import torch

from llark_tpu_torch.encoders.jukebox.config import JukeboxPriorConfig, JukeboxVQVAEConfig

PRIOR_NAMES = {
    "ln0_g": "ln_0.weight", "ln0_b": "ln_0.bias",
    "attn_w": "attn.c_attn.w", "attn_b": "attn.c_attn.b",
    "proj_w": "attn.c_proj.w", "proj_b": "attn.c_proj.b",
    "ln1_g": "ln_1.weight", "ln1_b": "ln_1.bias",
    "fc_w": "mlp.c_fc.w", "fc_b": "mlp.c_fc.b",
    "mlp_proj_w": "mlp.c_proj.w", "mlp_proj_b": "mlp.c_proj.b",
}


def _t(x) -> torch.Tensor:
    """A state dict entry as an fp32 tensor."""
    return (x.detach() if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))).float()


def strip_module(sd: Dict[str, Any]) -> Dict[str, Any]:
    return {k[7:] if k.startswith("module.") else k: v for k, v in sd.items()}


def convert_vqvae(sd: Dict[str, Any], cfg: JukeboxVQVAEConfig) -> Dict[str, Any]:
    """The top encoder's blocks and the codebooks -> the VQ-VAE tree.

    jukebox builds an independent full encoder per VQ level: encoders.{l}
    chains level_blocks.{0..l} from raw audio, with weights not shared
    across encoders. The top-level codes (the only level the reference
    consumes, jukebox/main.py:54-68) take every block from the TOP
    encoder's chain, encoders.{top}.level_blocks.{0..top}."""
    sd = strip_module(sd)
    top = cfg.levels - 1
    levels = []
    for level in range(cfg.levels):
        block_prefix = f"encoders.{top}.level_blocks.{level}"
        stages = []
        for stage_idx in range(cfg.downs_t[level]):
            base = f"{block_prefix}.model.{stage_idx}"
            res = []
            # the res-block count comes from the keys, not cfg.depth: a
            # config / checkpoint mismatch must fail below, never truncate
            while f"{base}.1.model.{len(res)}.model.1.weight" in sd:
                rbase = f"{base}.1.model.{len(res)}.model"
                res.append({"w1": _t(sd[f"{rbase}.1.weight"]), "b1": _t(sd[f"{rbase}.1.bias"]),
                            "w2": _t(sd[f"{rbase}.3.weight"]), "b2": _t(sd[f"{rbase}.3.bias"])})
            if len(res) != cfg.top_depth:
                raise ValueError(
                    f"{base}: checkpoint has {len(res)} res blocks, config expects "
                    f"top_depth={cfg.top_depth} (depth {cfg.depth} x "
                    f"multiplier {cfg.multipliers[top]})")
            stages.append({"down_w": _t(sd[f"{base}.0.weight"]),
                           "down_b": _t(sd[f"{base}.0.bias"]), "res": res})
        proj_key = f"{block_prefix}.model.{cfg.downs_t[level]}"
        levels.append({"stages": stages, "proj_w": _t(sd[f"{proj_key}.weight"]),
                       "proj_b": _t(sd[f"{proj_key}.bias"])})
    codebooks = []
    for level in range(cfg.levels):
        k = _t(sd[f"bottleneck.level_blocks.{level}.k"])
        if k.shape[0] == cfg.emb_width:  # stored [emb, bins] -> [bins, emb]
            k = k.t().contiguous()
        codebooks.append(k)
    return {"levels": levels, "codebooks": codebooks}


def _prior_getter(sd: Dict[str, Any]):
    def get(name):
        for prefix in ("prior.", ""):
            if prefix + name in sd:
                return sd[prefix + name]
        raise KeyError(name)

    return get


def convert_prior(sd: Dict[str, Any], cfg: JukeboxPriorConfig) -> Dict[str, Any]:
    """The prior's first cfg.depth layers -> the prior tree, layers stacked
    [depth // 3, 3, ...]."""
    get = _prior_getter(strip_module(sd))
    if cfg.depth % 3:
        raise ValueError(f"depth {cfg.depth} is not a multiple of the attention cycle (3)")
    layers = {
        ours: torch.stack([_t(get(f"transformer._attn_mods.{d}.{theirs}"))
                           for d in range(cfg.depth)]).unflatten(0, (cfg.depth // 3, 3))
        for ours, theirs in PRIOR_NAMES.items()
    }
    return {"x_emb": _t(get("x_emb.weight")), "pos_emb": _t(get("pos_emb.pos_emb")),
            "layers": layers}


def infer_prior_config(
    sd: Dict[str, Any], depth: int = 36, heads: int = 8, blocks: int = 0
) -> JukeboxPriorConfig:
    """Sizes come from tensor shapes; `heads` and `blocks` are not
    recoverable from shapes and must match the training config (5b top
    prior: heads=8, blocks=128). blocks=0 -> n_ctx // 64 (block_ctx is 64
    in every public prior)."""
    get = _prior_getter(strip_module(sd))

    def shape(name):
        t = get(name)
        return tuple(getattr(t, "shape", np.shape(t)))

    bins, width = shape("x_emb.weight")
    n_ctx, _ = shape("pos_emb.pos_emb")
    _, attn3 = shape("transformer._attn_mods.0.attn.c_attn.w")
    _, mlp_w = shape("transformer._attn_mods.0.mlp.c_fc.w")
    return JukeboxPriorConfig(
        n_ctx=int(n_ctx),
        width=int(width),
        depth=depth,
        heads=heads,
        bins=int(bins),
        blocks=blocks or int(n_ctx) // 64,
        m_attn=(attn3 // 3) / width,
        m_mlp=mlp_w / width,
    )


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Invert the dotted-key flattening of `main`; integer path components
    become list indices."""
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(".")
        node = root
        for i, part in enumerate(parts):
            node = node.setdefault(part, value if i == len(parts) - 1 else {})

    def materialize(node):
        if not isinstance(node, dict):
            return node
        if node and all(re.fullmatch(r"\d+", k) for k in node):
            return [materialize(node[str(i)]) for i in range(len(node))]
        return {k: materialize(v) for k, v in node.items()}

    return materialize(root)


def load_npz(path: str):
    """Read an importer's npz (either package's) back into (vq_cfg,
    prior_cfg, vq_params, prior_params, cond_params | None, conds | None):
    the parameter trees as CPU tensors, the conditioner tables and conds as
    numpy (the conditioner runs on the host)."""
    z = np.load(path)
    vq_cfg = JukeboxVQVAEConfig(
        **{k: tuple(v) if isinstance(v, list) else v
           for k, v in json.loads(bytes(z["__vq_cfg__"]).decode()).items()}
    )
    pr_cfg = JukeboxPriorConfig(**json.loads(bytes(z["__prior_cfg__"]).decode()))
    groups: Dict[str, Dict[str, Any]] = {"vq": {}, "prior": {}, "cond": {}}
    conds = {}
    for key in z.files:
        if key.startswith("__"):
            continue
        head, _, rest = key.partition(".")
        if head in ("vq", "prior"):
            groups[head][rest] = torch.from_numpy(z[key])
        elif head == "cond":
            groups[head][rest] = z[key]
        elif head in ("x_cond", "y_cond"):
            conds[head] = z[key]
    return (
        vq_cfg,
        pr_cfg,
        _unflatten(groups["vq"]),
        _unflatten(groups["prior"]),
        _unflatten(groups["cond"]) if groups["cond"] else None,
        conds or None,
    )


def _flatten(prefix: str, tree: Any, flat: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(f"{prefix}.{k}", v, flat)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            _flatten(f"{prefix}.{i}", v, flat)
    else:
        flat[prefix] = tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def main(argv=None):
    from llark_tpu_torch.encoders.jukebox.conditioner import convert_conditioner

    p = argparse.ArgumentParser("llark_tpu_torch.encoders.jukebox.import_torch")
    p.add_argument("--vqvae", required=True)
    p.add_argument("--prior", required=True)
    p.add_argument("--depth", type=int, default=36)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--blocks", type=int, default=0, help="0 = n_ctx // 64")
    p.add_argument("--output", required=True)
    p.add_argument("--conds", default=None, help="npz with x_cond/y_cond")
    p.add_argument("--vq-width", type=int, default=32)
    p.add_argument("--vq-depth", type=int, default=4)
    p.add_argument("--vq-emb-width", type=int, default=64)
    p.add_argument("--vq-bins", type=int, default=2048)
    args = p.parse_args(argv)

    vq_sd = torch.load(args.vqvae, map_location="cpu")["model"]
    pr_sd = torch.load(args.prior, map_location="cpu")["model"]
    vq_cfg = JukeboxVQVAEConfig(
        width=args.vq_width, depth=args.vq_depth,
        emb_width=args.vq_emb_width, l_bins=args.vq_bins,
    )
    pr_cfg = infer_prior_config(pr_sd, args.depth, heads=args.heads, blocks=args.blocks)

    flat: Dict[str, np.ndarray] = {}
    _flatten("vq", convert_vqvae(vq_sd, vq_cfg), flat)
    _flatten("prior", convert_prior(pr_sd, pr_cfg), flat)
    # label-conditioner tables (x_cond/y_cond at load time; reference:
    # jukebox/main.py:71-98): present in the public prior checkpoints,
    # absent in truncated test fixtures
    try:
        _flatten("cond", convert_conditioner(strip_module(pr_sd)), flat)
    except KeyError:
        print("no y_emb.* conditioner tables in the prior checkpoint; "
              "x_cond/y_cond default to zeros unless --conds is given")
    if args.conds:
        conds = np.load(args.conds)
        flat["x_cond"] = conds["x_cond"]
        flat["y_cond"] = conds["y_cond"]
    for name, cfg in (("__vq_cfg__", vq_cfg), ("__prior_cfg__", pr_cfg)):
        flat[name] = np.frombuffer(json.dumps(dataclasses.asdict(cfg)).encode(), dtype=np.uint8)
    np.savez(args.output, **flat)
    print(f"wrote {len(flat)} arrays to {args.output}")


if __name__ == "__main__":
    main()
