"""Device mesh and sharding rules (counterpart of llark_tpu/parallel/mesh.py).

The JAX package runs one controller over a ("data", "fsdp", "tensor"[,
"expert"]) mesh and lets GSPMD insert the collectives. The port runs one
process per rank (SPMD over torch.distributed) and keeps the same mesh, the
same partition rules as data, and explicit collectives (`parallel/comm.py`):

  * batch rows split over ("data", "fsdp") and are replicated over
    "tensor" and "expert" (`batch_sharding`, `batch_shard_index`);
  * parameters and optimizer state split over "fsdp" (ZeRO-3): a layer's
    weights are all-gathered before use and their gradients reduce-
    scattered (`Shard.gather_layer`);
  * "tensor" is Megatron tensor parallelism, the layout GSPMD derives from
    these specs: each rank holds num_heads/t query heads, num_kv_heads/t KV
    heads, intermediate/t MLP columns and vocab/t LM-head columns; wo and
    w_down are followed by an all-reduce, their biases added once after it;
    the logits are all-gathered;
  * "expert" holds E/e experts a rank (MoE, `models/moe.py`).

A spec is a `P`: per dimension, the mesh axis it is split over or None.
`shard_params` turns a full tree into this rank's shards and
`gather_params` does the inverse. `local_config` gives the decoder the
local widths and, in its `shard` field, the mesh and the specs it gathers
and reduces with; on a mesh of one every collective is a no-op and the
decoder runs its single-device code.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from llark_tpu_torch.config import ModelConfig
from llark_tpu_torch.parallel import comm


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    data: str = "data"
    fsdp: str = "fsdp"
    tensor: str = "tensor"
    expert: str = "expert"  # EP: MoE expert dim (models/moe.py)

    @property
    def batch(self) -> Tuple[str, str]:
        return (self.data, self.fsdp)


AXES = MeshAxes()

# collectives that hang past this raise (a rank that died leaves the others
# waiting in one)
TIMEOUT = datetime.timedelta(seconds=600)


class P(tuple):
    """A partition spec: for each dimension, the mesh axis it is split over,
    or None (replicated)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __getnewargs__(self):
        return tuple(self)


# ---------------------------------------------------------------------------
# Process group and mesh
# ---------------------------------------------------------------------------


def default_backend(device: str) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_process_group(device: str = "cuda", world_size: int = 1,
                       backend: Optional[str] = None) -> None:
    """Bring up the default process group if none is up: from the
    `torchrun` environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT),
    across nodes as well; without one, a world of one rank. NCCL on the
    card, gloo on the CPU, unless `backend` says otherwise."""
    if dist.is_initialized():
        return
    backend = backend or default_backend(device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if torch.device(device).type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", 0))
            torch.cuda.set_device(local % max(torch.cuda.device_count(), 1))
        dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
        return
    if world_size != 1:
        raise ValueError(
            f"a mesh of {world_size} devices needs a process group of {world_size} ranks: "
            "launch with torchrun (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) or call "
            "torch.distributed.init_process_group first"
        )
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                            timeout=TIMEOUT)


_MESHES: Dict[Tuple, Any] = {}
_LAST: list = [None]  # the mesh this process made last (data sharding)


def _device_mesh(shape: Tuple[int, ...], names: Tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh

    # the mesh's device type only names where DTensors would live; the
    # groups follow the default group's backend (gloo also for CUDA
    # tensors of ranks that share one card)
    dtype = "cuda" if comm.backend() == "nccl" else "cpu"
    key = (shape, names, dtype)
    if key not in _MESHES:
        _MESHES[key] = init_device_mesh(dtype, shape, mesh_dim_names=names)
    _LAST[0] = _MESHES[key]
    return _MESHES[key]


def make_mesh(shape: Optional[Sequence[int]] = None, device: str = "cuda",
              backend: Optional[str] = None):
    """A ("data", "fsdp", "tensor") DeviceMesh over the ranks of the default
    process group, or with a 4-length shape ("data", "fsdp", "tensor",
    "expert") for MoE/EP runs (llark_tpu/parallel/mesh.py:54-72). Default:
    every rank on the fsdp axis. With no group up it initialises one
    (`init_process_group`)."""
    if shape is not None and len(shape) not in (3, 4):
        raise ValueError(f"mesh shape must have 3 or 4 axes, got {tuple(shape)}")
    n = int(np.prod(shape)) if shape is not None else None
    init_process_group(device, world_size=n or 1, backend=backend)
    world = dist.get_world_size()
    if shape is None:
        shape = (1, world, 1)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} does not match {world} devices")
    names = (AXES.data, AXES.fsdp, AXES.tensor, AXES.expert)[: len(shape)]
    return _device_mesh(shape, names)


def check_mesh(mesh) -> None:
    """Raise unless `mesh` is a DeviceMesh (make_mesh's)."""
    if not hasattr(mesh, "mesh_dim_names") or not hasattr(mesh, "get_group"):
        raise TypeError(f"mesh must be a torch DeviceMesh (llark_tpu_torch.parallel.mesh "
                        f"make_mesh), got {type(mesh).__name__}")


@contextlib.contextmanager
def mesh_session(shape: Optional[Sequence[int]] = None, device: str = "cuda"):
    """make_mesh for a command-line run: a process group this call brings up
    (a world of one without a launcher) is torn down on exit. A shape with
    None in it takes the world size there."""
    owned = not dist.is_initialized()
    if shape is not None and None in shape:
        init_process_group(device, world_size=int(os.environ.get("WORLD_SIZE", "1")))
        shape = tuple(dist.get_world_size() if s is None else s for s in shape)
    try:
        yield make_mesh(shape, device=device)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()
            _MESHES.clear()
            _LAST[0] = None


def split_rows(mesh, x: np.ndarray) -> np.ndarray:
    """Data-parallel extraction: this rank's rows of a batch split over
    every rank of the mesh, the batch padded with zero rows to a multiple
    of the world size first (llark_tpu/encoders/clap/encode.py:93-106)."""
    n, r = mesh.size(), mesh.get_rank()
    per = -(-x.shape[0] // n)
    pad = per * n - x.shape[0]
    if pad:
        x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
    return x[r * per:(r + 1) * per]


def gather_rows(local: np.ndarray, n_rows: int) -> np.ndarray:
    """Every rank's rows (split_rows) back in order, the padding trimmed."""
    parts = comm.all_gather_object(local, comm.world())
    return np.concatenate(parts)[:n_rows]


def axis_size(mesh, axis: str) -> int:
    """Size of `axis` on the mesh, 1 for an axis it does not have."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape)).get(axis, 1)


def axis_rank(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis) if axis in mesh.mesh_dim_names else 0


def axis_group(mesh, axis: str):
    return mesh.get_group(axis) if axis in mesh.mesh_dim_names else None


def batch_shard_index(mesh) -> Tuple[int, int]:
    """(this rank's batch shard, number of batch shards): the rank's
    coordinate over ("data", "fsdp"). Ranks that differ only in "tensor",
    "expert" or "pipe" hold the same rows."""
    d, f = axis_size(mesh, AXES.data), axis_size(mesh, AXES.fsdp)
    return axis_rank(mesh, AXES.data) * f + axis_rank(mesh, AXES.fsdp), d * f


def current_batch_shard() -> Tuple[int, int]:
    """batch_shard_index of the mesh this process made last; without one,
    (rank, world size) of the default group, or (0, 1)."""
    if _LAST[0] is not None:
        return batch_shard_index(_LAST[0])
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def batch_sharding(mesh, micro_batches: int = 1):
    """The batch-layout rule (llark_tpu/parallel/mesh.py:177-189) as a
    function: a host array or tensor -> this rank's rows of it (dim 0 split
    over ("data", "fsdp"), everything else whole). With `micro_batches`
    the rows are those of each micro-batch in turn, so that the train
    step's split of the local rows (train/step.py `_split`) gives this
    rank's part of the global step's micro-batch i. Scalars pass
    unchanged."""
    index, count = batch_shard_index(mesh)

    def rows(x):
        if getattr(x, "ndim", 0) == 0:
            return x
        if x.shape[0] % (count * micro_batches):
            raise ValueError(f"batch of {x.shape[0]} rows does not split over "
                             f"{count} batch shards (data x fsdp) x {micro_batches} "
                             "micro-batches")
        micro = x.shape[0] // micro_batches
        m = micro // count
        parts = [x[i * micro + index * m:i * micro + (index + 1) * m]
                 for i in range(micro_batches)]
        if len(parts) == 1:
            return parts[0]
        return torch.cat(parts) if isinstance(x, torch.Tensor) else np.concatenate(parts)

    return rows


# ---------------------------------------------------------------------------
# Partition rules
# ---------------------------------------------------------------------------


def _layer_specs(cfg: ModelConfig) -> Dict[str, P]:
    """Specs of the stacked [L, ...] layer params (mesh.py:75-126)."""
    f, t = AXES.fsdp, AXES.tensor
    specs: Dict[str, P] = {
        "attn_norm_scale": P(None, None),
        "mlp_norm_scale": P(None, None),
        # attention: column-parallel qkv, row-parallel out
        "wq": P(None, f, t),
        "wk": P(None, f, t),
        "wv": P(None, f, t),
        "wo": P(None, t, f),
        # mlp: column-parallel up/gate, row-parallel down
        "w_up": P(None, f, t),
        "w_down": P(None, t, f),
    }
    if cfg.mlp_activation == "silu":
        specs["w_gate"] = P(None, f, t)
    if cfg.moe_num_experts > 0:
        e = AXES.expert
        del specs["w_up"], specs["w_down"]
        specs.pop("w_gate", None)
        specs["moe_router"] = P(None, f, None)
        specs["moe_w_up"] = P(None, e, f, t)
        specs["moe_w_down"] = P(None, e, t, f)
        if cfg.mlp_activation == "silu":
            specs["moe_w_gate"] = P(None, e, f, t)
    if cfg.norm_type == "layernorm":
        specs["attn_norm_bias"] = P(None, None)
        specs["mlp_norm_bias"] = P(None, None)
    if cfg.use_bias:
        specs.update(bq=P(None, t), bk=P(None, t), bv=P(None, t), bo=P(None, f))
        if cfg.moe_num_experts == 0:
            specs["b_up"] = P(None, t)
            specs["b_down"] = P(None, f)
            if cfg.mlp_activation == "silu":
                specs["b_gate"] = P(None, t)
    if cfg.lora_rank > 0:
        from llark_tpu_torch.models.lora import lora_layer_specs

        specs.update(lora_layer_specs(cfg, specs))
    return specs


def param_partition_specs(cfg: ModelConfig, multimodal: bool = True) -> Dict[str, Any]:
    """Spec tree matching init_llark_params / init_decoder_params."""
    f, t = AXES.fsdp, AXES.tensor
    specs: Dict[str, Any] = {
        "embed": P(None, f),
        "layers": _layer_specs(cfg),
        "final_norm_scale": P(None),
    }
    if cfg.norm_type == "layernorm":
        specs["final_norm_bias"] = P(None)
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(f, t)
    if multimodal:
        specs["mm_projector"] = {"kernel": P(f, t), "bias": P(None)}
    return specs


def _is_quant(p) -> bool:
    return isinstance(p, dict) and "scale" in p and ("q" in p or "q4" in p or "q4c" in p)


def adapt_specs_to_params(specs: Any, params: Any) -> Any:
    """Expand spec leaves into {q, scale} / {q4, scale} / {q4c, scale} spec
    dicts wherever the params hold a quantized weight (models/quant.py).
    The packed tensor keeps the weight's spec. The scale follows it on every
    dim but the contraction's: there an int8 scale has size 1, and an int4
    scale's group dim is split over "tensor" with the rows it scales (a
    row-parallel wo / w_down), else whole. The JAX package keeps the
    scale's leading dims whole; the port splits an expert stack's scales
    with its experts, since each rank computes only its own."""

    def walk(spec, p):
        if _is_quant(p):
            base = tuple(spec) if isinstance(spec, P) else ()
            qkey = "q" if "q" in p else ("q4" if "q4" in p else "q4c")
            nd = p["scale"].ndim
            axes = list(base) + [None] * (nd - len(base))
            contraction = axes[-2] if nd >= 2 else None
            if qkey == "q" or contraction != AXES.tensor:
                contraction = None
            scale = P(*(axes[:-2] + [contraction, axes[-1]])) if nd >= 2 else P(axes[-1])
            return {qkey: P(*base), "scale": scale}
        if isinstance(p, dict):
            return {k: walk(spec[k] if isinstance(spec, dict) else spec, v) for k, v in p.items()}
        return spec

    return walk(specs, params)


def iter_spec_leaves(specs: Any, prefix: str = "") -> Iterator[Tuple[str, P]]:
    """(path, spec) in the paths `train.state.iter_leaves` gives params."""
    for name, value in specs.items():
        if isinstance(value, dict):
            yield from iter_spec_leaves(value, f"{prefix}{name}/")
        else:
            yield f"{prefix}{name}", value


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec placed on a mesh: `local` cuts this rank's shard of a full
    tensor (the port's counterpart of a NamedSharding)."""

    mesh: Any
    spec: P

    def local(self, x: torch.Tensor, path: str = "tensor") -> torch.Tensor:
        for d, axis in enumerate(self.spec):
            if axis is None:
                continue
            n = axis_size(self.mesh, axis)
            if x.shape[d] % n:
                raise ValueError(f"dimension {d} of {path} ({x.shape[d]}) is not divisible "
                                 f"by mesh axis {axis!r} ({n})")
            size = x.shape[d] // n
            x = x.narrow(d, axis_rank(self.mesh, axis) * size, size)
        return x.contiguous()


def param_shardings(mesh, specs) -> Any:
    if isinstance(specs, dict):
        return {k: param_shardings(mesh, v) for k, v in specs.items()}
    return Sharding(mesh, specs)


def _check_int4_groups(mesh, path: str, leaf: Dict[str, torch.Tensor], spec: Dict[str, P]) -> None:
    """A row-parallel int4 weight split over "tensor" keeps its scale
    groups whole on every rank."""
    key = "q4" if "q4" in leaf else ("q4c" if "q4c" in leaf else None)
    scale_spec = tuple(spec["scale"])
    if key is None or len(scale_spec) < 2 or scale_spec[-2] != AXES.tensor:
        return
    t = axis_size(mesh, AXES.tensor)
    groups = leaf["scale"].shape[-2]
    rows = leaf[key].shape[-2] * (2 if key == "q4" else 1)
    if groups % t:
        raise ValueError(
            f"int4 weight {path}: {rows} input rows over tensor={t} leave {rows // t} rows "
            f"a rank, not a multiple of its {rows // groups}-row scale group; use a tensor "
            f"axis that divides the {groups} groups"
        )


def shard_params(mesh, params: Dict[str, Any], specs: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's shards of a full param tree (torch tensors, or numpy
    arrays, which become CPU tensors): each tensor cut along the dims its
    spec splits. requires_grad is not carried; the caller sets it."""

    def walk(p, s, path):
        if isinstance(p, dict):
            if _is_quant(p):
                _check_int4_groups(mesh, path, p, s)
            return {k: walk(v, s[k], f"{path}/{k}" if path else k) for k, v in p.items()}
        t = torch.from_numpy(np.ascontiguousarray(p)) if isinstance(p, np.ndarray) else p
        return Sharding(mesh, s).local(t.detach(), path).clone()

    return walk(params, specs, "")


def gather_param(mesh, x: torch.Tensor, spec: P) -> torch.Tensor:
    """The full tensor from every rank's shard (a collective: every rank
    calls it and gets the result), detached."""
    x = x.detach()
    for d, axis in enumerate(spec):
        if axis is not None:
            x = comm.all_gather_cat(x, d, axis_group(mesh, axis))
    return x


def gather_params(mesh, params: Dict[str, Any], specs: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of shard_params: the full tree on every rank (checkpoints,
    tests)."""
    if isinstance(params, dict):
        return {k: gather_params(mesh, v, specs[k]) for k, v in params.items()}
    return gather_param(mesh, params, specs)


# ---------------------------------------------------------------------------
# The decoder's view of the mesh
# ---------------------------------------------------------------------------


class Shard:
    """This rank's place on a mesh, with the specs of the tree it holds:
    the collectives the decoder, the MoE layer and the train step call."""

    def __init__(self, mesh, specs: Dict[str, Any]):
        self.mesh = mesh
        self.specs = specs
        # the layer specs without the stacked layer dim
        self.layer_specs = {k: _drop_first(v) for k, v in specs.get("layers", {}).items()}
        self.flat_specs = dict(iter_spec_leaves(specs))

    def size(self, axis: str) -> int:
        return axis_size(self.mesh, axis)

    def rank(self, axis: str) -> int:
        return axis_rank(self.mesh, axis)

    def group(self, axis: str):
        return axis_group(self.mesh, axis)

    @property
    def tensor(self) -> int:
        return self.size(AXES.tensor)

    def batch_shards(self) -> int:
        return batch_shard_index(self.mesh)[1]

    def model_groups(self):
        """The groups whose ranks hold the same rows and different parts of
        the model: "tensor", then "expert"."""
        return [g for g in (self.group(AXES.tensor), self.group(AXES.expert))
                if comm.group_size(g) > 1]

    def _fsdp(self, w, spec):
        if isinstance(w, dict):
            return {k: self._fsdp(v, spec[k] if isinstance(spec, dict) else spec)
                    for k, v in w.items()}
        group = self.group(AXES.fsdp)
        for d, axis in enumerate(spec):
            if axis == AXES.fsdp:
                w = comm.gather(w, d, group, backward="sum")
        return w

    def gather_layer(self, lp: Dict[str, Any]) -> Dict[str, Any]:
        """One layer's weights whole over "fsdp" (their gradients reduce-
        scattered in the backward); "tensor" and "expert" dims stay local."""
        if self.size(AXES.fsdp) == 1:
            return lp
        return {k: self._fsdp(v, self.layer_specs[k]) for k, v in lp.items()}

    def gather_top(self, name: str, w):
        """A top-level weight (embed, lm_head) whole over "fsdp"."""
        if self.size(AXES.fsdp) == 1:
            return w
        return self._fsdp(w, self.specs[name])

    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the batch shards ("data", then "fsdp"); no autograd."""
        for axis in AXES.batch:
            x = comm.all_reduce_fp32(x, self.group(axis)) if x.is_floating_point() \
                else comm.all_reduce_int(x, self.group(axis))
        return x


def _drop_first(spec):
    if isinstance(spec, dict):
        return {k: _drop_first(v) for k, v in spec.items()}
    return P(*tuple(spec)[1:])


@dataclasses.dataclass
class ShardedConfig(ModelConfig):
    """A ModelConfig with this rank's widths (num_heads, num_kv_heads and
    intermediate_size divided by the tensor axis) and, in `shard`, the mesh
    and specs the decoder gathers and reduces with."""

    shard: Any = dataclasses.field(default=None, compare=False, repr=False)


def local_config(cfg: ModelConfig, shard: Shard) -> ShardedConfig:
    """The config a rank runs its shards with. Raises where a width does
    not split over the tensor axis."""
    t = shard.tensor
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(ModelConfig)}
    for name in ("num_heads", "num_kv_heads", "intermediate_size"):
        if fields[name] % t:
            raise ValueError(f"{name} {fields[name]} is not divisible by mesh axis "
                             f"'tensor' ({t})")
    if cfg.moe_num_experts and cfg.moe_num_experts % shard.size(AXES.expert):
        raise ValueError(f"moe_num_experts {cfg.moe_num_experts} is not divisible by mesh "
                         f"axis 'expert' ({shard.size(AXES.expert)})")
    fields.update(num_heads=cfg.num_heads // t, num_kv_heads=cfg.num_kv_heads // t,
                  intermediate_size=cfg.intermediate_size // t, head_dim=cfg.head_dim)
    return ShardedConfig(**fields, shard=shard)


def shard_model(mesh, cfg: ModelConfig, params: Dict[str, Any],
                multimodal: Optional[bool] = None) -> Tuple[ShardedConfig, Dict[str, Any]]:
    """(local config, this rank's shards) of a full model. Quantized trees
    get their specs adapted (adapt_specs_to_params)."""
    check_mesh(mesh)
    if multimodal is None:
        multimodal = "mm_projector" in params
    specs = adapt_specs_to_params(param_partition_specs(cfg, multimodal), params)
    local = shard_params(mesh, params, specs)
    return local_config(cfg, Shard(mesh, specs)), local
