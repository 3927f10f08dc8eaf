"""Parallelism over torch.distributed (counterpart of llark_tpu/parallel):
the mesh and its partition rules (`mesh`), the explicit collectives
(`comm`), sharded serving (`serving`), pipeline training (`pipeline`),
ring attention (`ring_attention`) and local ranks for tests and the card
(`launch`). The names are exported lazily, so that the model modules can
import `comm` without importing what imports them."""

import importlib

_EXPORTS = {
    "MeshAxes": "mesh",
    "batch_sharding": "mesh",
    "make_mesh": "mesh",
    "param_partition_specs": "mesh",
    "param_shardings": "mesh",
    "make_pipeline_layers_fn": "pipeline",
    "make_pp_mesh": "pipeline",
    "make_pp_train_step": "pipeline",
    "pp_param_specs": "pipeline",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
