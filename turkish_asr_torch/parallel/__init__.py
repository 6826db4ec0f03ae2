"""Data, tensor and sequence parallelism over torch.distributed: the mesh
and layout (``mesh.py``) and the autograd-aware collectives
(``collectives.py``).

The JAX package's ``batch_sharding``, ``replicated_sharding``,
``param_shardings``, ``shard_batch`` and ``activation_constraint`` (XLA
shardings) have no counterpart: the port slices weights with
``shard_model`` and batches with the sampler's process slices."""

from turkish_asr_torch.parallel.collectives import (
    Traffic,
    all_gather,
    all_reduce,
    all_reduce_,
    broadcast_,
    copy_to,
    halo,
    reduce_from,
)
from turkish_asr_torch.parallel.mesh import (
    AXES,
    AxisGroup,
    Mesh,
    axis_group,
    barrier,
    check_batch,
    gather_state_dict,
    gather_tensor,
    init_distributed,
    make_mesh,
    param_layout,
    parse_mesh_spec,
    seq_bounds,
    shard_model,
    shard_seed,
    shard_state_dict,
    shard_tensor,
)

__all__ = [
    "make_mesh",
    "parse_mesh_spec",
    "Mesh",
    "AxisGroup",
    "AXES",
    "axis_group",
    "init_distributed",
    "barrier",
    "shard_seed",
    "check_batch",
    "seq_bounds",
    "param_layout",
    "shard_tensor",
    "gather_tensor",
    "shard_state_dict",
    "gather_state_dict",
    "shard_model",
    "Traffic",
    "all_reduce",
    "all_reduce_",
    "broadcast_",
    "copy_to",
    "reduce_from",
    "all_gather",
    "halo",
]
