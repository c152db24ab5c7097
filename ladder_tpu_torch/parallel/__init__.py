from ladder_tpu_torch.parallel.mesh import (
    DataMesh,
    all_reduce_sum,
    check_mesh_shape,
    make_mesh,
    pad_to_multiple,
    place_global_batch,
    place_global_stack,
    randn_rows,
    shard_batch,
    sharded,
)

__all__ = [
    "DataMesh",
    "all_reduce_sum",
    "check_mesh_shape",
    "make_mesh",
    "pad_to_multiple",
    "place_global_batch",
    "place_global_stack",
    "randn_rows",
    "shard_batch",
    "sharded",
]
