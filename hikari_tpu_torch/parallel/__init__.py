"""The parallel layer (counterpart of ``hikari_tpu.parallel``) on
``torch.distributed``: meshes of ranks, the row-sharded render and train
steps (``sharding.py``), the halo and gather transport between the ranks'
blocks (``halo.py``), the process group and host-local data
(``multihost.py``)."""

from hikari_tpu_torch.parallel.sharding import (
    DIFF_LEAVES,
    Mesh,
    make_mesh,
    make_mesh_2d,
    make_sharded_render,
    make_train_step,
    render_loss,
    replicate,
    shard_state,
    shard_state_2d,
)

__all__ = [
    "DIFF_LEAVES",
    "Mesh",
    "make_mesh",
    "make_mesh_2d",
    "make_sharded_render",
    "make_train_step",
    "render_loss",
    "replicate",
    "shard_state",
    "shard_state_2d",
]
