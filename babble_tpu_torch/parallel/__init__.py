"""Multi-device consensus: device meshes, the batched and sharded DAG
pipeline, the sharded live sweep and the kernels with their exchanges
between shards spelled out.

The PyTorch counterpart of the JAX package's ``babble_tpu/parallel/``. As
there, one process drives every shard of a mesh; the exchanges
(``all_gather``, ``psum``, ``ppermute``) are copies between the shards'
devices made by that process (``parallel/mesh.py``), not
``torch.distributed``.
"""

from .collectives import (
    ring_strongly_see,
    sharded_strongly_see,
    sharded_vote_counts,
)
from .mesh import Mesh, consensus_mesh, ring_mesh, shard_batched_snapshot
from .pipeline import (
    batch_of_snapshots,
    batched_pipeline,
    sharded_batched_pipeline,
)

__all__ = [
    "Mesh",
    "consensus_mesh",
    "ring_mesh",
    "shard_batched_snapshot",
    "batched_pipeline",
    "batch_of_snapshots",
    "sharded_batched_pipeline",
    "sharded_vote_counts",
    "sharded_strongly_see",
    "ring_strongly_see",
]
