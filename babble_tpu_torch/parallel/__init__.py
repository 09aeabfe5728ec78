"""Batched consensus: the DAG pipeline over a leading axis of windows.

The multi-device pieces of the JAX package (``sharded_batched_pipeline``,
``mesh``, ``collectives``, ``voting_shard``) come with the
``torch.distributed`` slice of the port (ROADMAP.md, Queue A).
"""

from .pipeline import batch_of_snapshots, batched_pipeline

__all__ = ["batched_pipeline", "batch_of_snapshots"]
