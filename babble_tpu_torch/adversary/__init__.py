"""Active-adversary harness: a scriptable Byzantine validator.

``ByzantineNode`` speaks the real RPC surface over any Transport
(including a ChaosTransport wrap) and executes named attacks from
``ATTACKS`` — equivocation, stale replay, wrong-key floods, oversized
syncs, lying known-maps, garbage payloads — against a live cluster.
See docs/robustness.md §Byzantine fault model for the catalog and the
defense each attack exercises.
"""

from .byzantine import ATTACKS, ByzantineCore, ByzantineNode

__all__ = ["ATTACKS", "ByzantineCore", "ByzantineNode"]
