"""Light-client gateway tier (docs/clients.md).

Everything between validators and untrusted readers:

- ``subhub``     — streaming commit subscriptions (selector-loop push
                   server with bounded per-subscriber queues and
                   slow-consumer shedding);
- ``proofs``     — the tx→block index and signed Merkle inclusion-proof
                   builder served at ``GET /proof/<txid>``;
- ``verifier``   — STATELESS proof/checkpoint verification from the
                   validator set alone (safe to vendor into clients);
- ``checkpoint`` — signed Frame-style fast-sync snapshots for instant
                   read-replica spin-up;
- ``replica``    — a verifying read replica: checkpoint import +
                   subscription tail + its own proof-serving HTTP
                   endpoint;
- ``gateway``    — the sharded admission front end: fans SubmitTx
                   across mempool-verdict workers, forwards accepted
                   transactions to validators, and re-serves the commit
                   stream to its own subscribers;
- ``swarm``      — a selector-based many-subscriber load client (one
                   thread, thousands of sockets) used by
                   demo/bombard.py, bench.py --clients and the
                   clientsmoke suite.
"""
