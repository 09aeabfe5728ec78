"""babble_tpu_torch — the PyTorch/CUDA port of babble_tpu.

The JAX package ``babble_tpu`` stays the reference. This package imports
neither it nor JAX: its host modules (hashgraph, node, network, mempool,
service, CLI, sim and the rest) are its own copies, and the device side
(``ops``) is PyTorch with hand-written CUDA kernels for Hopper (``csrc``).
Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``--accelerator-device cpu`` on the command line,
``python -m babble_tpu_torch``).
"""
