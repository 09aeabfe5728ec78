"""Device side of the port: device resolution, the exact 0/1 tally, the
hand-written CUDA kernels, the fused voting sweep and the DAG pipeline of
the consensus offload, and batched signature verification (``verify``, on
the field layer ``limbs``)."""
