"""Parallelism over `torch.distributed`: the process mesh, the halo
exchange, and the lattice-sharded SU(3) path (PyTorch counterpart of the
JAX package's `parallel/`)."""
