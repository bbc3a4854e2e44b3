"""Data parallelism of the port on torch.distributed (parallel/mesh.py)."""
