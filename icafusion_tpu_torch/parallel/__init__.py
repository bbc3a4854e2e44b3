"""Data parallelism of the port on torch.distributed (parallel/mesh.py)."""

from icafusion_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch

__all__ = ["make_mesh", "shard_batch", "replicate"]
