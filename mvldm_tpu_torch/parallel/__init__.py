"""Multi-rank training: the bootstrap, the (data, model) grid and its
sharding rules, and tensor parallelism (counterpart of
``mvldm_tpu/parallel/``)."""

from .mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh"]
