"""Multi-process data parallelism (``distributed.py``, ``data_group.py``),
the (data, model) layout (``mesh.py``) and batch-sharded synthesis
(``synthesis.py``)."""

from .mesh import make_mesh, param_sharding_rules, shard_params

__all__ = ["make_mesh", "param_sharding_rules", "shard_params"]
