"""Multi-device placement for the graph engine (``sharding.graph``).

The reference's LM-side logical-axis rules (``repro/sharding/__init__.py``)
come with the training step (ROADMAP A14)."""
from repro_torch.sharding.graph import (GraphMesh, Replicated,
                                        batch_pad, check_mesh, divides,
                                        graph_mesh, mesh_size, replicate,
                                        shard_rows, shard_slots,
                                        single_device)

__all__ = ["GraphMesh", "Replicated", "batch_pad", "check_mesh", "divides",
           "graph_mesh", "mesh_size", "replicate", "shard_rows",
           "shard_slots", "single_device"]
