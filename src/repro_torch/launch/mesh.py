"""Production meshes — counterpart of ``repro/launch/mesh.py``.

Defined as functions (never module-level constants) so importing this
module touches no device and no process group.  Each builds a
``DeviceMesh`` with ``init_device_mesh``: one process a device, the
default process group already initialized (``torch.distributed``'s
``init_process_group``; ``init_device_mesh`` initializes it from the
environment otherwise).  ``device_type="cpu"`` builds the same mesh
over ``gloo`` processes, as the tests do.
"""
from __future__ import annotations


def _mesh(shape: tuple, axes: tuple, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: (data=16, model=16) over 256 processes.
    Multi-pod: (pod=2, data=16, model=16) over 512."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_test_mesh(n_data: int = 4, n_model: int = 2,
                   device_type: str = "cuda"):
    """A small (data, model) mesh over n_data × n_model processes."""
    return _mesh((n_data, n_model), ("data", "model"), device_type)
