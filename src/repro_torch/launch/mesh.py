"""Production mesh construction (single-pod 16x16, multi-pod 2x16x16).

Counterpart of ``repro.launch.mesh`` on ``torch.distributed``.
"""
from __future__ import annotations

from ..distributed.sharding import mesh_axis_names

__all__ = ["make_production_mesh", "data_axes_for"]


def make_production_mesh(*, multi_pod: bool = False):
    """256-GPU (data, model) mesh or 512-GPU 2-pod (pod, data, model) mesh
    over the initialised process group.

    A function, not a module constant, so importing this module never
    touches a device or a process group.
    """
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh("cuda", shape, mesh_dim_names=axes)


def data_axes_for(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh_axis_names(mesh))
