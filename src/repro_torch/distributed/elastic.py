"""Elastic re-meshing: rebuild the mesh and its shardings after device loss.

Counterpart of ``repro.distributed.elastic``. On a real fleet the controller
detects a failed device, restarts the process group with the survivors, and
calls :func:`elastic_mesh` for the largest valid (data, model) mesh over
the remaining ranks; :func:`reshard_tree` then maps the restored checkpoint
onto the new mesh. Data-parallel scale-down only changes the `data` axis,
so per-rank parameter shards stay valid; a model-axis change re-slices
every leaf (``distribute_tensor`` from the restored full tensors).
"""
from __future__ import annotations

import torch

from ..core.additive_gp import resolve_device
from ..core.fleet import tree_map
from .sharding import device_put, shardings_for

__all__ = ["elastic_mesh", "reshard_tree", "largest_data_axis"]


def largest_data_axis(n_devices: int, model: int) -> int:
    data = n_devices // model
    while data > 1 and (n_devices % (data * model)) != 0:
        data -= 1
    return max(data, 1)


def elastic_mesh(model: int = 16, ranks=None, device_type=None):
    """Largest (data, model) ``DeviceMesh`` over the surviving ``ranks``
    (default: the whole world of the initialised process group). The
    device type is ``"cuda"`` unless the caller names one, and raises
    without a GPU (``core.additive_gp.resolve_device``). With fewer ranks
    than ``model`` the model axis degrades to the largest power of two that
    fits. Every rank of the world calls this (the mesh's groups are made
    collectively); a rank outside ``ranks`` gets the mesh without a
    coordinate in it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    device_type = resolve_device(device_type).type
    ranks = (list(range(dist.get_world_size())) if ranks is None
             else [int(r) for r in ranks])
    n = len(ranks)
    if n < model:  # degrade TP if we lost too many devices
        model = 1 << (n.bit_length() - 1)
    data = largest_data_axis(n, model)
    used = torch.tensor(ranks[: data * model]).reshape(data, model)
    return DeviceMesh(device_type, used, mesh_dim_names=("data", "model"))


def reshard_tree(tree, axes_tree, mesh):
    """Move a (restored) tree onto a new mesh using the sharding rules:
    ``axes_tree`` holds one logical-axes tuple per tensor of ``tree``."""
    abstract = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                              device="meta"), tree)
    return device_put(tree, shardings_for(axes_tree, abstract, mesh))
