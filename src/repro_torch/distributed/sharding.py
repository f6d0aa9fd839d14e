"""Logical-axis -> mesh-axis sharding rules (MaxText-style) on torch meshes.

Counterpart of ``repro.distributed.sharding``. Parameter/activation dims are
annotated with logical names; the rules below map them to mesh axes with
divisibility checks and first-match-wins conflict resolution (a mesh axis is
used at most once per tensor).

  batch    -> (pod, data)    data parallelism (pod = outer DP axis)
  tenant   -> (pod, data)    multi-tenant GP fleet: the leading tenant axis
                             of a stacked ``GPFleet`` is embarrassingly
                             parallel (tenants never exchange data), so it
                             shards exactly like a data batch
  ctx      -> (pod, data)    decode-cache sequence sharding; only claims the
                             data axes when `batch` could not (e.g. batch=1)
  embed    -> data           FSDP / ZeRO-3: weights gathered per layer
  heads, kv_heads, mlp, vocab, experts -> model   (TP / EP)

Falls back to replication when the dim size is not divisible.

The torch side of the reference's JAX types:

  * a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (read through
    its ``mesh_dim_names`` and sizes) or, for the rules alone, the
    device-free :class:`AbstractMesh` of :func:`make_abstract_mesh`;
  * :class:`PartitionSpec` is one entry per tensor dimension: ``None``, one
    mesh axis name, or a tuple of names, kept as the rules write them
    (``spec_for_axes`` unwraps a one-axis tuple and strips trailing
    ``None``; ``batch_pspecs`` and ``fleet_pspecs`` write both, as the
    reference does);
  * :class:`Sharding` (the ``NamedSharding``) pairs a mesh and a spec, and
    gives the DTensor placements, one per mesh dimension;
  * abstract leaves (``ShapeDtypeStruct``) are ``meta``-device tensors, and
    :func:`device_put` places a tree as DTensors.

Trees are walked by ``core.fleet.tree_map``: dicts, lists, tuples, tensors
and the GP dataclasses (a ``GPFleet``, a stacked ``AdditiveGP``), every
tensor tenant-first.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core.fleet import tree_map

__all__ = ["AbstractMesh", "PartitionSpec", "Sharding", "make_abstract_mesh",
           "mesh_axis_names", "mesh_shape", "spec_for_axes", "shardings_for",
           "batch_pspecs", "cache_pspecs", "fleet_pspecs", "device_put"]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Device-free mesh description: axis names and their sizes."""

    axis_names: tuple
    axis_sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def make_abstract_mesh(shape: tuple, names: tuple) -> AbstractMesh:
    """The rules' mesh without devices or a process group."""
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} differ in "
                         "length")
    return AbstractMesh(tuple(names), tuple(int(s) for s in shape))


def mesh_axis_names(mesh) -> tuple:
    """Axis names of an ``AbstractMesh`` or a named ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    if mesh.mesh_dim_names is None:
        raise ValueError("the sharding rules need a DeviceMesh with "
                         "mesh_dim_names")
    return tuple(mesh.mesh_dim_names)


def mesh_shape(mesh) -> dict:
    """Axis name -> size of an ``AbstractMesh`` or a named ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh_axis_names(mesh), mesh.shape))


class PartitionSpec(tuple):
    """Per tensor dimension: ``None`` (replicated), a mesh axis name, or a
    tuple of axis names (split over all of them, the first outermost)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "PartitionSpec" + tuple.__repr__(self)


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A tensor laid out over ``mesh`` as ``spec`` says."""

    mesh: object
    spec: PartitionSpec

    def placements(self) -> tuple:
        """DTensor placements, one per mesh dimension: ``Shard(d)`` where
        the spec names that mesh axis for tensor dim ``d``, else
        ``Replicate()``. A dim split over several mesh axes shards in
        mesh-dimension order, which is JAX's row-major order when the
        spec's tuple follows the mesh; another order raises
        ``ValueError``."""
        from torch.distributed.tensor import Replicate, Shard

        names = mesh_axis_names(self.mesh)
        dims: dict = {}
        for d, entry in enumerate(self.spec):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            unknown = [a for a in axes if a not in names]
            if unknown:
                raise ValueError(f"spec {self.spec} names axes {unknown} not "
                                 f"in the mesh {names}")
            pos = [names.index(a) for a in axes]
            if pos != sorted(pos):
                raise ValueError(f"spec entry {entry} splits dim {d} in "
                                 f"another order than the mesh {names}")
            for p in pos:
                if p in dims:
                    raise ValueError(f"spec {self.spec} uses mesh axis "
                                     f"{names[p]!r} twice")
                dims[p] = d
        return tuple(Shard(dims[i]) if i in dims else Replicate()
                     for i in range(len(names)))


def _data_axes(mesh) -> tuple:
    names = mesh_axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _rules(mesh, mode: str = "train") -> dict[str, tuple]:
    names = set(mesh_axis_names(mesh))
    data_axes = _data_axes(mesh)
    model = ("model",) if "model" in names else ()
    return {
        "batch": (data_axes,),
        "tenant": (data_axes,),
        "ctx": (data_axes,),
        # decode mode: NO FSDP - params replicated over data (TP only), so
        # no per-token weight all-gathers
        "embed": (("data",),) if ("data" in names and mode == "train") else (),
        "heads": (model,),
        "kv_heads": (model,),
        "mlp": (model,),
        "vocab": (model,),
        "experts": (model,),
        "state": (),
        "layers": (),
        "conv": (),
    }


def _axes_size(mesh, axes: tuple) -> int:
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in axes)


def spec_for_axes(axes: tuple, shape: tuple, mesh,
                  mode: str = "train") -> PartitionSpec:
    """PartitionSpec for one tensor given its logical axes + shape."""
    rules = _rules(mesh, mode)
    used: set = set()
    entries = []
    for name, dim in zip(axes, shape):
        assigned = None
        for cand in rules.get(name, ()) if name else ():
            if not cand:
                continue
            if any(a in used for a in cand):
                continue
            if dim % _axes_size(mesh, cand) != 0:
                continue
            assigned = cand if len(cand) > 1 else cand[0]
            used.update(cand)
            break
        entries.append(assigned)
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def shardings_for(axes_tree, abstract_tree, mesh, mode: str = "train"):
    """Shardings for a tree of abstract tensors (``meta`` tensors, or any
    with a shape) and the matching tree of logical-axes tuples."""

    def one(ab, axes):
        return Sharding(mesh, spec_for_axes(axes, tuple(ab.shape), mesh,
                                            mode))

    return tree_map(one, abstract_tree, axes_tree)


def batch_pspecs(batch_tree, mesh):
    """Shard input batches: dim 0 = batch over (pod, data) when divisible."""
    data_axes = _data_axes(mesh)
    dp = _axes_size(mesh, data_axes)

    def one(ab):
        if ab.ndim == 0 or ab.shape[0] % dp != 0:
            return Sharding(mesh, P())
        return Sharding(mesh, P(data_axes, *([None] * (ab.ndim - 1))))

    return tree_map(one, batch_tree)


def fleet_pspecs(fleet_tree, mesh, T: int | None = None):
    """Shard a stacked tenant fleet: leading ``tenant`` axis over (pod, data).

    ``fleet_tree`` is a tree of tensors (abstract or not) whose leaves all
    carry the tenant axis first: a ``GPFleet`` or its stacked
    ``AdditiveGP`` (walked by ``core.fleet.tree_map``, which views each
    block-CR factor tenant-first), or the per-lane data and query batches
    ``(T, ...)`` in dicts, lists and tuples. Tenants never exchange data
    (each lane is an independent posterior), so the tenant axis behaves
    exactly like a data batch: it maps to the combined (pod, data) axes when
    divisible and falls back to replication otherwise (a 6-tenant group on
    an 8-way data axis stays replicated rather than erroring).

    Pass ``T`` to pin the tenant-axis length: leaves whose dim 0 differs
    (per-tenant metadata of another length) are replicated instead of
    mis-sharded.
    """
    data_axes = _data_axes(mesh)
    dp = _axes_size(mesh, data_axes)

    def one(ab):
        shape = tuple(getattr(ab, "shape", ()))
        if (not data_axes or len(shape) == 0 or shape[0] % dp != 0
                or (T is not None and shape[0] != T)):
            return Sharding(mesh, P())
        lead = data_axes if len(data_axes) > 1 else data_axes[0]
        return Sharding(mesh, P(lead, *([None] * (len(shape) - 1))))

    return tree_map(one, fleet_tree)


# -- decode-cache sharding ---------------------------------------------------
# Cache leaves are identified by key name. batch dim -> data axes; if batch
# is unshardable (e.g. batch=1) the context/sequence dim takes the data axes
# instead; kv-head-like dims -> model.

_KV_KEYS = {"k", "v", "attn_k", "attn_v", "xk", "xv"}


def _map_with_key(fn, tree, key=None):
    """``fn(key, leaf)`` over a tree of dicts, lists and tuples, ``key`` the
    leaf's own dict key (its index, as a string, in a sequence)."""
    if isinstance(tree, dict):
        return {k: _map_with_key(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_key(fn, v, f"[{i}]")
                          for i, v in enumerate(tree))
    return fn(key, tree)


def cache_pspecs(cache_tree, mesh, batch: int):
    data_axes = _data_axes(mesh)
    dp = _axes_size(mesh, data_axes)
    mp = mesh_shape(mesh).get("model", 1)
    batch_ok = batch % dp == 0

    def unwrap(e):
        # a one-axis tuple is the bare name, as spec_for_axes writes it
        return e[0] if isinstance(e, tuple) and len(e) == 1 else e

    def kv_spec(ab):
        # (L|G, B, T, Kv, hd)
        _, B, T, Kv, hd = ab.shape
        ent = [None, None, None, None, None]
        if batch_ok:
            ent[1] = data_axes
        elif T % dp == 0:
            ent[2] = data_axes
        if Kv % mp == 0:
            ent[3] = "model"
        elif ent[2] is None and T % mp == 0:
            # GQA kv-heads < model axis: shard the SEQUENCE over model
            # (flash-decoding style: the softmax stats' all-reduce is tiny,
            # against all-gathering the whole cache when hd is sharded)
            ent[2] = "model"
        elif ent[2] is not None and T % (dp * mp) == 0:
            ent[2] = tuple(data_axes) + ("model",)  # batch=1 long-context
        elif hd % mp == 0:
            ent[4] = "model"
        return P(*map(unwrap, ent))

    def state_spec(ab):
        # recurrent states: the batch dim is the first dim of size `batch`
        ent = [None] * ab.ndim
        placed_data = False
        placed_model = False
        for i, s in enumerate(ab.shape):
            if not placed_data and batch_ok and s == batch:
                ent[i] = data_axes
                placed_data = True
            elif placed_data and not placed_model and s % mp == 0 and s > 1:
                ent[i] = "model"
                placed_model = True
        return P(*ent)

    def one(key, ab):
        if key in _KV_KEYS:
            return Sharding(mesh, kv_spec(ab))
        if key == "kpos":
            return Sharding(mesh, P())
        return Sharding(mesh, state_spec(ab))

    return _map_with_key(one, cache_tree)


def device_put(tree, shardings):
    """Place a tree of tensors on its mesh as DTensors (``jax.device_put``
    over a pytree): ``shardings`` is one :class:`Sharding` for every leaf
    or a tree of them of the same structure. Each tensor moves to the
    mesh's device type first; rank 0 of the mesh is the source of the
    values (``distribute_tensor``), so every rank of the mesh calls this
    with the same tree."""
    from torch.distributed.tensor import distribute_tensor

    def one(x, sh):
        if isinstance(sh.mesh, AbstractMesh):
            raise ValueError("device_put needs a DeviceMesh, not an "
                             "AbstractMesh")
        return distribute_tensor(x.to(sh.mesh.device_type), sh.mesh,
                                 sh.placements())

    if isinstance(shardings, Sharding):
        return tree_map(lambda x: one(x, shardings), tree)
    return tree_map(one, tree, shardings)
