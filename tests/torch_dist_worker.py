"""One rank of ``tests/test_torch_distributed.py``'s gloo world.

    python tests/torch_dist_worker.py RANK WORLD STORE_FILE CKPT_DIR

Every rank checks every case itself and prints ``rank R: ok``; a failed
check raises (a non-zero exit). Imports the port only.
"""
from __future__ import annotations

import functools
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.checkpoint import Checkpointer
from repro_torch.core import GPConfig, fit
from repro_torch.core import fleet as fl
from repro_torch.data import ShardedBatches, token_stream
from repro_torch.distributed.elastic import elastic_mesh, reshard_tree
from repro_torch.distributed.sharding import (PartitionSpec, batch_pspecs,
                                              device_put, fleet_pspecs,
                                              mesh_shape)

CAP, D, M = 64, 2, 8
CFG = GPConfig()  # pcg, fused whole, no preconditioner at these sizes


def _data(T, seed):
    """T tenants of 40-60 points in capacity 64, D = 2, and 8 queries each."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.0, 1.0, (T, CAP, D))
    Y = np.sin(6.0 * X).sum(-1) + 0.1 * rng.standard_normal((T, CAP))
    return {"X": torch.as_tensor(X), "Y": torch.as_tensor(Y),
            "omega": torch.as_tensor(rng.uniform(2.0, 4.0, (T, D))),
            "sigma": torch.as_tensor(rng.uniform(0.3, 0.6, T)),
            "counts": torch.as_tensor(np.linspace(40, 60, T).astype(np.int64)),
            "Xq": torch.as_tensor(rng.uniform(0.0, 1.0, (T, M, D)))}


@functools.lru_cache(maxsize=None)
def _case(T, seed):
    """The tenants' data, the fleet of their own fits and its queries."""
    d = _data(T, seed)
    gps = [fit(CFG, d["X"][t, :c], d["Y"][t, :c], d["omega"][t],
               d["sigma"][t], capacity=CAP, device="cpu")
           for t, c in enumerate(d["counts"].tolist())]
    fleet = fl.stack_gps(gps)
    return d, fleet, (fl.fleet_posterior_mean(fleet, d["Xq"], device="cpu"),
                      fl.fleet_posterior_var(fleet, d["Xq"], device="cpu"))


def _gathered(local, like):
    """All ranks' (lanes, ...) results as the global tensor, laid out as
    the DTensor ``like``."""
    return DTensor.from_local(local, like.device_mesh,
                              like.placements).full_tensor()


def _same(tag, got, want):
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{tag}: placed fleet's queries differ")


def placed_fleet(mesh, rank, lane):
    """Place the T = 4 tenants' data by fleet_pspecs; this rank fits and
    queries its one lane; the gathered mean and variance equal the
    unsharded fleet's bit for bit."""
    d, _, want = _case(4, 0)
    placed = device_put(d, fleet_pspecs(d, mesh, T=4))
    loc = {k: v.to_local() for k, v in placed.items()}
    assert loc["X"].shape == (1, CAP, D)
    assert torch.equal(loc["X"], d["X"][lane:lane + 1]), "lane order"
    c = int(loc["counts"][0])
    mine = fl.fleet_fit(CFG, loc["X"][:, :c], loc["Y"][:, :c], loc["omega"],
                        loc["sigma"], CAP, device="cpu")
    got = [_gathered(q(mine, loc["Xq"], device="cpu"), placed["Xq"])
           for q in (fl.fleet_posterior_mean, fl.fleet_posterior_var)]
    _same(f"mesh {mesh_shape(mesh)}", got, want)


def fallbacks(mesh):
    """T = 6 on the 4-way axis replicates; a T-pinned leaf of another
    length stays replicated."""
    d6 = _data(6, 1)
    sh = fleet_pspecs(d6, mesh)
    assert all(s.spec == PartitionSpec() for s in sh.values())
    placed = device_put(d6, sh)
    assert all(torch.equal(placed[k].to_local(), d6[k]) for k in d6)
    assert all(p == Replicate() for p in placed["X"].placements)
    tree = {"band": torch.zeros(4, 3, 5), "meta": torch.zeros(8, 3)}
    sh = fleet_pspecs(tree, mesh, T=4)
    assert sh["band"].spec == PartitionSpec("data", None, None)
    assert sh["meta"].spec == PartitionSpec()
    placed = device_put(tree, sh)
    assert placed["band"].to_local().shape == (1, 3, 5)
    assert placed["meta"].to_local().shape == (8, 3)


def sharded_batches(mesh, rank):
    """Rank r holds rows 2r, 2r + 1 of each global batch of 8."""
    ab = {k: torch.empty((8, 16), dtype=torch.int32, device="meta")
          for k in ("tokens", "labels")}
    it = ShardedBatches(50, 16, 8, seed=5, sharding=batch_pspecs(ab, mesh),
                        device="cpu")
    ref = token_stream(50, 16, 8, 5)
    for _ in range(2):
        b = next(it)
        toks, labels = next(ref)
        rows = slice(2 * rank, 2 * rank + 2)
        assert np.array_equal(b["tokens"].to_local().numpy(), toks[rows])
        assert np.array_equal(b["labels"].to_local().numpy(), labels[rows])


def elastic_restore(rank, ckpt):
    """Rank 3 is lost: the (3, 1) mesh over ranks 0-2 takes a checkpoint of
    the T = 6 fleet through reshard_tree (two lanes a rank), and the
    gathered queries equal the unsharded fleet's bit for bit."""
    d6, fleet6, want = _case(6, 1)
    if rank == 0:
        Checkpointer(ckpt, keep=1).save(7, fleet6, blocking=True)
    dist.barrier()
    # the model axis degrades to what the survivors hold
    assert mesh_shape(elastic_mesh(model=4, ranks=[0, 1, 2],
                                   device_type="cpu")) == {"data": 1,
                                                           "model": 2}
    mesh3 = elastic_mesh(model=1, ranks=[0, 1, 2], device_type="cpu")
    assert mesh_shape(mesh3) == {"data": 3, "model": 1}
    if rank == 3:
        assert mesh3.get_coordinate() is None
        return
    restored, step = Checkpointer(ckpt).restore(fleet6)
    assert step == 7
    axes = fl.tree_map(lambda a: ("tenant",) + (None,) * (a.ndim - 1),
                       restored)
    placed = reshard_tree(restored, axes, mesh3)
    local = fl.tree_map(lambda t: t.to_local(), placed)
    assert isinstance(local, fl.GPFleet) and local.T == 2
    xq = device_put(d6["Xq"], fleet_pspecs(d6["Xq"], mesh3, T=6))
    got = [_gathered(q(local, xq.to_local(), device="cpu"), xq)
           for q in (fl.fleet_posterior_mean, fl.fleet_posterior_var)]
    _same("elastic (3, 1) mesh", got, want)


def main(rank, world, store, ckpt):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh4 = elastic_mesh(model=1, device_type="cpu")
        assert mesh_shape(mesh4) == {"data": 4, "model": 1}
        placed_fleet(mesh4, rank, lane=rank)
        from torch.distributed.device_mesh import DeviceMesh

        pod = DeviceMesh("cpu", torch.arange(4).reshape(2, 2, 1),
                         mesh_dim_names=("pod", "data", "model"))
        placed_fleet(pod, rank, lane=rank)  # pod-major: lane t on rank t
        fallbacks(mesh4)
        sharded_batches(mesh4, rank)
        elastic_restore(rank, ckpt)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(f"rank {rank}: ok", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
