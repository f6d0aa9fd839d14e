"""The port's substrate (``repro_torch.distributed``, ``launch.mesh``,
``data.pipeline`` / ``token_stream``, ``serving.engine``) against the JAX
package's on the CPU.

* Every sharding case of ``tests/test_distributed.py`` and the
  ``largest_data_axis`` case of ``tests/test_substrate.py`` run through
  both packages on the same abstract meshes; the specs agree entry for
  entry (a one-axis tuple read as its bare name, as the reference's own
  ``cache_pspecs`` canonicalises it).
* ``ShardedBatches`` batches 0-5 and a ``start_step=3`` resume equal the
  reference's bit for bit.
* The greedy ``ServeEngine`` gives the reference's outputs and tick count
  on the same stub model; at a temperature the same seed gives the same
  outputs (the draws are torch's, not ``jax.random``'s).
* ``fleet_pspecs`` over a fitted port fleet shards every leaf tenant-first,
  the block-CR factors too; ``Sharding.placements`` maps specs to DTensor
  placements.
* ``examples/bayesopt_schwefel_torch.py`` runs at ``--budget 2 --dim 2``.

The multi-rank placements (gloo, spawned ranks) are
``tests/test_torch_distributed.py``.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.distributed.elastic as jelastic
import repro.distributed.sharding as jsh
import repro.launch.mesh as jmesh
from repro.data import ShardedBatches as JaxBatches
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServeEngine as JaxEngine
import repro_torch.distributed.elastic as telastic
import repro_torch.distributed.sharding as tsh
import repro_torch.launch.mesh as tmesh
from repro_torch.core import GPConfig
from repro_torch.core import fleet as tfleet
from repro_torch.data import ShardedBatches, token_stream
from repro_torch.serving.engine import Request, ServeEngine

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


class _Lib:
    """One package's sharding entry points, meshes and abstract leaves."""

    def __init__(self, sh, mesh_mod, elastic, leaf):
        self.sh, self.elastic, self.leaf = sh, elastic, leaf
        self.data_axes_for = mesh_mod.data_axes_for
        self.MESH = sh.make_abstract_mesh((16, 16), ("data", "model"))
        self.MESH3 = sh.make_abstract_mesh((2, 16, 16),
                                           ("pod", "data", "model"))


JAX = _Lib(jsh, jmesh, jelastic,
           lambda shape, dt: jax.ShapeDtypeStruct(shape, jnp.dtype(dt)))
TORCH = _Lib(tsh, tmesh, telastic,
             lambda shape, dt: torch.empty(shape, dtype=getattr(torch, dt),
                                           device="meta"))


def _spec_basic(L):
    s = L.sh.spec_for_axes
    return [s(("embed", "mlp"), (64, 128), L.MESH),
            s(("heads", None), (15, 7), L.MESH)]


def _spec_conflict(L):
    s = L.sh.spec_for_axes
    return [s(("layers", "experts", "embed", "mlp"), (48, 64, 2048, 1408),
              L.MESH),
            s(("layers", "experts", "embed", "mlp"), (56, 8, 6144, 16384),
              L.MESH)]


def _spec_no_reuse(L):
    return [L.sh.spec_for_axes(("embed", "embed"), (64, 64), L.MESH)]


def _multi_pod_batch(L):
    return [L.sh.batch_pspecs({"tokens": L.leaf(s, "int32")},
                              L.MESH3)["tokens"].spec
            for s in ((256, 4096), (1, 1))]


def _cache_batch_vs_ctx(L):
    c = L.sh.cache_pspecs
    kv = L.leaf((48, 128, 32768, 8, 256), "bfloat16")
    kv1 = L.leaf((48, 1, 524288, 8, 256), "bfloat16")
    kv2 = L.leaf((6, 128, 32768, 32, 64), "bfloat16")
    return [c({"k": kv}, L.MESH, batch=128)["k"].spec,
            c({"k": kv1}, L.MESH, batch=1)["k"].spec,
            c({"attn_k": kv2}, L.MESH, batch=128)["attn_k"].spec]


def _cache_state(L):
    st = L.leaf((128, 64, 64, 64), "float32")
    return [L.sh.cache_pspecs({"ssm": st}, L.MESH, batch=128)["ssm"].spec]


def _tenant_rule(L):
    s = L.sh.spec_for_axes
    return [s(("tenant", None, None), (64, 10, 5), L.MESH),
            s(("tenant", None), (6, 10), L.MESH),
            s(("tenant", None), (64, 10), L.MESH3)]


def _fleet_stacked(L):
    tree = {"band": L.leaf((64, 2, 128, 3), "float64"),
            "Y": L.leaf((64, 128), "float64"),
            "n": L.leaf((64,), "int32")}
    sh = L.sh.fleet_pspecs(tree, L.MESH3, T=64)
    return [sh[k].spec for k in ("band", "Y", "n")]


def _fleet_fallbacks(L):
    six = {"band": L.leaf((6, 2, 128, 3), "float64")}
    pinned = {"band": L.leaf((64, 2, 128, 3), "float64"),
              "meta": L.leaf((16, 4), "float64")}
    sh = L.sh.fleet_pspecs(pinned, L.MESH, T=64)
    return [L.sh.fleet_pspecs(six, L.MESH)["band"].spec, sh["band"].spec,
            sh["meta"].spec]


def _data_axes(L):
    return [L.data_axes_for(L.MESH), L.data_axes_for(L.MESH3)]


def _largest_data_axis(L):
    return [L.elastic.largest_data_axis(256, 16),
            L.elastic.largest_data_axis(240, 16)]


def _canon(spec):
    """A spec's entries, a one-axis tuple read as its bare name."""
    if isinstance(spec, int):
        return spec
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


@pytest.mark.parametrize("case", [
    _spec_basic, _spec_conflict, _spec_no_reuse, _multi_pod_batch,
    _cache_batch_vs_ctx, _cache_state, _tenant_rule, _fleet_stacked,
    _fleet_fallbacks, _data_axes, _largest_data_axis],
    ids=lambda f: f.__name__.lstrip("_"))
def test_rules_match_reference(case):
    want, got = case(JAX), case(TORCH)
    assert [_canon(s) for s in got] == [_canon(s) for s in want]


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    M3 = TORCH.MESH3
    sh = tsh.Sharding(M3, tsh.PartitionSpec(("pod", "data"), None))
    assert sh.placements() == (Shard(0), Shard(0), Replicate())
    sh = tsh.Sharding(M3, tsh.PartitionSpec(None, "model"))
    assert sh.placements() == (Replicate(), Replicate(), Shard(1))
    with pytest.raises(ValueError, match="another order"):
        tsh.Sharding(M3, tsh.PartitionSpec(("data", "pod"))).placements()
    with pytest.raises(ValueError, match="not in the mesh"):
        tsh.Sharding(TORCH.MESH, tsh.PartitionSpec("pod")).placements()


def test_fleet_pspecs_walks_a_fitted_fleet_tenant_first():
    rng = np.random.default_rng(3)
    X = rng.uniform(0, 1, (4, 20, 2))
    Y = rng.standard_normal((4, 20))
    fleet = tfleet.fleet_fit(GPConfig(precond="none", solver_iters=5), X, Y,
                             np.ones(2), 1.0, 32, device="cpu")
    mesh = tsh.make_abstract_mesh((4, 1), ("data", "model"))
    specs = tsh.fleet_pspecs(fleet, mesh, T=4)
    assert isinstance(specs, tfleet.GPFleet)
    leaves, seen = [], []
    tfleet.tree_map(lambda a, s: leaves.append((a.shape, s.spec)), fleet,
                    specs)
    tfleet.tree_map(lambda a: seen.append(a.shape), fleet)
    assert len(leaves) == len(seen) > 20
    for shape, spec in leaves:
        assert shape[0] == 4 and spec == tsh.PartitionSpec(
            "data", *([None] * (len(shape) - 1)))
    # the block-CR factor is viewed (T, D, size), its batch kept
    f = specs.gp.ops.saphi_factor
    assert f.batch == (4, 2) and f.data.spec[0] == "data"
    assert specs.gp.config == fleet.gp.config


def test_token_stream_and_pipeline_match_reference():
    mine = ShardedBatches(100, 16, 4, seed=3, device="cpu")
    ref = JaxBatches(100, 16, 4, seed=3)
    got = [next(mine) for _ in range(6)]
    for a, b in zip(got, (next(ref) for _ in range(6))):
        for k in ("tokens", "labels"):
            assert a[k].dtype == torch.int32 and a[k].device.type == "cpu"
            assert np.array_equal(a[k].numpy(), np.asarray(b[k]))
    resumed = ShardedBatches(100, 16, 4, seed=3, start_step=3, device="cpu")
    b3 = next(resumed)
    assert resumed.step == 4
    assert all(torch.equal(b3[k], got[3][k]) for k in ("tokens", "labels"))
    toks, labels = next(token_stream(100, 16, 4, 3))
    assert np.array_equal(toks, got[0]["tokens"].numpy())
    assert np.array_equal(labels, got[0]["labels"].numpy())


class _JaxStub:
    """``tests/test_substrate.py``'s stub: greedy next = (token + 1) % V."""

    vocab = 17

    def init_cache(self, B, ctx):
        return {"pos": jnp.zeros((B,), jnp.int32)}

    def decode_step(self, params, cache, tokens, pos, par):
        nxt = (tokens[:, 0] + 1) % self.vocab
        return jax.nn.one_hot(nxt, self.vocab)[:, None, :] * 10.0, cache


class _TorchStub:
    vocab = 17

    def init_cache(self, B, ctx):
        return {"pos": torch.zeros((B,), dtype=torch.int32)}

    def decode_step(self, params, cache, tokens, pos, par):
        nxt = (tokens[:, 0].long() + 1) % self.vocab
        logits = torch.nn.functional.one_hot(nxt, self.vocab).double()
        return logits[:, None, :] * 10.0, cache


def _serve(engine_cls, req_cls, model, **kw):
    eng = engine_cls(model, params={}, par=None, batch_slots=4, ctx=64,
                     eos_id=-1, **kw)
    for rid in range(6):
        eng.submit(req_cls(rid=rid, prompt=[1 + rid, 2, 3], max_new=5))
    done = eng.run_until_done(max_ticks=200)
    return {r.rid: r.out for r in done}, eng.pos.copy()


def test_serve_engine_matches_reference():
    got, pos = _serve(ServeEngine, Request, _TorchStub(), device="cpu")
    want, jpos = _serve(JaxEngine, JaxRequest, _JaxStub())
    assert got == want and np.array_equal(pos, jpos)
    assert len(got) == 6 and all(out[:2] == [4, 5] for out in got.values())
    # sampled: one seed, one set of outputs; another seed, others
    runs = [_serve(ServeEngine, Request, _TorchStub(), device="cpu",
                   temperature=30.0, seed=s)[0] for s in (1, 1, 2)]
    assert runs[0] == runs[1] and runs[0] != runs[2]
    assert all(len(o) == 5 for o in runs[0].values())


def test_bayesopt_example_runs_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "bayesopt_schwefel_torch",
        ROOT / "examples" / "bayesopt_schwefel_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    gp, X, Y, hist = mod.main(["--budget", "2", "--dim", "2", "--device",
                               "cpu"])
    assert X.shape == (22, 2) and len(hist["best"]) == 2
    assert gp.device.type == "cpu"
    assert "best f =" in capsys.readouterr().out
