"""The port stands alone and refuses what it cannot do.

* ``repro_torch`` and ``chip_smoke.py`` import neither JAX nor the JAX
  package: every module imports in a subprocess where ``jax`` is blocked,
  and a scan of their sources finds no such import.
* Device rule: the entry points run on CUDA unless told ``device="cpu"``,
  and raise without a GPU; ``backend="cuda"`` on CPU tensors raises.
* The configurations that once raised ``NotImplementedError`` (the
  pivoted LU route, pcg with ``fused="on"``, kmg, q = 3 on CUDA, fused,
  the streaming branch of ``bayes_opt_loop``) resolve as the reference
  resolves them, or run: the port refuses no configuration the reference
  takes.
"""
from __future__ import annotations

import dataclasses
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import GPConfig, fit, posterior_mean, posterior_var
from repro_torch.core.additive_gp import resolve_config
from repro_torch.core.bayesopt import BOConfig, bayes_opt_loop
from repro_torch.kernels import _build, ops
from repro_torch.kernels.banded_lu import banded_lu

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
_FORBIDDEN = re.compile(r"^\s*(?:from|import)\s+(?:jax|repro)(?:\.|\s|$)",
                        re.MULTILINE)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_every_module_imports_without_jax():
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"for name in {_modules()!r}:\n"
            "    importlib.import_module(name)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    assert len(_modules()) >= 23
    assert {"repro_torch.precond", "repro_torch.precond.coarse",
            "repro_torch.precond.vcycle", "repro_torch.kernels.kp_gram",
            "repro_torch.core.gband_update", "repro_torch.streaming",
            "repro_torch.streaming.updates",
            "repro_torch.streaming.gp_engine", "repro_torch.core.fleet",
            "repro_torch.streaming.fleet_engine",
            "repro_torch.health.ladder", "repro_torch.health.inject",
            "repro_torch.checkpoint.checkpointer",
            "repro_torch.distributed", "repro_torch.distributed.sharding",
            "repro_torch.distributed.elastic", "repro_torch.launch.mesh",
            "repro_torch.data.pipeline", "repro_torch.serving",
            "repro_torch.serving.engine"} <= set(_modules())


def test_sources_name_no_jax_or_reference_import():
    files = sorted(PKG.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "scripts" / "single_bits.py",
        ROOT / "scripts" / "fleet_profile.py",
        ROOT / "scripts" / "lane_gap.py",
        ROOT / "examples" / "bayesopt_schwefel_torch.py",
        ROOT / "tests" / "torch_dist_worker.py"]
    offenders = [str(f) for f in files if _FORBIDDEN.search(f.read_text())]
    assert offenders == []


def _tiny():
    rng = np.random.default_rng(0)
    return rng.uniform(0, 1, (20, 2)), rng.standard_normal(20), np.ones(2)


def test_fleet_fit_without_device_needs_a_gpu(monkeypatch):
    from repro_torch.core.fleet import fleet_fit

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, Y, om = _tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fleet_fit(GPConfig(precond="none"), np.stack([X, X]),
                  np.stack([Y, Y]), om, 1.0, 32)


def test_fit_without_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, Y, om = _tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit(GPConfig(precond="none"), X, Y, om, 1.0)
    gp = fit(GPConfig(precond="none", solver_iters=5), X, Y, om, 1.0,
             device="cpu")
    with pytest.raises(RuntimeError):
        posterior_mean(gp, X[:3])
    with pytest.raises(RuntimeError):
        posterior_var(gp, X[:3])


class _Stub:
    vocab = 5

    def init_cache(self, B, ctx):
        return {}

    def decode_step(self, params, cache, tokens, pos, par):
        nxt = (tokens[:, 0].long() + 1) % self.vocab
        return torch.nn.functional.one_hot(nxt, self.vocab)[:, None], cache


def test_substrate_defaults_need_a_gpu(monkeypatch, tmp_path):
    """elastic_mesh, ShardedBatches and ServeEngine run on CUDA unless told
    "cpu", and raise without a GPU."""
    import torch.distributed as dist

    from repro_torch.data import ShardedBatches
    from repro_torch.distributed.elastic import elastic_mesh
    from repro_torch.distributed.sharding import mesh_shape
    from repro_torch.serving.engine import Request, ServeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedBatches(10, 4, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(_Stub(), {}, None, batch_slots=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        elastic_mesh(model=1, ranks=[0])
    b = next(ShardedBatches(10, 4, 2, device="cpu"))
    assert b["tokens"].device.type == "cpu" and b["tokens"].shape == (2, 4)
    eng = ServeEngine(_Stub(), {}, None, batch_slots=2, eos_id=-1,
                      device="cpu")
    eng.submit(Request(rid=0, prompt=[1], max_new=2))
    assert [r.out for r in eng.run_until_done()] == [[2, 3]]
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = elastic_mesh(model=1, device_type="cpu")
        assert mesh.device_type == "cpu"
        assert mesh_shape(mesh) == {"data": 1, "model": 1}
    finally:
        dist.destroy_process_group()


def test_cuda_backend_on_cpu_tensors_raises():
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.resolve_backend("cuda", "cpu")
    band = torch.ones((1, 4, 1), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        banded_lu(band, torch.ones((1, 4, 1), dtype=torch.float64), 0, 0,
                  backend="cuda")
    X, Y, om = _tiny()
    with pytest.raises(ValueError, match="CUDA tensors"):
        fit(GPConfig(backend="cuda", precond="none"), X, Y, om, 1.0,
            device="cpu")


def _case(i, cfg, n, device, resolves_to):
    return pytest.param(cfg, n, device, resolves_to, id=f"cfg{i}-{n}-{device}")


@pytest.mark.parametrize("cfg,n,device,resolves_to", [
    # ported since: the pivoted LU route (the gbsv scan) from each solver,
    # unfused under solve_alg="lu"; the per-iteration pcg kernel; kmg
    _case(0, GPConfig(solver="jacobi", pivot=True, solve_alg="lu", q=1,
                      precond="none"), 20, "cpu",
          dict(fused="off", precond="none")),
    _case(1, GPConfig(solver="gauss_seidel", pivot=True, solve_alg="lu", q=1,
                      precond="none"), 20, "cpu",
          dict(fused="off", precond="none")),
    _case(2, GPConfig(fused="on", precond="none"), 20, "cpu",
          dict(fused="on", precond="none")),
    _case(3, GPConfig(fused="on", q=1, precond="none"), 20, "cpu",
          dict(fused="on", precond="none")),
    _case(4, GPConfig(pivot=True, solve_alg="lu", precond="none"), 20, "cpu",
          dict(fused="off", precond="none")),
    _case(5, GPConfig(precond="kmg"), 20, "cpu",
          dict(fused="off", precond="kmg")),
    # "auto" resolves to kmg at q = 0, n >= 4096
    _case(6, GPConfig(), 4096, "cpu", dict(fused="off", precond="kmg")),
    # q = 3: the fused kernels take its half-width-4 bands, so "auto" runs
    # the whole-solve kernel, as at q <= 2 (and as the reference's "auto"
    # at this size)
    _case(7, GPConfig(q=3, precond="none"), 20, "cuda",
          dict(fused="whole", precond="none")),
    # bayes_opt_loop's streaming branch (the reference's default BOConfig),
    # ported since: it runs
    _case(8, BOConfig(), 20, "cpu", {}),
    _case(9, BOConfig(incremental=True, use_engine=False), 20, "cpu", {}),
    _case(10, BOConfig(incremental=False, use_engine=True), 20, "cpu", {}),
])
def test_unported_paths_raise(cfg, n, device, resolves_to):
    """(Named from when some paths raised.) Every case, each once
    unported, resolves as the reference resolves it, or runs."""
    if isinstance(cfg, BOConfig):
        gp, X, _, _ = bayes_opt_loop(
            lambda x: float(np.sum(x)), np.array([[0., 1.]]), 1,
            GPConfig(precond="none", solver_iters=8),
            dataclasses.replace(cfg, ascent_steps=2, n_starts=4), torch.Generator(),
            n_init=n, device=device)
        assert X.shape == (n + 1, 1) and gp.num_points() == n + 1
        return
    got = resolve_config(cfg, n, device)
    assert {k: getattr(got, k) for k in resolves_to} == resolves_to


def test_plain_path_launches_no_kernel():
    _build.reset_launch_counts()
    X, Y, om = _tiny()
    gp = fit(GPConfig(precond="none", solver_iters=5), X, Y, om, 1.0,
             device="cpu")
    posterior_var(gp, X[:3], device="cpu")
    assert set(_build.launch_counts()) == set(_build.KERNELS)
    assert all(v == 0 for v in _build.launch_counts().values())
