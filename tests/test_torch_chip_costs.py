"""The bounds that ``chip_smoke.py`` reports for the whole-solve kernels.

A bound counts each state array's bytes once per solve only where one
(D, npad, B) state array fits the card's L2, so the iterations can keep the
state on chip. Above the L2 (77 MB at the main path's n = 30000, D = 10,
B = 32) every sweep or iteration streams it again, and the bound grows with
the iteration count. The script's top level imports only numpy and torch, so
its cost functions run here on the CPU.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(cs)

MAIN = (10, 30000, 32)  # D, npad, B of the main path's variance chunk
Q1 = (10, 4000, 16)  # the kernel phase's q = 1 shape (5 MB a state)


def _state_bytes(D, npad, B):
    return 8 * D * npad * B


def _gs(shape, iters):
    return cs._sweep_cost(*shape, 0, 1, iters, cs.GS_STATES, cs.GS_SWEPT,
                          cs.GS_ELEM, cs.GS_K_FINAL)


def _jacobi(shape, iters):
    return cs._sweep_cost(*shape, 0, 1, iters, 4, cs.JACOBI_SWEPT,
                          cs.JACOBI_ELEM + cs.JACOBI_K_ELEM, warm=True)


def _pcg(shape, iters):
    return cs._mega_cost(*shape, 1, 0, 1, iters)


def test_shapes_straddle_the_l2():
    assert _state_bytes(*MAIN) > cs.L2_BYTES > _state_bytes(*Q1)


@pytest.mark.parametrize("cost,per_iter", [
    (_gs, cs.GS_SWEPT), (_jacobi, cs.JACOBI_SWEPT), (_pcg, cs.PCG_SWEPT)])
def test_main_shape_bytes_grow_per_iteration(cost, per_iter):
    """Above the L2, each further sweep or iteration adds its state passes:
    the bytes are linear in the iteration count with that slope."""
    b1, b2, b40 = (cost(MAIN, i)[0] for i in (1, 2, 40))
    step = per_iter * _state_bytes(*MAIN)
    assert b2 - b1 == step
    assert b40 - b1 == 39 * step


@pytest.mark.parametrize("cost", [_gs, _jacobi, _pcg])
def test_q1_shape_counts_state_once(cost):
    """Below the L2, the state bytes do not depend on the iteration count;
    the flops still do."""
    (b1, o1), (b40, o40) = (cost(Q1, i) for i in (1, 40))
    assert b1 == b40 and o40 > o1


def test_one_sweep_unchanged():
    """One sweep moves its inputs and outputs once, at any shape: the
    Gauss-Seidel sweep with k reads v and x0 and writes x and k."""
    D, npad, B = MAIN
    nbytes, _ = _gs(MAIN, 1)
    assert nbytes == (8 * D * npad * (0 + 2 + 2) + 4 * 2 * D * npad
                      + 4 * _state_bytes(*MAIN) + 8)


def test_whole_solve_bounds_at_main_shape():
    """The main path's 40-sweep Gauss-Seidel solve: 3 state passes a later
    sweep (x read and written, v read), 121 in all, 9.3 GB at 3.35 TB/s;
    the old count of 4 passes read 0.1855 ms."""
    nbytes, ops = _gs(MAIN, 40)
    assert nbytes // _state_bytes(*MAIN) == 4 + 39 * 3
    ms, by = cs._bound(nbytes, ops)
    assert by == "bytes" and 2.7 < ms < 2.9
    assert 4.4 < cs._bound(*_jacobi(MAIN, 40))[0] < 4.7
    assert 5.3 < cs._bound(*_pcg(MAIN, 40))[0] < 5.6
