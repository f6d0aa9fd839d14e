"""Build, load and count the hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process for
``sm_90a`` (all started together), and the objects are linked into one
shared library with a plain C interface, loaded through ``ctypes``. The
build happens at first use, into ``build/repro_torch/`` at the repository
root (listed in ``.gitignore``), keyed by a hash of the sources and flags,
so a changed source never loads a stale library.

Each kernel wrapper adds one to its entry of the launch counts where it
launches its kernel, and nowhere else; ``reset_launch_counts`` and
``launch_counts`` let a caller show which kernels a run went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["load_library", "build_library", "check", "expect",
           "stream_handle", "count_launch", "launch_counts",
           "reset_launch_counts", "KERNELS"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("banded_lu.cu", "band_matmul.cu", "rgf.cu", "mega_pcg.cu",
           "banded_matvec.cu", "block_cr.cu", "jacobi.cu", "gauss_seidel.cu",
           "kp_gram.cu", "banded_lu_pivot.cu")
HEADERS = ("common.cuh", "cr.cuh", "sweep.cuh")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the backfitting kernels' wide instantiations (half-width 4, q = 3) count
# apart, under the name + "_w4"; the block CR's (half-width 6-8, the
# streaming Woodbury patch solves at q = 2, 3) under the name + "_wide";
# the backfitting kernels' launches over a fleet's T > 1 systems under the
# name + "_fleet" (+ "_w4")
KERNELS = ("banded_lu", "band_matmul", "rgf_blocks", "mega_pcg",
           "banded_matvec", "cr_apply", "fused_jacobi_iter",
           "fused_gauss_seidel_iter", "mega_jacobi", "mega_gauss_seidel",
           "fused_pcg_iter", "kp_gram", "cr_factor", "mega_pcg_w4",
           "fused_pcg_iter_w4", "fused_jacobi_iter_w4",
           "fused_gauss_seidel_iter_w4", "mega_jacobi_w4",
           "mega_gauss_seidel_w4", "cr_factor_wide", "cr_apply_wide",
           "mega_pcg_fleet", "fused_pcg_iter_fleet", "mega_pcg_fleet_w4",
           "fused_pcg_iter_fleet_w4", "mega_jacobi_fleet",
           "fused_jacobi_iter_fleet", "mega_jacobi_fleet_w4",
           "fused_jacobi_iter_fleet_w4", "mega_gauss_seidel_fleet",
           "fused_gauss_seidel_iter_fleet", "mega_gauss_seidel_fleet_w4",
           "fused_gauss_seidel_iter_fleet_w4", "banded_lu_pivot")

_c_int, _c_ll, _c_dbl, _ptr = (ctypes.c_int, ctypes.c_longlong,
                                ctypes.c_double, ctypes.c_void_p)
# C entry points: name -> (restype, argtypes); pointers and the stream are
# c_void_p so ctypes never truncates them to 32 bits
_SIGNATURES = {
    "repro_banded_lu_f64": (_c_int, [_ptr] * 7 + [_c_int] * 5 + [_ptr]),
    "repro_banded_lu_pivot_f64": (_c_int, [_ptr] * 6 + [_c_int] * 5 + [_ptr]),
    "repro_band_matmul_f64": (_c_int, [_ptr, _ptr, _ptr, _c_int, _c_int,
                                       _c_int, _c_int, _c_int, _c_int, _ptr]),
    "repro_rgf_workspace": (_c_ll, [_c_int] * 3),
    "repro_rgf_blocks_f64": (_c_int, [_ptr] * 7 + [_c_int] * 3 + [_ptr]),
    "repro_mega_pcg_workspace": (_c_ll, [_c_int] * 6),
    "repro_mega_pcg_cols": (_c_int, [_c_int] * 5),
    "repro_mega_pcg_f64": (_c_int, [_ptr] * 16 + [_c_int] * 9
                           + [_c_dbl, _c_int, _c_int, _ptr]),
    "repro_jacobi_workspace": (_c_ll, [_c_int] * 4),
    "repro_jacobi_grid": (_c_int, [_c_int] * 2),
    "repro_jacobi_cols": (_c_int, [_c_int] * 5),
    "repro_jacobi_f64": (_c_int, [_ptr] * 13 + [_c_int] * 8
                         + [_c_dbl, _c_int, _c_int, _ptr]),
    "repro_gauss_seidel_workspace": (_c_ll, [_c_int] * 4),
    "repro_gauss_seidel_grid": (_c_int, [_c_int] * 2),
    "repro_gauss_seidel_cols": (_c_int, [_c_int] * 4),
    "repro_gauss_seidel_f64": (_c_int, [_ptr] * 11 + [_c_int] * 9 + [_ptr]),
    "repro_banded_matvec_f64": (_c_int, [_ptr, _ptr, _ptr, _c_int, _c_int,
                                         _c_int, _c_int, _c_int, _ptr]),
    "repro_cr_factor_f64": (_c_int, [_ptr] * 3 + [_c_int] * 4 + [_ptr]),
    "repro_cr_apply_cols": (_c_int, [_c_int] * 2),
    "repro_cr_apply_f64": (_c_int, [_ptr] * 2 + [_c_int] * 6 + [_ptr]),
    "repro_cr_factor_wide_f64": (_c_int, [_ptr] * 3 + [_c_int] * 4 + [_ptr]),
    "repro_cr_apply_wide_f64": (_c_int, [_ptr] * 2 + [_c_int] * 6 + [_ptr]),
    "repro_kp_gram_f64": (_c_int, [_ptr, _ptr, _ptr, _c_int, _c_int]
                          + [_c_dbl] * 5 + [_ptr]),
    "repro_error_string": (ctypes.c_char_p, [_c_int]),
}

_lock = threading.Lock()
_lib = None
_counts = {k: 0 for k in KERNELS}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built at first use on a "
        "machine with the CUDA toolkit (PATH or /usr/local/cuda/bin)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile every source in parallel and link one shared library; the
    compiler's output (ptxas register and spill report) goes to a log file
    beside it."""
    tag = _digest()
    out = BUILD_DIR / f"librepro_torch_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in SOURCES:
        obj = BUILD_DIR / f"{Path(src).stem}_{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _, p in procs:
        text, _ = p.communicate()
        logs.append(f"== {src}\n{text}")
        if p.returncode != 0:
            failed.append(src)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    link = subprocess.run(
        [nvcc, "-shared", *[str(o) for _, o, _ in procs], "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    (BUILD_DIR / f"build_{tag}.log").write_text("\n".join(logs))
    os.replace(tmp, out)
    return out


def load_library():
    """The loaded kernel library (built at first call; later calls take no
    lock)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = res, args
            _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = load_library().repro_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def expect(t, name: str, dtype, shape, device) -> None:
    """Validate a tensor handed to a kernel: device, dtype, shape, layout."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def stream_handle(device) -> int:
    """The handle of ``device``'s current CUDA stream, read without building
    a ``torch.cuda.Stream``."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def count_launch(name: str) -> None:
    _counts[name] += 1


def launch_counts() -> dict[str, int]:
    return dict(_counts)


def reset_launch_counts() -> None:
    for k in _counts:
        _counts[k] = 0
