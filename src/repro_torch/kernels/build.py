"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, which :func:`load_kernel` opens with
``ctypes``. Libraries are named by a hash of their sources and flags and
built at first use into ``build/kernels/`` at the repository root (or
``$REPRO_TORCH_BUILD_DIR``), so an edited source rebuilds and an
unchanged one is reused. All missing libraries build in parallel, one
``nvcc`` process per source.

Nothing here runs at import time: the CPU tests import every module, and
only a CUDA launch needs a library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Sequence

__all__ = ["KERNELS", "NVCC_FLAGS", "build_kernels", "load_kernel",
           "build_log", "build_dir"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
KERNELS = ("ell_spmm", "sell_spmm", "bsr_spmm", "sample", "sddmm",
           "fusedmm", "ragged_gemm", "flash_attention", "segment_sum",
           "edge_dots", "flash_attention_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures of each library's entry points: one pointer per array and
# the stream as c_void_p, sizes as c_int (c_longlong where they may pass
# 2^31), hash words as c_uint, scales as c_float; every function returns
# cudaGetLastError() as an int.
_P, _I, _L, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_uint, ctypes.c_float
_SIGNATURES = {
    "ell_spmm": {"ell_spmm_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]},
    "sell_spmm": {"sell_spmm_f32": [_P] * 8 + [_I] * 9 + [_P]},
    "bsr_spmm": {"bsr_spmm_f32": [_P] * 7 + [_I] * 9 + [_P],
                 "bsr_transpose_h_f32": [_P] * 2 + [_I] * 3 + [_P]},
    "sample": {"segment_sample_i32": [_P, _P, _P, _I, _I, _U, _U, _U, _I, _P],
               "expand_indptr_i32": [_P, _P, _P, _P, _I, _I, _I, _P],
               "flat_gather_b32": [_P, _L, _P, _P, _L, _P],
               "sample_hop_i32": [_P, _I, _P, _P, _I, _P, _I, _I, _I, _U,
                                  _U, _U, _I, _P, _P, _P, _P]},
    "sddmm": {"sddmm_f32": [_P] * 7 + [_I] * 8 + [_P]},
    "fusedmm": {"fusedmm_f32": [_P] * 8 + [_I] * 7 + [_L, _I, _L, _I, _P]},
    "ragged_gemm": {f"ragged_gemm_{t}": [_P] * 4 + [_L] + [_I] * 4 + [_P]
                    for t in ("bf16_wgmma", "bf16", "f32")},
    "flash_attention": {f"flash_attention_{t}":
                        [_P] * 5 + [_I] * 8 + [_L, _F, _P]
                        for t in ("bf16", "f32")},
    "flash_attention_bwd": {f"flash_attention_bwd_{t}":
                            [_P] * 10 + [_I] * 8 + [_L, _F, _P]
                            for t in ("bf16", "f32")},
    "segment_sum": {"segment_sum_f32": [_P, _L] + [_P] * 6 + [_I, _I, _L,
                                                            _I, _I, _I, _P]},
    "edge_dots": {"edge_dots_f32": [_P, _L, _P, _L, _I, _P, _L, _P, _L, _I,
                                    _P, _P, _L, _P, _P, _I, _I, _P]},
}

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """``$REPRO_TORCH_BUILD_DIR`` if set, else ``build/kernels`` at the
    root of the checkout the package runs from (listed in .gitignore).
    An installed copy outside a checkout must name its build directory:
    there is no checkout root to build under."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env).resolve()
    pkg = Path(__file__).resolve().parents[1]
    root = pkg.parents[1]
    if pkg != root / "src" / "repro_torch":
        raise RuntimeError(
            f"repro_torch at {pkg} is not under a checkout's src/: set "
            "REPRO_TORCH_BUILD_DIR to the directory the kernels build in")
    return root / "build" / "kernels"


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = []
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    cands.append(shutil.which("nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels build only where the toolkit is")


def build_kernels(names: Sequence[str] = KERNELS) -> dict[str, float]:
    """Compile every library in ``names`` that is not built yet, all in
    parallel. Returns ``{name: seconds}`` for the ones compiled by this
    call (empty when everything was cached). Raises with nvcc's output
    when a compile fails."""
    with _LOCK:
        todo = {n: _lib_path(n) for n in names if not _lib_path(n).exists()}
        if not todo:
            return {}
        nvcc = _nvcc()
        build_dir().mkdir(parents=True, exist_ok=True)
        procs = {}
        for name, lib in todo.items():
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, time.perf_counter())
        secs, failed = {}, []
        for name, (proc, tmp, t0) in procs.items():
            log, _ = proc.communicate()
            secs[name] = time.perf_counter() - t0
            lib = todo[name]
            lib.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}.cu "
                              f"(exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, lib)
        if failed:
            raise RuntimeError("\n".join(failed))
        return secs


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and spill report) of the current
    build of ``name``, or '' if it was never built here."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load_kernel(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if needed;
    its C functions have their argument and return types declared."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    build_kernels([name])
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn_name, argtypes in _SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LOADED[name] = lib
    return lib
