"""patch()/unpatch() — the paper's two-lines-of-code integration (§3.6).

Model code routes its aggregation through ``resolve(name)``; ``patch()``
binds every registered op to its tuned implementation (plan-routed hand
kernels), ``unpatch()`` to its baseline (the trusted reduce), and
``patched()`` is the context-manager form and ``@patch_fn`` the paper's
single-function decorator. Registered ops: ``spmm``
(tuned = :func:`repro_torch.core.spmm.spmm` over a CachedGraph, baseline
= :func:`repro_torch.core.baselines.spmm_uncached`), ``fusedmm``
(tuned = :func:`repro_torch.core.fusedmm.fusedmm`, the fused BSR kernel
where the plan allows, baseline =
:func:`repro_torch.core.baselines.fusedmm_uncached`), both registered at
the first ``resolve``, and ``block_spmm`` (by
:mod:`repro_torch.sampling`).

Profile mode (``repro_torch.obs``): with op profiling on, ``resolve``
hands back a recording wrapper that logs the op, operand shapes and
which binding served it.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable

__all__ = ["patch", "unpatch", "patched", "patch_fn", "resolve",
           "register_baseline", "register_tuned", "is_patched"]

_BASELINE: dict[str, Callable] = {}
_TUNED: dict[str, Callable] = {}
_ACTIVE = False


def register_baseline(name: str, fn: Callable) -> None:
    _BASELINE[name] = fn


def register_tuned(name: str, fn: Callable) -> None:
    _TUNED[name] = fn


def is_patched() -> bool:
    return _ACTIVE


def patch() -> None:
    """Route every registered op to the tuned implementation."""
    global _ACTIVE
    _ACTIVE = True


def unpatch() -> None:
    global _ACTIVE
    _ACTIVE = False


@contextlib.contextmanager
def patched(enable: bool = True):
    prev = _ACTIVE
    (patch if enable else unpatch)()
    try:
        yield
    finally:
        (patch if prev else unpatch)()


def patch_fn(fn: Callable) -> Callable:
    """Decorator form (the paper's "decorator for patching a single
    function"): the wrapped function runs with the tuned bindings active,
    and the patch state before the call is restored after it."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with patched(True):
            return fn(*args, **kwargs)
    return wrapper


def resolve(name: str) -> Callable:
    """The binding model code calls: tuned when patched, else baseline
    (whichever exists if only one was registered)."""
    _ensure_defaults()
    table = _TUNED if _ACTIVE else _BASELINE
    variant = "tuned" if _ACTIVE else "baseline"
    if name not in table:
        other = _BASELINE if _ACTIVE else _TUNED
        if name in other:
            table, variant = other, ("baseline" if _ACTIVE else "tuned")
        else:
            raise KeyError(f"op {name!r} is not registered")
    fn = table[name]
    from repro_torch.obs import op_profiling_enabled
    if op_profiling_enabled():
        return _profiled_binding(name, variant, fn)
    return fn


def _profiled_binding(name: str, variant: str, fn: Callable) -> Callable:
    from repro_torch.obs import op_record, op_t0

    @functools.wraps(fn)
    def recorded(*args, **kwargs):
        t0 = op_t0()
        out = fn(*args, **kwargs)
        op_record(name, out, *args, t0_ns=t0, variant=variant)
        return out
    return recorded


# --------------------------------------------------------------------------
# Default registrations: baseline = uncached/untuned PyTorch-equivalent,
# tuned = the CachedGraph-aware iSpLib path. Layers call resolve('spmm').
# --------------------------------------------------------------------------

def _register_defaults() -> None:
    from repro_torch.core import baselines
    from repro_torch.core.spmm import spmm as tuned_spmm

    register_tuned("spmm", tuned_spmm)
    register_baseline("spmm", baselines.spmm_uncached)
    register_tuned("fusedmm", _import_tuned_fusedmm)
    register_baseline("fusedmm", baselines.fusedmm_uncached)


def _import_tuned_fusedmm(g, x, y, h, **kw):
    from repro_torch.core.fusedmm import fusedmm
    return fusedmm(g, x, y, h, **kw)


# deferred: core.spmm imports the kernels, which import core
def _ensure_defaults() -> None:
    if "spmm" not in _TUNED:
        _register_defaults()
