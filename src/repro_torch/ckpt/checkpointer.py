"""Atomic, asynchronous checkpoints of tensor trees
(``src/repro/ckpt/checkpointer.py``).

Layout, one directory a step, the reference's:

    <dir>/step_000000123/
        manifest.json          tree description, shapes, dtypes, ``extra``
        arr_00000.npy ...      one file a leaf
        _COMMITTED             written LAST; restore ignores dirs without it

* **Atomic**: the step is written into ``step_....tmp``, each file synced,
  ``_COMMITTED`` written after the manifest's fsync, then the directory
  renamed into place (``os.replace``). A crash mid-save never touches the
  latest durable step.
* **Asynchronous**: :meth:`Checkpointer.save` copies every leaf to host
  memory (a synchronous ``.cpu()``, a fresh copy for host tensors too)
  before it returns, and writes the files in a background thread. So a
  step that updates the tree in place right after ``save`` returns cannot
  race the writer. At most one save is in flight; the next waits, and a
  failed write raises at the next ``save`` or ``wait``.
* **Keep-N** garbage collection after each committed save.

Trees are nested dicts, tuples / lists / NamedTuples, ``None`` (no leaves)
and leaves (tensors or numpy arrays), flattened in JAX's order (dict keys
sorted, sequences in order), so an fp32 / int32 directory written by
either package reads in the other: the leaf files and the manifest's
``n_leaves`` / ``leaves`` entries are the same. numpy has no bfloat16, so
a bf16 tensor is stored as its uint16 bit pattern and the manifest names
its dtype ``"bfloat16"`` (the reference's own bf16 files, written through
``ml_dtypes``, are not read here).

Restore places each leaf on the device and in the dtype of the matching
leaf of ``tree_like`` and checks the leaf count and every shape. Placing
leaves over several devices (the reference's ``shardings``) is ROADMAP.md
queue 1, item 5b (with the sharding rules and data-parallel resume), and
raises here.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import warnings
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["Checkpointer", "save_checkpoint", "restore_checkpoint",
           "latest_step", "committed_steps", "checkpoint_extra"]

_SHARDINGS = ("restore(shardings=...): placing leaves over several devices "
              "is not ported yet (ROADMAP.md queue 1, item 5b: the sharding "
              "rules, sharded restore and data-parallel resume)")


def _step_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step:09d}")


def _flatten(tree) -> list:
    """The leaves of ``tree`` in JAX's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for child in tree for leaf in _flatten(child)]
    return [tree]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves`` (dicts keep ``like``'s key order)."""
    if like is None:
        return None
    if isinstance(like, dict):
        got = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: got[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(c, leaves) for c in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(c, leaves) for c in like)
    return next(leaves)


def _describe(tree) -> str:
    """A one-line description of the tree's structure (``*`` a leaf)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_describe(c) for c in tree)
        return f"{type(tree).__name__}({inner})"
    return "*"


def _host_copy(leaf):
    """A host copy that later in-place writes to ``leaf`` cannot reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to write, manifest dtype name); bf16 as its bit pattern."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _write_synced(path: str, write) -> None:
    """``write(f)`` into a new binary file at ``path``, then fsync it."""
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def save_checkpoint(base: str, step: int, tree: Any, *,
                    extra: Optional[dict] = None) -> str:
    """Blocking save of ``tree`` as step ``step`` under ``base``. Returns
    the committed directory."""
    os.makedirs(base, exist_ok=True)
    final = _step_dir(base, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = _flatten(tree)
    manifest = {"step": step, "treedef": _describe(tree),
                "n_leaves": len(leaves), "extra": extra or {}, "leaves": []}
    for i, leaf in enumerate(leaves):
        arr, dtype = _to_numpy(leaf)
        fname = f"arr_{i:05d}.npy"
        _write_synced(os.path.join(tmp, fname),
                      lambda f, a=arr: np.save(f, a, allow_pickle=False))
        manifest["leaves"].append(
            {"file": fname, "shape": list(arr.shape), "dtype": dtype})
    _write_synced(os.path.join(tmp, "manifest.json"),
                  lambda f: f.write(json.dumps(manifest).encode()))
    _write_synced(os.path.join(tmp, "_COMMITTED"),
                  lambda f: f.write(str(time.time()).encode()))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def committed_steps(base: str) -> list[int]:
    """All committed step numbers under ``base``, ascending."""
    if not os.path.isdir(base):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(base)
                  if d.startswith("step_") and not d.endswith(".tmp")
                  and os.path.exists(os.path.join(base, d, "_COMMITTED")))


def latest_step(base: str) -> Optional[int]:
    steps = committed_steps(base)
    return steps[-1] if steps else None


def checkpoint_extra(base: str, step: Optional[int] = None) -> dict:
    """The ``extra`` dict saved with step ``step`` (the latest committed
    step when None): the side channel for resume state that is not a
    tensor (loader position, loss history, sampler capacities)."""
    if step is None:
        step = latest_step(base)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {base}")
    with open(os.path.join(_step_dir(base, step), "manifest.json")) as f:
        return json.load(f).get("extra", {})


def _from_numpy(arr: np.ndarray, dtype: str, like):
    if dtype == "bfloat16":
        if arr.dtype != np.uint16:
            raise ValueError(f"bfloat16 leaf stored as {arr.dtype}")
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return arr.astype(np.asarray(like).dtype)


def _load_step_dir(d: str, tree_like: Any):
    """Load one committed step directory into ``tree_like``'s structure.
    Raises on any corruption (missing or truncated arrays, a bad
    manifest, a leaf count or shape that does not match)."""
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    likes = _flatten(tree_like)
    if len(likes) != manifest["n_leaves"]:
        raise ValueError(f"leaf count mismatch: {len(likes)} vs "
                         f"{manifest['n_leaves']}")
    out = []
    for i, like in enumerate(likes):
        entry = manifest["leaves"][i]
        arr = np.load(os.path.join(d, entry["file"]), allow_pickle=False)
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"leaf {i}: shape {arr.shape} != "
                             f"{tuple(like.shape)}")
        out.append(_from_numpy(arr, entry.get("dtype", str(arr.dtype)),
                               like))
    return _unflatten(tree_like, iter(out))


def restore_checkpoint(base: str, tree_like: Any, *,
                       step: Optional[int] = None,
                       shardings: Any = None) -> tuple[Any, int]:
    """Restore into the structure of ``tree_like``, each leaf on the
    device and in the dtype of ``tree_like``'s leaf. Returns (tree, step).

    With ``step=None`` the committed steps are tried newest first, and a
    step whose files cannot be read (truncated or lost arrays despite the
    ``_COMMITTED`` marker) is skipped with a warning for the one before.
    An explicit ``step`` raises instead. ``shardings`` other than None
    raises NotImplementedError."""
    if shardings is not None:
        raise NotImplementedError(_SHARDINGS)
    if step is not None:
        return _load_step_dir(_step_dir(base, step), tree_like), step
    steps = committed_steps(base)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoint under {base}")
    last_err: Optional[Exception] = None
    for s in reversed(steps):
        try:
            return _load_step_dir(_step_dir(base, s), tree_like), s
        except (OSError, ValueError, KeyError, EOFError,
                json.JSONDecodeError) as exc:
            warnings.warn(f"checkpoint step {s} under {base} is unreadable "
                          f"({exc}); falling back to the previous step")
            last_err = exc
    raise FileNotFoundError(
        f"no readable checkpoint under {base}") from last_err


class Checkpointer:
    """Asynchronous checkpoints under ``base`` with keep-N collection."""

    def __init__(self, base: str, *, keep: int = 3):
        self.base = base
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_write_s: Optional[float] = None   # the last save's write

    def wait(self) -> None:
        """Join the save in flight; raise its error if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    @property
    def in_flight(self) -> bool:
        """Whether a background write is still running."""
        return self._thread is not None and self._thread.is_alive()

    def save(self, step: int, tree: Any, *, blocking: bool = False,
             extra: Optional[dict] = None) -> None:
        """Save ``tree`` as step ``step``. Returns once every leaf has been
        copied to host memory; the files are written in the background
        unless ``blocking``."""
        self.wait()                       # at most one save in flight
        host = _unflatten(tree, iter([_host_copy(leaf)
                                      for leaf in _flatten(tree)]))

        def work():
            try:
                t0 = time.perf_counter()
                save_checkpoint(self.base, step, host, extra=extra)
                self.last_write_s = time.perf_counter() - t0
                self._gc()
            except BaseException as exc:  # raised at the next wait/save
                self._error = exc

        if blocking:
            work()
            self.wait()
        else:
            self._thread = threading.Thread(target=work, daemon=True,
                                            name="repro-ckpt")
            self._thread.start()

    def restore(self, tree_like: Any, *, step: Optional[int] = None,
                shardings: Any = None):
        self.wait()
        return restore_checkpoint(self.base, tree_like, step=step,
                                  shardings=shardings)

    def extra(self, step: Optional[int] = None) -> dict:
        """The ``extra`` dict of ``step`` (the latest when None)."""
        self.wait()
        return checkpoint_extra(self.base, step)

    def _gc(self) -> None:
        for s in committed_steps(self.base)[:-self.keep]:
            shutil.rmtree(_step_dir(self.base, s), ignore_errors=True)
