"""Injectable failures for the fault-tolerance tests
(``src/repro/testing/faults.py``).

A :class:`FaultPlan` is handed to ``train_gnn_minibatch(faults=...)`` (or
``GNNServer(faults=...)``) and fires each configured fault exactly once:

* ``step_exception_at=k`` — raise :class:`InjectedFault` from the host
  loop just before global step ``k`` executes (the "killed mid-epoch"
  fault: the checkpoint on disk is whatever the ckpt cadence last saved);
* ``nan_grad_at=(k, shard)`` — add NaN to every gradient on the device
  inside the step at global step ``k``, on the rank whose shard of a
  data-parallel mesh is ``shard`` (without a mesh, or on a one-shard
  mesh, the shard is ignored). The non-finite guard must skip that
  update on every rank;
* ``prefetch_death_at=k`` — the producer side of the prefetch pipeline
  raises before delivering its ``k``-th item (0-based, counted over the
  whole run, restarts included), exercising ``resilient_prefetch``;
* ``straggler_at=k`` — sleep ``straggler_delay_s`` before step ``k`` so a
  :class:`~repro_torch.train.fault_tolerance.StragglerWatchdog` flags it;
* ``flush_exception_at=k`` — raise :class:`InjectedFault` from the serving
  loop just before micro-batch flush ``k`` executes (the "model blew up
  mid-serve" fault: every ticket in that flush must fail with the error
  while the batcher keeps serving later flushes and the feature cache
  stays consistent — see ``repro_torch.serving``).

Each fault is one-shot: a resumed run that replays past a fired step
index does not re-fire it (the plan object carries the state, so reuse
the *same* plan across the kill and the resume — or pass ``faults=None``
on resume, which the kill/resume tests do).

The guard itself (``skip_nonfinite``) runs in every step, injected or
not, so the *guarded* trainer is the thing under test.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Iterator, Optional

__all__ = ["InjectedFault", "FaultPlan", "corrupt_file", "expect_kill"]


class InjectedFault(RuntimeError):
    """Raised by injection points — never by real trainer code, so tests
    can assert the failure they caused is the failure they caught."""


@dataclasses.dataclass
class FaultPlan:
    """One-shot fault schedule for a ``train_gnn_minibatch`` run."""

    step_exception_at: Optional[int] = None
    nan_grad_at: Optional[tuple[int, int]] = None   # (global step, shard)
    prefetch_death_at: Optional[int] = None
    straggler_at: Optional[int] = None
    straggler_delay_s: float = 0.25
    flush_exception_at: Optional[int] = None

    def __post_init__(self):
        self._fired: set = set()
        self._produced: int = 0       # prefetch items delivered by wrappers

    # -- host-loop injection points ---------------------------------------
    def before_step(self, gstep: int) -> None:
        """Called by the trainer before executing global step ``gstep``."""
        if self.straggler_at == gstep and "straggler" not in self._fired:
            self._fired.add("straggler")
            time.sleep(self.straggler_delay_s)
        if self.step_exception_at == gstep and "kill" not in self._fired:
            self._fired.add("kill")
            raise InjectedFault(f"injected step exception at step {gstep}")

    # -- serving-loop injection point --------------------------------------
    def before_flush(self, flush_idx: int) -> None:
        """Called by ``serving.server.GNNServer`` before executing micro-
        batch flush ``flush_idx`` (inside the flush's error boundary)."""
        if self.flush_exception_at == flush_idx and \
                "flush" not in self._fired:
            self._fired.add("flush")
            raise InjectedFault(
                f"injected flush exception at flush {flush_idx}")

    # -- prefetch producer injection --------------------------------------
    def wrap_stream(self, it: Iterator) -> Iterator:
        """Wrap a (sample + pack) stream: dies once before producing item
        ``prefetch_death_at``. The produced-count persists across restarts
        (the rebuilt stream starts past the already-delivered prefix), so
        the fault fires at an absolute position in the run, once."""
        for item in it:
            if self.prefetch_death_at is not None and \
                    self._produced == self.prefetch_death_at and \
                    "prefetch" not in self._fired:
                self._fired.add("prefetch")
                raise InjectedFault(
                    f"injected prefetch death before item {self._produced}")
            self._produced += 1
            yield item


def corrupt_file(path: str, *, garbage: bytes = b"\x00{not json",
                 truncate_to: Optional[int] = None) -> None:
    """Corrupt ``path`` in place: truncate to ``truncate_to`` bytes, or
    overwrite with non-JSON garbage. For TuningDB-quarantine and
    crash-truncated-checkpoint tests."""
    if truncate_to is not None:
        with open(path, "rb+") as f:
            f.truncate(truncate_to)
        return
    with open(path, "wb") as f:
        f.write(garbage)
    os.utime(path)


def expect_kill(fn, *args, **kwargs):
    """Run ``fn`` asserting it dies with :class:`InjectedFault`; returns
    the exception. The 'kill the run' half of a kill/resume test."""
    try:
        fn(*args, **kwargs)
    except InjectedFault as exc:
        return exc
    raise AssertionError("expected an InjectedFault, but the run completed")
