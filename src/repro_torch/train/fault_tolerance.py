"""Fault tolerance: the resilient step loop and the straggler watchdog
(``src/repro/train/fault_tolerance.py``).

* :class:`ResilientLoop` runs a step function over batches, checkpoints
  at a cadence, and on a step's exception restores the newest durable
  step and goes on from there, a bounded number of times.
* :class:`StragglerWatchdog` keeps an EMA of step wall-clock; a step
  slower than ``threshold`` x the EMA is flagged and handed to
  ``on_straggler``; consecutive flags escalate.

Two things differ from the reference, both because PyTorch is eager and
mutable:

* **Asynchronous CUDA errors.** A kernel's fault surfaces at a later
  synchronisation, so the loop synchronises the step's metrics inside its
  ``try`` (the reference's ``block_until_ready``). A *sticky* CUDA error
  (a device-side assert, an illegal address) poisons the process's CUDA
  context: every later call fails, and no retry in the same process can
  recover. The recovery for it is a new process that resumes from the
  checkpoint directory (the LM launcher's ``--resume``). The loop
  recovers in process from the failures that leave the context usable
  (a host exception, an out-of-memory error, a lost input).
* **Steps that update the state in place.** The reference keeps
  ``last_good = state`` and, after a failed step, saves it as an
  emergency checkpoint; that is sound in JAX, whose arrays are immutable.
  The port's LM step writes params and moments in place, leaf by leaf, so
  a step that fails after its update began leaves ``last_good``
  half-updated. Such a step declares it: it carries an
  :class:`InPlaceUpdate` as its ``in_place`` attribute and calls
  :meth:`InPlaceUpdate.begin` just before it mutates. The loop clears the
  flag before each step; after a failure with the flag set it does **no**
  emergency save (it would make a corrupt state look durable) and
  restores the newest durable step instead. Without the flag the loop
  behaves as the reference's.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Optional

import torch

from repro_torch import obs
from repro_torch.ckpt import Checkpointer, latest_step

__all__ = ["StragglerWatchdog", "ResilientLoop", "StepEvent",
           "InPlaceUpdate"]


@dataclasses.dataclass
class StepEvent:
    step: int
    wall_s: float
    ema_s: float
    straggler: bool


class StragglerWatchdog:
    def __init__(self, *, alpha: float = 0.1, threshold: float = 2.0,
                 escalate_after: int = 3, max_events: int = 512,
                 on_straggler: Optional[Callable[[StepEvent], None]] = None):
        self.alpha = alpha
        self.threshold = threshold
        self.escalate_after = escalate_after
        self.on_straggler = on_straggler
        self.ema: Optional[float] = None
        self.consecutive = 0
        # bounded: a long run observes millions of steps; keep the recent
        # window, with lifetime aggregates as plain counters
        self.events: deque[StepEvent] = deque(maxlen=max_events)
        self.total_steps = 0
        self.straggler_count = 0

    def observe(self, step: int, wall_s: float) -> StepEvent:
        if self.ema is None:
            self.ema = wall_s
        flagged = wall_s > self.threshold * self.ema
        # the EMA takes a clipped sample, so one outlier does not poison it
        sample = min(wall_s, 4.0 * self.ema)
        self.ema = (1 - self.alpha) * self.ema + self.alpha * sample
        self.consecutive = self.consecutive + 1 if flagged else 0
        ev = StepEvent(step=step, wall_s=wall_s, ema_s=self.ema,
                       straggler=flagged)
        self.events.append(ev)
        self.total_steps += 1
        self.straggler_count += int(flagged)
        self._trace(ev)
        if flagged and self.on_straggler:
            self.on_straggler(ev)
        return ev

    @staticmethod
    def _trace(ev: StepEvent) -> None:
        """The observed window as a ``watchdog.step`` span ending now (the
        watchdog gets a duration, not timestamps), so a straggler shows as
        a long bar beside the trainer's ``train.step`` track. A no-op when
        tracing is off."""
        tracer = obs.get_tracer()
        if not tracer.enabled:
            return
        dur_ns = int(ev.wall_s * 1e9)
        tracer.add_span("watchdog.step", time.perf_counter_ns() - dur_ns,
                        dur_ns, step=ev.step, ema_s=ev.ema_s,
                        straggler=ev.straggler)

    def summary(self) -> dict:
        """Lifetime aggregates and the up to 5 slowest events still in the
        window, slowest first."""
        worst = sorted(self.events, key=lambda e: e.wall_s, reverse=True)[:5]
        return {
            "total_steps": self.total_steps,
            "straggler_count": self.straggler_count,
            "straggler_frac": (self.straggler_count / self.total_steps
                               if self.total_steps else 0.0),
            "ema_s": self.ema if self.ema is not None else 0.0,
            "consecutive": self.consecutive,
            "worst": [dataclasses.asdict(e) for e in worst],
        }

    @property
    def should_escalate(self) -> bool:
        return self.consecutive >= self.escalate_after


class InPlaceUpdate:
    """The flag a step that updates its state in place sets just before
    the first write (see the module docstring)."""

    def __init__(self):
        self.begun = False

    def begin(self) -> None:
        self.begun = True

    def clear(self) -> None:
        self.begun = False


def _block_until_ready(tree) -> None:
    """Wait for the first tensor of ``tree`` (a dict, a sequence or a
    tensor): on the card, a synchronisation that raises a kernel's
    asynchronous error here."""
    while isinstance(tree, (dict, list, tuple)):
        if not tree:
            return
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    if isinstance(tree, torch.Tensor) and tree.is_cuda:
        torch.cuda.synchronize(tree.device)


class ResilientLoop:
    """Checkpointed step loop with bounded retry from durable state."""

    def __init__(self, step_fn: Callable, ckpt: Checkpointer, *,
                 ckpt_every: int = 100, max_restarts: int = 3,
                 watchdog: Optional[StragglerWatchdog] = None,
                 rebuild_step: Optional[Callable[[], Callable]] = None,
                 state_shardings: Any = None):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.watchdog = watchdog or StragglerWatchdog()
        self.rebuild_step = rebuild_step
        self.state_shardings = state_shardings
        self.restarts = 0
        self.emergency_saves = 0

    def run(self, state: Any, batches, *, start_step: int = 0,
            num_steps: int = 100, on_metrics: Optional[Callable] = None):
        """Iterate ``batches`` for ``num_steps``; returns (state, last
        step). After a failed step the loop goes on from the step the
        restore returned (its own (state, step) pair: the restore may fall
        back past an unreadable newest step)."""
        step = start_step
        it = iter(batches)
        last_good = state
        while step < start_step + num_steps:
            batch = next(it)
            t0 = time.perf_counter()
            in_place = getattr(self.step_fn, "in_place", None)
            if in_place is not None:
                in_place.clear()
            try:
                state, metrics = self.step_fn(state, batch)
                _block_until_ready(metrics)
            except Exception:
                self.restarts += 1
                if in_place is not None and in_place.begun:
                    # last_good shares the tensors the step was writing:
                    # only a durable step is a known state now
                    self.ckpt.wait()
                    if latest_step(self.ckpt.base) is None:
                        raise
                else:
                    self.emergency_saves += 1
                    self.ckpt.save(step, last_good, blocking=True,
                                   extra={"emergency": True})
                if self.restarts > self.max_restarts:
                    raise
                if self.rebuild_step is not None:
                    self.step_fn = self.rebuild_step()
                state, step = self.ckpt.restore(
                    last_good, shardings=self.state_shardings)
                last_good = state
                continue
            wall = time.perf_counter() - t0
            self.watchdog.observe(step, wall)
            if on_metrics:
                on_metrics(step, metrics)
            step += 1
            last_good = state
            if step % self.ckpt_every == 0:
                self.ckpt.save(step, state)
        self.ckpt.wait()
        return state, step
