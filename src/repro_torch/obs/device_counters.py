"""Named counters that live on the device and are drained without a
per-step host sync.

Port of ``src/repro/obs/device_counters.py``. A training step wants to
count things (skipped updates, capacity-overflow edges) but a per-step
host read of a counter waits for the device and serializes the pipeline.
So the counters ride through the step as one ``(n,)`` int32 tensor on the
device: :meth:`DeviceCounters.add` is a device-side add (of a device
scalar or a host int), and :meth:`DeviceCounters.drain` is the one
deliberate host sync, made at epoch cadence.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["DeviceCounters", "device_counters"]


@dataclasses.dataclass(frozen=True)
class DeviceCounters:
    """Immutable named int32 counters; ``stats = stats.add("skipped", n)``
    returns new counters and leaves the old tensor untouched."""

    names: tuple
    values: torch.Tensor    # (len(names),) int32

    def _idx(self, name: str) -> int:
        try:
            return self.names.index(name)
        except ValueError:
            raise KeyError(f"no counter {name!r}; have {self.names}") \
                from None

    def add(self, name: str, amount) -> "DeviceCounters":
        """New counters with ``amount`` (a device scalar tensor or an int)
        added to ``name``, on the device, without a sync."""
        values = self.values.clone()
        values[self._idx(name)] += amount
        return dataclasses.replace(self, values=values)

    def __getitem__(self, name: str) -> torch.Tensor:
        """The counter as a 0-d device tensor (``int()`` of it syncs)."""
        return self.values[self._idx(name)]

    def drain(self) -> dict:
        """Host read of every counter: THE device sync. Call at epoch
        cadence, never per step."""
        return dict(zip(self.names, self.values.tolist()))


def device_counters(*names: str, device="cuda") -> DeviceCounters:
    """Fresh zeroed counters on ``device``:
    ``device_counters("skipped", "overflow")``."""
    assert names and len(set(names)) == len(names), names
    return DeviceCounters(names=tuple(names),
                          values=torch.zeros(len(names), dtype=torch.int32,
                                             device=device))
