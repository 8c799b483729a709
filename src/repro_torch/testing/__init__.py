"""repro_torch.testing — the fault-injection harness of the robustness
layer (``src/repro/testing``).

It ships in the package, not under ``tests/``, so the fault hooks thread
through the production entry points (``train_gnn_minibatch(faults=...)``,
``GNNServer(faults=...)``) without tests patching internals: the
injection points are part of those entry points' contract.
"""
from repro_torch.testing.faults import (FaultPlan, InjectedFault,
                                        corrupt_file, expect_kill)

__all__ = ["FaultPlan", "InjectedFault", "corrupt_file", "expect_kill"]
