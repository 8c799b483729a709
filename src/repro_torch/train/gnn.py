"""Full-graph GNN trainer — the paper's §4 experimental loop.

Node classification, full-batch, AdamW; per-epoch wall-clock measured the
way the reference does (mean over the epochs after the first, which
builds the kernels and warms the allocator). ``use_isplib`` flips
patch()/unpatch() — the two-lines-of-code story:

    from repro_torch.core.patch import patch
    patch()              # everything below runs the tuned kernels
    train_gnn(...)

Runs on the card unless ``device="cpu"``. The reference draws the initial
weights from ``seed`` inside; so does this trainer (from a
``torch.Generator``, which gives other numbers), unless ``params=`` hands
it a starting point — a test starts both packages from the same weights
that way.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from repro_torch import obs
from repro_torch.core.patch import patched
from repro_torch.models.gnn import build_bundle, make_gnn
from repro_torch.optim import adamw, apply_updates
from repro_torch.optim.optimizer import tree_map

__all__ = ["train_gnn", "GNNTrainResult", "loss_and_grads", "xent",
           "accuracy"]


@dataclasses.dataclass
class GNNTrainResult:
    arch: str
    dataset: str
    use_isplib: bool
    losses: list
    train_acc: float
    test_acc: float
    epoch_time_s: float      # mean per-epoch wall-clock, first excluded
    first_epoch_s: float     # the first epoch (kernel builds, warm-up)
    plan_kind: str           # the plan of the graph the arch aggregates over
    epochs: int
    device: str


def xent(logits: torch.Tensor, y: torch.Tensor,
         mask: torch.Tensor) -> torch.Tensor:
    """Masked mean cross-entropy."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, y.long()[:, None])[:, 0]
    m = mask.float()
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)


def accuracy(logits: torch.Tensor, y: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    m = mask.float()
    hit = (logits.argmax(dim=-1) == y.long()).float()
    return (hit * m).sum() / torch.clamp(m.sum(), min=1.0)


def loss_and_grads(apply, params: dict, bundle, x: torch.Tensor,
                   y: torch.Tensor, mask: torch.Tensor):
    """One training step's loss and the gradient of every parameter (a
    nested dict shaped like ``params``), under the current patch state."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = xent(apply(leaves, bundle, x), y, mask)
    flat: list = []
    tree_map(flat.append, leaves)
    grads = iter(torch.autograd.grad(loss, flat))
    return loss.detach(), tree_map(lambda _: next(grads), leaves)


def train_gnn(arch: str, dataset, *, hidden: int = 128, epochs: int = 30,
              lr: float = 1e-2, weight_decay: float = 5e-4,
              use_isplib: bool = True, tune: bool = True,
              measure_tuning: bool = False, seed: int = 0,
              bundle=None, tuning_db=None, profile: bool = False,
              params: dict | None = None,
              device="cuda") -> GNNTrainResult:
    """Train a 2-layer GNN on ``dataset`` (a ``data.graphs.GraphDataset``)
    on ``device``. ``bundle`` (host or device) skips the build, which
    otherwise packs only the cached graph ``arch`` uses.

    ``measure_tuning=True`` times that graph's candidate kernels on the
    run's own ``device`` before training; ``tuning_db`` (a
    ``core.autotune.TuningDB``) serves plans this device kind has
    measured before and records new ones.

    ``profile=True`` turns the ``repro_torch.obs`` tracer on for the run
    (if it is off) and records ``train.build`` / ``train.init`` /
    ``train.step`` / ``train.eval`` spans with a device sync after every
    step — attribution mode, not benchmarking."""
    device = torch.device(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    with contextlib.ExitStack() as ctx:
        if profile and not obs.enabled():
            ctx.enter_context(obs.profiled(ops=True, fresh=False))
        ctx.enter_context(patched(use_isplib))
        if bundle is None:
            with obs.span("train.build"):
                bundle = build_bundle(dataset, k_hint=hidden, tune=tune,
                                      measure=measure_tuning,
                                      db=tuning_db, arch=arch,
                                      device=device)
        with obs.span("train.init"):
            bundle = bundle.to(device)
            init, apply = make_gnn(arch, dataset.num_features, hidden,
                                   dataset.num_classes)
            if params is None:
                params = init(torch.Generator().manual_seed(seed),
                              device=device)
            else:
                params = tree_map(lambda p: p.detach().to(device, torch.float32)
                              .clone(), params)
            opt = adamw(lr, weight_decay=weight_decay)
            opt_state = opt.init(params)
            x = dataset.x.to(device)
            y = dataset.y.to(device)
            tm = dataset.train_mask.to(device)

        def step(p, s):
            loss, grads = loss_and_grads(apply, p, bundle, x, y, tm)
            updates, s = opt.update(grads, s, p)
            return apply_updates(p, updates), s, loss

        t0 = time.perf_counter()
        with obs.span("train.step", step=0, first=True):
            params, opt_state, loss = step(params, opt_state)
            sync()
        first_epoch = time.perf_counter() - t0

        losses = [float(loss)]
        t0 = time.perf_counter()
        for ep in range(max(epochs - 1, 1)):
            with obs.span("train.step", step=ep + 1):
                params, opt_state, loss = step(params, opt_state)
                if profile:         # span times execution, not enqueue
                    sync()
            losses.append(float(loss))
        sync()
        epoch_time = (time.perf_counter() - t0) / max(epochs - 1, 1)

        with obs.span("train.eval"), torch.no_grad():
            logits = apply(params, bundle, x)
            train_acc = float(accuracy(logits, y, tm))
            test_acc = float(accuracy(logits, y,
                                      dataset.test_mask.to(device)))

    return GNNTrainResult(
        arch=arch, dataset=dataset.name, use_isplib=use_isplib,
        losses=losses, train_acc=train_acc, test_acc=test_acc,
        epoch_time_s=epoch_time, first_epoch_s=first_epoch,
        plan_kind=bundle.graph(arch).plan.kind, epochs=epochs,
        device=str(device))
