"""The meshes of the port's distributed paths over ``torch.distributed``,
and the one helper that starts their ranks (``src/repro/dist/mesh.py``).

The reference runs every rank in one process, with ``shard_map`` over a
JAX mesh. The port runs one process a rank: a :class:`Mesh` is this
rank's view of the mesh, its named axes with their sizes, the rank's
coordinate on each, its device, and the process group each axis
reduces over. Three meshes: the ``('data', 'model')`` mesh of data,
tensor and expert parallelism (ranks row-major, as the reference's
``jax.make_mesh((data, model))`` lays out devices: rank = data index x
model + model index; a process group for each ``'data'`` column and
each ``'model'`` row), the ``('row', 'col')`` grid of the 2-D
vertex-cut GNN path (:func:`make_grid_mesh`, the most square
factorisation of the ranks), and the shape-only production meshes
(:func:`make_production_mesh`: 16 x 16 or 2 x 16 x 16, no ranks, device
``meta``), which the sharding rules and the ``*_shardings`` builders
read; a collective on one raises.

``with mesh:`` makes a mesh the active one (:func:`current_mesh`), as
the reference's ``with mesh:`` does: the LM layers read it, with the
active rules (``dist.sharding``), to know which of their products are
split over ``'model'``.

**The backend is chosen once, by one rule** (:func:`choose_backend`),
when the ranks start, and the mesh records it: NCCL when every rank has
a card of its own; gloo when the ranks share a card or run on the CPU.
NCCL refuses two ranks on one device; gloo reduces card tensors by
staging them through the host, which is all data-parallel gradient sync
needs (``all_reduce`` with sum and max, ``broadcast``). A failure of
NCCL is raised, never answered by switching to gloo.

:func:`run_ranks` is the one way the package starts ranks (the LM
launcher, the tests and the chip script all use it): spawned processes,
a ``FileStore`` rendezvous in a directory the caller gives (no TCP
port), every rank joined within a time limit, and the other ranks
killed when one fails or overruns.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["Mesh", "axis_shard_count", "choose_backend", "make_local_mesh",
           "make_data_mesh", "make_grid_mesh", "make_production_mesh",
           "grid_shape", "init_ranks", "run_ranks", "current_mesh",
           "replicated_sharding", "leading_axis_sharding",
           "replicated_device_put"]

_ACTIVE: list = []          # the meshes entered with ``with mesh:``


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's view of a ``('data', 'model')`` mesh.

    ``shape`` maps each axis name to its size, ``coords`` to this rank's
    index on it, ``groups`` to the process group a collective over the
    axis uses (None for a one-rank axis without a process group: its
    collectives are identities). ``backend`` is the groups' backend
    (None without a group)."""

    shape: dict
    coords: dict
    device: torch.device
    backend: Optional[str]
    groups: dict
    abstract: bool = False     # shape only (make_production_mesh)

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= int(v)
        return n

    def index(self, axis: str = "data") -> int:
        """This rank's coordinate on ``axis`` (0 on an absent axis)."""
        return int(self.coords.get(axis, 0))

    def group(self, axis: str = "data"):
        if self.abstract and int(self.shape.get(axis, 1)) > 1:
            raise RuntimeError(f"mesh {self.shape} is shape-only (no "
                               f"ranks): no collective runs over {axis!r}")
        return self.groups.get(axis)

    def __enter__(self) -> "Mesh":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        _ACTIVE.pop()
        return False


def current_mesh() -> Optional[Mesh]:
    """The innermost mesh entered with ``with mesh:``, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def axis_shard_count(mesh, axis: str = "data") -> int:
    """Size of a named mesh axis, with "axis not in this mesh" reading as
    one shard: what seed sharding (``sampling.loader``) and the other
    data-parallel consumers rely on to run unchanged without a mesh.
    Reads ``mesh.shape[axis]``, so anything with such a ``shape`` mapping
    serves."""
    try:
        return int(mesh.shape[axis])
    except (KeyError, TypeError, AttributeError):
        return 1


def choose_backend(device: str, world_size: int, n_cards: int) -> str:
    """The backend rule: ``'nccl'`` when the ranks run on cards and every
    rank has one of its own (``world_size <= n_cards``), ``'gloo'`` when
    they share a card or run on the CPU."""
    if torch.device(device).type == "cpu":
        return "gloo"
    if n_cards < 1:
        raise RuntimeError("no CUDA card: ask for device='cpu' to run the "
                           "ranks on the CPU")
    return "nccl" if world_size <= n_cards else "gloo"


def _rank_device(device: str, rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def _mesh(data: int, model: int, device: str) -> Mesh:
    if data < 1 or model < 1:
        raise ValueError(f"mesh data={data} model={model}")
    if not dist.is_initialized():
        if data * model != 1:
            raise RuntimeError(f"a mesh of data={data} model={model} needs "
                               "its ranks started first (run_ranks or "
                               "init_ranks)")
        return Mesh(shape={"data": 1, "model": 1},
                    coords={"data": 0, "model": 0},
                    device=_rank_device(device, 0), backend=None,
                    groups={"data": None, "model": None})
    world, rank = dist.get_world_size(), dist.get_rank()
    if data * model != world:
        raise ValueError(f"mesh data={data} x model={model} over {world} "
                         "ranks: the mesh spans every rank")
    i, j = divmod(rank, model)
    groups = {"data": None, "model": None}
    # every rank creates every group, in one order: the 'data' columns,
    # then the 'model' rows; an axis that spans every rank takes WORLD
    if data > 1:
        if model == 1:
            groups["data"] = dist.group.WORLD
        else:
            for jj in range(model):
                g = dist.new_group([ii * model + jj for ii in range(data)])
                if jj == j:
                    groups["data"] = g
    if model > 1:
        if data == 1:
            groups["model"] = dist.group.WORLD
        else:
            for ii in range(data):
                g = dist.new_group([ii * model + jj for jj in range(model)])
                if ii == i:
                    groups["model"] = g
    return Mesh(shape={"data": data, "model": model},
                coords={"data": i, "model": j},
                device=_rank_device(device, rank),
                backend=dist.get_backend(), groups=groups)


def make_local_mesh(data: int = 1, model: int = 1, *,
                    device: str = "cuda") -> Mesh:
    """The reference's small local mesh: ``data`` clamps to the ranks
    that exist, then ``model`` to the ranks left (one rank without a
    process group)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    data = min(int(data), n)
    return _mesh(data, min(int(model), max(n // data, 1)), device)


def make_data_mesh(data: int | None = None, *, model: int = 1,
                   device: str = "cuda") -> Mesh:
    """``('data', 'model')`` mesh with an explicit data-parallel degree,
    the one the lockstep minibatch trainer, the data-parallel LM step
    and the tensor-parallel LM step take. ``data`` defaults to every
    rank over ``model``; ``device`` is where the ranks run (``'cuda'``:
    card ``rank % cards``). Call it on every rank: it creates the axes'
    process groups."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    model = int(model)
    return _mesh(max(n // model, 1) if data is None else int(data), model,
                 device)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh as a shape: 16 x 16 ``('data',
    'model')`` (256 chips) or 2 x 16 x 16 ``('pod', 'data', 'model')``,
    with no ranks, no groups and device ``meta``. The sharding rules and
    the ``*_shardings`` builders read it; a collective over one of its
    axes raises."""
    shape = {"pod": 2, "data": 16, "model": 16} if multi_pod else \
        {"data": 16, "model": 16}
    return Mesh(shape=shape, coords={k: 0 for k in shape},
                device=torch.device("meta"), backend=None,
                groups={k: None for k in shape}, abstract=True)


def replicated_sharding(mesh):
    """The fully replicated sharding on ``mesh`` (every rank holds the
    whole tensor)."""
    from repro_torch.dist.sharding import Sharding
    return Sharding(mesh, ())


def leading_axis_sharding(mesh, axis: str = "data"):
    """Dim 0 split over ``axis``: each rank holds its own block of rows
    (the placement of per-shard batches)."""
    from repro_torch.dist.sharding import Sharding
    return Sharding(mesh, (axis,))


def replicated_device_put(x, mesh=None, *, device="cuda") -> torch.Tensor:
    """``x`` (a tensor or anything ``torch.as_tensor`` takes) whole on
    this rank's device when a mesh is given (every rank holds a copy),
    else on ``device``."""
    dev = mesh.device if mesh is not None else torch.device(device)
    return torch.as_tensor(x).to(dev)


def grid_shape(n: int) -> tuple[int, int]:
    """The most square ``(pr, pc)`` factorisation of ``n`` ranks: ``pr``
    the largest divisor of ``n`` not above its square root (the
    reference's ``make_grid_mesh`` rule)."""
    if n < 1:
        raise ValueError(f"a grid of {n} ranks")
    pr = max(int(n ** 0.5), 1)
    while n % pr:
        pr -= 1
    return pr, n // pr


def make_grid_mesh(devices: int | None = None, *,
                   device: str = "cuda") -> Mesh:
    """The ``('row', 'col')`` mesh of the 2-D vertex-cut GNN path
    (``dist.gnn2d``) over ``devices`` ranks (default: every rank), shaped
    by :func:`grid_shape`. Rank ``p`` sits at ``(p // pc, p % pc)``, the
    row-major order of the reference's tile stack. A collective over
    ``'row'`` runs among the ranks of this rank's grid column (the ranks
    that differ only in their row), one over ``'col'`` among those of its
    grid row: one process group for each grid column and each grid row.

    Every rank creates every group, in one order (the column groups, then
    the row groups); an axis of size 1 gets none (its collectives are
    identities). Call it on every rank."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if devices is None else int(devices)
    if n != world:
        raise ValueError(f"a grid of {n} ranks over {world} ranks: the grid "
                         "spans every rank")
    pr, pc = grid_shape(n)
    rank = dist.get_rank() if dist.is_initialized() else 0
    i, j = divmod(rank, pc)
    groups = {"row": None, "col": None}
    if pr > 1:
        for jj in range(pc):
            g = dist.new_group([ii * pc + jj for ii in range(pr)])
            if jj == j:
                groups["row"] = g
    if pc > 1:
        for ii in range(pr):
            g = dist.new_group([ii * pc + jj for jj in range(pc)])
            if ii == i:
                groups["col"] = g
    return Mesh(shape={"row": pr, "col": pc}, coords={"row": i, "col": j},
                device=_rank_device(device, rank),
                backend=dist.get_backend() if dist.is_initialized() else None,
                groups=groups)


def init_ranks(rank: int, world_size: int, *, store_dir: str | None = None,
               device: str = "cuda", timeout_s: float = 600.0,
               model: int = 1) -> Mesh:
    """Start this process's rank: the backend by :func:`choose_backend`,
    the card of ``rank % cards`` made current, the process group over a
    ``FileStore`` in ``store_dir`` (or, without one, the ``env://``
    variables a launcher such as ``torchrun`` sets), and the ``(world /
    model, model)`` mesh over all ranks."""
    n_cards = torch.cuda.device_count() if torch.device(device).type \
        == "cuda" else 0
    # the ranks that share this host's cards: all of them, unless a
    # launcher says how many run here
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    backend = choose_backend(device, local, n_cards)
    dev = _rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    elif "OMP_NUM_THREADS" not in os.environ:
        # CPU ranks share the host's cores: each rank's idle compute
        # threads spin while it waits in a collective, so more threads
        # than cores slows every rank many times over
        cores = len(os.sched_getaffinity(0))
        torch.set_num_threads(max(1, cores // local))
    kw: dict[str, Any] = dict(backend=backend, rank=rank,
                              world_size=world_size,
                              timeout=datetime.timedelta(seconds=timeout_s))
    if store_dir is not None:
        kw["store"] = dist.FileStore(os.path.join(store_dir, "rendezvous"),
                                     world_size)
    dist.init_process_group(**kw)
    if world_size % model:
        raise ValueError(f"{world_size} ranks do not split into a 'model' "
                         f"axis of {model}")
    return make_data_mesh(world_size // model, model=model, device=device)


def _rank_main(fn, rank: int, world_size: int, store_dir: str, device: str,
               timeout_s: float, args: tuple, out, model: int = 1) -> None:
    try:
        mesh = init_ranks(rank, world_size, store_dir=store_dir,
                          device=device, timeout_s=timeout_s, model=model)
        try:
            result = fn(mesh, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:                      # reported, then re-raised
        out.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, world_size: int, store_dir: str, *,
              args: Sequence = (), device: str = "cuda",
              timeout_s: float = 600.0, model: int = 1) -> list:
    """Run ``fn(mesh, *args)`` in ``world_size`` spawned ranks and return
    their results, rank 0 first. ``mesh`` is the ``(world_size / model,
    model)`` mesh.

    ``fn`` and ``args`` are pickled (``fn`` by its import path) and the
    results come back pickled. The ranks rendezvous through a
    ``FileStore`` in a fresh directory under ``store_dir``. Every rank
    must finish within ``timeout_s`` seconds of the start; when one
    raises, dies or overruns, the others are killed and this raises with
    the failing ranks' tracebacks."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    os.makedirs(store_dir, exist_ok=True)
    run_dir = tempfile.mkdtemp(prefix="ranks-", dir=store_dir)
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(fn, r, world_size, run_dir, device,
                               timeout_s, tuple(args), out, model))
             for r in range(world_size)]
    results: dict[int, Any] = {}
    errors: dict[int, str] = {}
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(results) < world_size and not errors:
            left = deadline - time.monotonic()
            if left <= 0:
                late = sorted(set(range(world_size)) - set(results))
                errors[-1] = (f"ranks {late} did not finish within "
                              f"{timeout_s:.0f} s")
                break
            try:
                rank, ok, payload = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                if dead:
                    # a rank that put its report exits after it: give the
                    # report a moment to arrive before calling it lost
                    try:
                        rank, ok, payload = out.get(timeout=5.0)
                    except queue.Empty:
                        errors[dead[0]] = (f"rank {dead[0]} exited with "
                                           f"code {procs[dead[0]].exitcode} "
                                           "and no report")
                        break
                else:
                    continue
            if ok:
                results[rank] = payload
            else:
                errors[rank] = payload
    finally:
        for p in procs:
            if p.is_alive() and (errors or len(results) < world_size):
                p.kill()
            p.join(timeout=30.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        out.close()
        out.join_thread()
        shutil.rmtree(run_dir, ignore_errors=True)
    if errors:
        raise RuntimeError("ranks failed:\n" + "\n".join(
            f"-- rank {r} --\n{msg}" for r, msg in sorted(errors.items())))
    return [results[r] for r in range(world_size)]
