"""A data-parallel mesh over ``torch.distributed``, and the one helper
that starts its ranks (``src/repro/dist/mesh.py``).

The reference runs data parallelism in one process, with ``shard_map``
over a JAX mesh's ``'data'`` axis. The port runs one process a rank: a
:class:`Mesh` is this rank's view of the mesh, its named axes
``('data', 'model')`` with their sizes, the rank's coordinate on each,
its device, and the process group each axis reduces over. Pure data
parallelism only: ``'model'`` > 1 (tensor and expert parallelism, the
sharding rules) is ROADMAP.md queue 1, item 5b, and raises.

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
           "make_data_mesh", "init_ranks", "run_ranks"]

_MODEL_AXIS = ("a 'model' axis larger than 1 (tensor and expert "
               "parallelism, the sharding rules) is not ported yet "
               "(ROADMAP.md queue 1, item 5b)")


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

    def index(self, axis: str = "data") -> int:
        """This rank's coordinate on ``axis`` (0 on an absent axis)."""
        return int(self.coords.get(axis, 0))

    def group(self, axis: str = "data"):
        return self.groups.get(axis)


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
    if model != 1:
        raise NotImplementedError(f"mesh model={model}: {_MODEL_AXIS}")
    if not dist.is_initialized():
        if data != 1:
            raise RuntimeError(f"a mesh of data={data} needs its ranks "
                               "started first (run_ranks or init_ranks)")
        return Mesh(shape={"data": 1, "model": 1},
                    coords={"data": 0, "model": 0},
                    device=_rank_device(device, 0), backend=None,
                    groups={"data": None, "model": None})
    world, rank = dist.get_world_size(), dist.get_rank()
    if data != world:
        raise ValueError(f"mesh data={data} over {world} ranks: the data "
                         "axis spans every rank")
    return Mesh(shape={"data": world, "model": 1},
                coords={"data": rank, "model": 0},
                device=_rank_device(device, rank),
                backend=dist.get_backend(),
                groups={"data": dist.group.WORLD, "model": None})


def make_local_mesh(data: int = 1, model: int = 1, *,
                    device: str = "cuda") -> Mesh:
    """The reference's small local mesh: ``data`` clamps to the ranks
    that exist (one without a process group)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return _mesh(min(int(data), n), int(model), device)


def make_data_mesh(data: int | None = None, *, model: int = 1,
                   device: str = "cuda") -> Mesh:
    """``('data', 'model')`` mesh with an explicit data-parallel degree,
    the one the lockstep minibatch trainer and the data-parallel LM step
    take. ``data`` defaults to every rank; ``device`` is where the ranks
    run (``'cuda'``: card ``rank % cards``)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return _mesh(n if data is None else int(data), int(model), device)


def init_ranks(rank: int, world_size: int, *, store_dir: str | None = None,
               device: str = "cuda",
               timeout_s: float = 600.0) -> Mesh:
    """Start this process's rank: the backend by :func:`choose_backend`,
    the card of ``rank % cards`` made current, the process group over a
    ``FileStore`` in ``store_dir`` (or, without one, the ``env://``
    variables a launcher such as ``torchrun`` sets), and the data mesh
    over all ranks."""
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
    return make_data_mesh(world_size, device=device)


def _rank_main(fn, rank: int, world_size: int, store_dir: str, device: str,
               timeout_s: float, args: tuple, out) -> None:
    try:
        mesh = init_ranks(rank, world_size, store_dir=store_dir,
                          device=device, timeout_s=timeout_s)
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
              timeout_s: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` in ``world_size`` spawned ranks and return
    their results, rank 0 first.

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
                               timeout_s, tuple(args), out))
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
