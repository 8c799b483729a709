"""The port's data parallelism (``repro_torch.dist``, the lockstep
minibatch trainer's ``mesh=``, the LM step's ``sync_axis`` and
``make_data_parallel_step``, the launcher's ``--mesh-data`` /
``--grad-sync shardmap``) against the JAX reference, on the CPU.

Two gloo ranks run on the CPU, started by ``dist.run_ranks`` (a
``FileStore`` under the test's temporary directory; each run joined
within ``RANK_TIMEOUT`` seconds, the other ranks killed when one fails:
that limit, not a pytest plugin, is what keeps a lost collective from
hanging the suite). The rank bodies live in this module, which the
spawned ranks import. The reference's own data-parallel tests run under
``shard_map`` on fake devices and are red in this repository's runs, so
the port is held against the reference's **single-device** functions:

- seeds: ``shard_seeds``, ``seed_batches(num_shards=, shard_index=)``
  and ``num_seed_batches`` equal the reference's outputs exactly (its
  ``axis_shard_count`` reads ``mesh.shape``, so a plain object with a
  ``shape`` dict stands in for its mesh);
- collectives: the fp32 wire bitwise the mean each rank computes from
  the ranks' inputs; ``compressed_psum`` bitwise the reference's
  ``int8_compress(x, amax=global)``, summed as int32, then
  ``int8_decompress``; ``wire_bytes`` the reference's count;
- the minibatch step (reddit 1/512, sage-mean, hidden 16, batch 64): on
  distinct shard batches the synced gradients within rtol 1e-5 / atol
  1e-6 x max(1, max|ref|) of the mean of the reference's 1-device
  ``make_minibatch_step`` gradients on each shard (fp32 sums in another
  order), and bitwise the mean of the port's own 1-rank gradients, the
  updated params bitwise that mean's update; identical batches on both
  ranks bitwise the 1-rank step; the int8 wire within amax / 127 a leaf;
- the LM step (llama3-8b's fp32 smoke config, a global batch of 4 x 32
  tokens): the synced gradients within 1e-4 of the largest element of
  the mean of the reference's ``make_train_step`` gradients (its
  ``value_and_grad`` of ``loss_fn``) on each half (``loss_fn``'s stated
  tolerance), and bitwise the mean of the port's own 1-rank gradients;
  the loss the mean of the halves'."""
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.lm.transformer as JT
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import sparse as jsp
from repro.core.autotune import KernelPlan as JPlan
from repro.core.patch import patched as jax_patched
from repro.data import make_dataset as jax_make_dataset
from repro.dist import collectives as jcoll
from repro.optim import adamw as jax_adamw
from repro.optim.compression import int8_compress as jax_int8_compress
from repro.optim.compression import int8_decompress as jax_int8_decompress
from repro.sampling import NeighborSampler as JSampler
from repro.sampling import loader as jloader
from repro.sampling import pack_block as jax_pack_block
from repro.sampling import plan_buckets as jax_plan_buckets
from repro.train import gnn_minibatch as jmb

from repro_torch import dist as tdist
from repro_torch import obs
from repro_torch.configs import get_smoke_config
from repro_torch.core import sparse as tsp
from repro_torch.core.autotune import KernelPlan
from repro_torch.core.patch import patched
from repro_torch.data import make_dataset, synthetic_lm_batch
from repro_torch.models.gnn import params_from_jax
from repro_torch.optim import adamw, apply_updates
from repro_torch.optim.optimizer import tree_leaves, tree_map
from repro_torch.sampling import (NeighborSampler, pack_block, plan_buckets,
                                  seed_batches)
from repro_torch.sampling import loader as tloader
from repro_torch.testing import FaultPlan
from repro_torch.train import gnn_minibatch as mb
from repro_torch.train import lm as TTL

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 120.0
FANOUTS, HIDDEN, BATCH = (4, 5), 16, 64
LM_ARCH, LM_BATCH, LM_SEQ = "llama3-8b", 4, 32


def _ranks(fn, store, *args, n=2, timeout_s=RANK_TIMEOUT):
    return tdist.run_ranks(fn, n, str(store), args=args, device="cpu",
                           timeout_s=timeout_s)


def _np(tree):
    return tree_map(lambda t: t.detach().float().numpy()
                    if t.dtype == torch.bfloat16 else t.detach().numpy(),
                    tree)


def _tol(want) -> dict:
    return dict(rtol=1e-5, atol=1e-6 * max(1.0, float(np.abs(want).max())))


# --------------------------------------------------------------------------
# mesh, seeds, wire bytes: no ranks needed
# --------------------------------------------------------------------------

def test_mesh_backend_rule_and_shard_count():
    assert tdist.choose_backend("cpu", 2, 8) == "gloo"
    assert tdist.choose_backend("cuda", 2, 1) == "gloo"    # a shared card
    assert tdist.choose_backend("cuda", 2, 2) == "nccl"    # a card a rank
    assert tdist.choose_backend("cuda", 1, 1) == "nccl"
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tdist.choose_backend("cuda", 1, 0)
    one = tdist.make_data_mesh(device="cpu")         # no process group
    assert one.shape == {"data": 1, "model": 1} and one.backend is None
    assert one.index("data") == 0 and one.group("data") is None
    for mesh in (one, types.SimpleNamespace(shape={"data": 3})):
        n = mesh.shape["data"]
        assert tdist.axis_shard_count(mesh) == n
        assert tdist.axis_shard_count(mesh, "pod") == 1
    assert tdist.axis_shard_count(None) == 1
    assert tdist.make_local_mesh(4, device="cpu").shape["data"] == 1
    with pytest.raises(RuntimeError, match="started first"):
        tdist.make_data_mesh(model=2, device="cpu")   # 'model' needs ranks
    with pytest.raises(RuntimeError, match="started first"):
        tdist.make_data_mesh(2, device="cpu")
    # a one-rank mesh's collectives are identities
    g = {"w": torch.arange(6.0).reshape(2, 3)}
    assert tdist.sync_grads(g, one)["w"] is g["w"]
    assert bool(tdist.all_agree(torch.tensor(True), one))
    assert tdist.replicas_equal(g, one)


@pytest.mark.parametrize("n_seeds,batch,shards", [
    (129, 64, 2), (257, 128, 2), (75_777, 1024, 2), (100, 7, 3), (5, 8, 4),
    (64, 64, 1)])
@pytest.mark.parametrize("drop_last", [False, True])
def test_seed_sharding_matches_reference(n_seeds, batch, shards, drop_last):
    seeds = np.random.default_rng(n_seeds).permutation(10 * n_seeds)[
        :n_seeds]
    mesh = types.SimpleNamespace(shape={"data": shards, "model": 1})
    for got, want in zip(tloader.shard_seeds(seeds, mesh),
                         jloader.shard_seeds(seeds, mesh)):
        np.testing.assert_array_equal(got, want)
    n = jloader.num_seed_batches(n_seeds, batch, drop_last,
                                 num_shards=shards)
    assert tloader.num_seed_batches(n_seeds, batch, drop_last,
                                    num_shards=shards) == n
    for si in range(shards):
        kw = dict(seed=3, epoch=2, drop_last=drop_last, num_shards=shards,
                  shard_index=si)
        got = list(tloader.seed_batches(seeds, batch, **kw))
        want = list(jloader.seed_batches(seeds, batch, **kw))
        assert len(got) == len(want) == n       # the lockstep count
        for (gs, gn), (ws, wn) in zip(got, want):
            np.testing.assert_array_equal(gs, ws)
            assert gn == wn


def test_wire_bytes_matches_reference():
    ds = jax_make_dataset("reddit", scale=1 / 512, seed=1)
    init, _, _, _ = jmb.make_block_model("sage-mean", ds.num_features,
                                         HIDDEN, ds.num_classes, 2)
    jp = init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    for wire in ("fp32", "int8"):
        assert tdist.wire_bytes(tp, wire) == jcoll.wire_bytes(jp, wire)
    cfg = get_smoke_config(LM_ARCH)
    lm = TTL.make_train_state(cfg, torch.Generator().manual_seed(0),
                              adamw(1e-3), device="cpu").params
    jlm = tree_map(lambda t: jnp.asarray(t.numpy()), lm)
    for wire in ("fp32", "int8"):
        assert tdist.wire_bytes(lm, wire) == jcoll.wire_bytes(jlm, wire)
    meta = TTL.shaped_batch(cfg, 4, 32)      # meta tensors count too
    assert tdist.wire_bytes(meta) == 4 * 2 * 4 * 32


# --------------------------------------------------------------------------
# collectives on two gloo ranks
# --------------------------------------------------------------------------

def _collective_inputs():
    rng = np.random.default_rng(7)
    return [{"a": rng.standard_normal((5, 7)).astype(np.float32) * (r + 1),
             "b": {"c": rng.standard_normal(33).astype(np.float32),
                   "z": np.zeros(4, np.float32)}}
            for r in range(2)]


def _collective_rank(mesh, inputs):
    r = mesh.index("data")
    x = tree_map(torch.from_numpy, inputs[r])
    bf = torch.from_numpy(inputs[r]["b"]["c"]).to(torch.bfloat16)
    agree = {}
    for flags in ((True, True), (True, False), (False, True),
                  (False, False)):
        agree[flags] = bool(tdist.all_agree(torch.tensor(flags[r]), mesh))
    return dict(
        rank=r, backend=mesh.backend,
        fp32=_np(tdist.sync_grads(x, mesh)),
        fp32_sum=_np(tdist.sync_grads(x, mesh, mean=False)),
        bf16=tdist.sync_grads({"c": bf}, mesh)["c"].view(torch.int16)
        .numpy(),
        int8=_np(tdist.sync_grads(x, mesh, wire="int8")),
        int8_sum=_np(tdist.compressed_psum(x, mesh, mean=False)),
        agree=agree,
        same=tdist.replicas_equal(x if r == 0 else tree_map(
            torch.from_numpy, inputs[0]), mesh),
        differ=tdist.replicas_equal(x, mesh),
        inputs_kept=all(np.array_equal(a, b) for a, b in zip(
            tree_leaves(_np(x)), tree_leaves(inputs[r]))))


def _dp_rank(mesh, coll_inputs, jparams, lm_batch):
    """Every two-rank case of this module in one run of the ranks (a
    spawned rank imports this module, JAX included, which takes seconds:
    one start serves them all). One compute thread a rank: the suite runs
    beside other workers, and each rank's idle threads spin while it
    waits in a collective."""
    torch.set_num_threads(1)
    return dict(coll=_collective_rank(mesh, coll_inputs),
                gnn=_gnn_rank(mesh, jparams), lm=_lm_rank(mesh, lm_batch))


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """The references' single-device results, and the ranks' run."""
    coll_inputs = _collective_inputs()
    jparams, gnn_want = _gnn_reference()
    lm_want = _lm_reference()
    res = _ranks(_dp_rank, tmp_path_factory.mktemp("dp"), coll_inputs,
                 jparams, _lm_batch())
    return dict(coll=(coll_inputs, [r["coll"] for r in res]),
                gnn=(gnn_want, [r["gnn"] for r in res]),
                lm=(lm_want, [r["lm"] for r in res]))


@pytest.fixture(scope="module")
def collective_run(dp_run):
    return dp_run["coll"]


def test_sync_grads_fp32_is_the_local_mean_bitwise(collective_run):
    inputs, res = collective_run
    for r, got in enumerate(res):
        assert got["rank"] == r and got["backend"] == "gloo"
        assert got["inputs_kept"]           # the sync copies, never writes
        for g, s, a, b in zip(tree_leaves(got["fp32"]),
                              tree_leaves(got["fp32_sum"]),
                              tree_leaves(inputs[0]), tree_leaves(inputs[1])):
            np.testing.assert_array_equal(s, a + b)
            np.testing.assert_array_equal(g, (a + b) / np.float32(2))
        a, b = (torch.from_numpy(inputs[i]["b"]["c"]).to(torch.bfloat16)
                for i in (0, 1))
        np.testing.assert_array_equal(
            got["bf16"], ((a + b) / 2).view(torch.int16).numpy())


def test_compressed_psum_matches_reference_bitwise(collective_run):
    inputs, res = collective_run
    for key in ("a",), ("b", "c"), ("b", "z"):
        xs = [jnp.asarray(inp[key[0]] if len(key) == 1
                          else inp[key[0]][key[1]]) for inp in inputs]
        amax = jnp.maximum(*(jnp.max(jnp.abs(x)) for x in xs))
        qs = [jax_int8_compress(x, amax=amax) for x in xs]
        total = sum(q.astype(jnp.int32) for q, _ in qs)
        want = np.asarray(jax_int8_decompress(total, qs[0][1]))
        for got in res:
            s = got["int8_sum"][key[0]] if len(key) == 1 else \
                got["int8_sum"][key[0]][key[1]]
            m = got["int8"][key[0]] if len(key) == 1 else \
                got["int8"][key[0]][key[1]]
            np.testing.assert_array_equal(s, want)
            np.testing.assert_array_equal(m, want / np.float32(2))
            # within the shared quantum of the exact mean
            exact = (np.asarray(xs[0]) + np.asarray(xs[1])) / 2
            assert np.abs(m - exact).max() <= float(amax) / 127 + 1e-7


def test_all_agree_is_false_on_every_rank_when_one_is_false(collective_run):
    _, res = collective_run
    for got in res:
        assert got["agree"] == {(True, True): True, (True, False): False,
                                (False, True): False, (False, False): False}
        assert got["same"] and not got["differ"]


def _failing_rank(mesh):
    if mesh.index("data") == 1:
        raise ValueError("rank 1 fails on purpose")
    time.sleep(3 * RANK_TIMEOUT)        # killed by the helper, never woken


def _sleeping_rank(mesh):
    time.sleep(3 * RANK_TIMEOUT)


def test_run_ranks_kills_the_others_when_one_fails_or_overruns(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        _ranks(_failing_rank, tmp_path / "fail")
    with pytest.raises(RuntimeError, match="did not finish within 3 s"):
        _ranks(_sleeping_rank, tmp_path / "slow", timeout_s=3.0)
    assert time.monotonic() - t0 < RANK_TIMEOUT
    assert not os.listdir(tmp_path / "fail")    # the rendezvous removed


# --------------------------------------------------------------------------
# the lockstep minibatch step and trainer on two gloo ranks
# --------------------------------------------------------------------------

def _shard_batch(ds, csr, shard, sampler_cls, pack, plan_buckets_fn, plan):
    """Shard ``shard``'s first batch of epoch 0 (two shards), sampled with
    the trainer's host round and packed with the pinned plan."""
    train_ids = np.nonzero(np.asarray(ds.train_mask))[0]
    seed_ids, n_real = next(iter(seed_batches(
        train_ids, BATCH, seed=0, epoch=0, num_shards=2, shard_index=shard)))
    blocks = sampler_cls(csr, FANOUTS, seed=0).sample(seed_ids[:n_real],
                                                      round=shard)
    buckets = plan_buckets_fn(blocks, batch_size=BATCH, fanouts=FANOUTS,
                              base=32)
    pbs = [pack(b, plan=plan, n_dst=k.n_dst, n_src=k.n_src, nnz=k.nnz,
                ell_width=k.ell_width, sell_steps=k.sell_steps)
           for b, k in zip(blocks, buckets)]
    return pbs, seed_ids, n_real


def _lockstep_dataset(ds):
    import dataclasses
    mask = torch.zeros(ds.num_nodes, dtype=torch.bool)
    mask[:129] = True                   # 65 + 64 seeds: 2 and 1 batches
    return dataclasses.replace(ds, train_mask=mask)


def _gnn_rank(mesh, jparams):
    r = mesh.index("data")
    ds = make_dataset("reddit", scale=1 / 512, seed=1)
    csr = tsp.csr_from_coo(ds.coo)
    params = params_from_jax(jparams, device="cpu")
    _, _, apply, _ = mb.make_block_model("sage-mean", ds.num_features,
                                         HIDDEN, ds.num_classes, 2)
    opt = adamw(1e-2, weight_decay=5e-4)
    batches = [_shard_batch(ds, csr, s, NeighborSampler, pack_block,
                            plan_buckets, KernelPlan(kind="ell"))
               for s in (0, 1)]

    def run(step, batch):
        pbs, sids, n_real = batch
        with patched(True):
            return step(params, opt.init(params), pbs,
                        torch.from_numpy(sids), n_real, ds.x, ds.y,
                        mb.init_step_stats("cpu"), step_idx=0)

    one = mb.make_minibatch_step(apply, opt, batch_size=BATCH)
    local = [run(one, b) for b in batches]
    mean = tree_map(lambda a, b: (a + b) / 2, local[0][3], local[1][3])
    updates, _ = opt.update(mean, opt.init(params), params)
    want_p = apply_updates(params, updates)
    got = run(mb.make_minibatch_step(apply, opt, batch_size=BATCH,
                                     mesh=mesh), batches[r])
    same = run(mb.make_minibatch_step(apply, opt, batch_size=BATCH,
                                      mesh=mesh), batches[0])
    got8 = run(mb.make_minibatch_step(apply, opt, batch_size=BATCH,
                                      mesh=mesh, grad_sync="int8"),
               batches[r])

    def bitwise(a, b):
        return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                     tree_leaves(b)))
    out = dict(
        synced=_np(got[3]), loss=float(got[2]),
        local_losses=[float(l[2]) for l in local],
        synced_is_local_mean=bitwise(got[3], mean),
        params_are_mean_update=bitwise(got[0], want_p),
        same_is_one_rank=bitwise(same[3], local[0][3])
        and bitwise(same[0], local[0][0])
        and torch.equal(same[2], local[0][2]),
        int8=_np(got8[3]), mean=_np(mean),
        skipped=[s[4].drain()["skipped"] for s in (got, same, got8)])

    small = _lockstep_dataset(ds)
    runs = {}
    for name, kw in (("host", dict(sampler="host")),
                     ("device_nan", dict(sampler="device", faults=FaultPlan(
                         nan_grad_at=(1, 1)))),
                     ("int8", dict(sampler="device", grad_sync="int8"))):
        obs.reset()
        res = mb.train_gnn_minibatch(
            "sage-mean", small, fanouts=FANOUTS, batch_size=BATCH,
            hidden=HIDDEN, epochs=2, seed=0, mesh=mesh, device="cpu",
            profile=True, **kw)
        steps = sum(s.name == "train.step"
                    for s in obs.get_tracer().snapshot())
        runs[name] = dict(
            losses=res.losses, steps=steps,
            steps_per_epoch=res.steps_per_epoch, skipped=res.skipped_steps,
            num_shards=res.num_shards, grad_sync=res.grad_sync,
            sync_bytes=res.sync_bytes_per_step,
            replicas=tdist.replicas_equal(res.final_params, mesh),
            params=_np(res.final_params))
    obs.disable()
    out["runs"] = runs
    return out


def _gnn_reference():
    """The reference's init and its 1-device step's loss and gradients on
    each shard's batch."""
    ref_ds = jax_make_dataset("reddit", scale=1 / 512, seed=1)
    init, _, japply, _ = jmb.make_block_model("sage-mean",
                                              ref_ds.num_features, HIDDEN,
                                              ref_ds.num_classes, 2)
    jparams = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0)))
    jcsr = jsp.csr_from_coo(ref_ds.coo)
    jopt = jax_adamw(1e-2, weight_decay=5e-4)
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    jstep = jmb.make_minibatch_step(japply, jopt, batch_size=BATCH)
    want = []
    for shard in (0, 1):
        pbs, sids, n_real = _shard_batch(ref_ds, jcsr, shard, JSampler,
                                         jax_pack_block, jax_plan_buckets,
                                         JPlan(kind="ell"))
        with jax_patched(True):
            out = jstep(jp, jopt.init(jp), tuple(pbs), jnp.asarray(sids),
                        jnp.asarray(n_real), jnp.asarray(ref_ds.x),
                        jnp.asarray(ref_ds.y), jnp.int32(0),
                        jmb.init_step_stats())
        want.append((float(out[2]), jax.tree_util.tree_map(np.asarray,
                                                           out[3])))
    return jparams, want


@pytest.fixture(scope="module")
def gnn_run(dp_run):
    return dp_run["gnn"]


def test_minibatch_step_syncs_the_mean_of_the_reference_grads(gnn_run):
    want, res = gnn_run
    ref_mean = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, want[0][1],
                                      want[1][1])
    for r, got in enumerate(res):
        for layer in ref_mean:
            for name, g in ref_mean[layer].items():
                np.testing.assert_allclose(got["synced"][layer][name], g,
                                           **_tol(g),
                                           err_msg=f"rank {r} {layer}.{name}")
        np.testing.assert_allclose(got["local_losses"],
                                   [w[0] for w in want], rtol=1e-5)
        assert got["loss"] == np.float32(
            (np.float32(got["local_losses"][0]) +
             np.float32(got["local_losses"][1])) / np.float32(2))
        assert got["synced_is_local_mean"] and got["params_are_mean_update"]
        assert got["skipped"] == [0, 0, 0]


def test_minibatch_step_identical_batches_equal_one_rank_and_int8(gnn_run):
    _, res = gnn_run
    for got in res:
        assert got["same_is_one_rank"]
        for q, m in zip(tree_leaves(got["int8"]), tree_leaves(got["mean"])):
            assert np.abs(q - m).max() <= np.abs(m).max() / 127 * 1.0001
    for a, b in zip(tree_leaves(res[0]["int8"]), tree_leaves(res[1]["int8"])):
        np.testing.assert_array_equal(a, b)


def test_trainer_runs_in_lockstep_with_equal_replicas(gnn_run):
    _, res = gnn_run
    for name in ("host", "int8"):
        runs = [got["runs"][name] for got in res]
        for run in runs:
            # 65 and 64 seeds: 2 and 1 batches, padded to 2 on both ranks
            assert run["steps_per_epoch"] == 2 and run["steps"] == 4
            assert run["num_shards"] == 2 and run["replicas"]
            assert run["sync_bytes"] > 0 and run["skipped"] == 0
            assert np.isfinite(run["losses"]).all() and len(
                run["losses"]) == 2
        assert runs[0]["losses"] == runs[1]["losses"]
        for a, b in zip(tree_leaves(runs[0]["params"]),
                        tree_leaves(runs[1]["params"])):
            np.testing.assert_array_equal(a, b)
    assert res[0]["runs"]["int8"]["grad_sync"] == "int8"
    assert res[0]["runs"]["int8"]["sync_bytes"] < \
        res[0]["runs"]["host"]["sync_bytes"]


def test_nan_on_one_rank_skips_the_step_on_both(gnn_run):
    _, res = gnn_run
    for got in res:
        run = got["runs"]["device_nan"]
        assert run["skipped"] == 1 and run["replicas"]
        assert run["steps"] == 4 and np.isfinite(run["losses"]).all()
        assert all(np.isfinite(p).all() for p in tree_leaves(run["params"]))


# --------------------------------------------------------------------------
# the data-parallel LM step on two gloo ranks
# --------------------------------------------------------------------------

def _lm_batch():
    toks, tgts = synthetic_lm_batch(LM_BATCH, LM_SEQ,
                                    get_smoke_config(LM_ARCH).vocab, step=3)
    return {"tokens": toks, "targets": tgts}


def _lm_rank(mesh, batch_np):
    r = mesh.index("data")
    cfg = get_smoke_config(LM_ARCH)
    step, opt = TTL.make_data_parallel_step(cfg, mesh, lr=1e-3)
    state = TTL.make_train_state(cfg, torch.Generator().manual_seed(0), opt,
                                 device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    half = LM_BATCH // 2
    local = [TTL.loss_and_grads(cfg, state.params,
                                {k: v[i * half:(i + 1) * half]
                                 for k, v in batch.items()})
             for i in (0, 1)]
    mean = tree_map(lambda a, b: (a + b) / 2, local[0][2], local[1][2])
    synced = []
    real = TTL.sync_grads

    def record(*args, **kw):
        synced.append(real(*args, **kw))
        return synced[-1]

    TTL.sync_grads = record
    try:
        losses, replicas = [], []
        for _ in range(5):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            replicas.append(tdist.replicas_equal(state.params, mesh))
        step8, opt8 = TTL.make_data_parallel_step(cfg, mesh, lr=1e-3,
                                                  compression=True)
        st8 = TTL.make_train_state(cfg, torch.Generator().manual_seed(0),
                                   opt8, compression=True, device="cpu")
        ef0 = _np(st8.ef.residual)
        st8, m8 = step8(st8, batch)
    finally:
        TTL.sync_grads = real
    return dict(
        rank=r, synced=_np(synced[0]), losses=losses, replicas=replicas,
        local_losses=[float(l[0]) for l in local],
        synced_is_local_mean=all(torch.equal(a, b) for a, b in zip(
            tree_leaves(synced[0]), tree_leaves(mean))),
        int8_loss=float(m8["loss"]),
        int8_finite=all(bool(torch.isfinite(p).all())
                        for p in tree_leaves(st8.params)),
        ef_untouched=all(np.array_equal(a, b) for a, b in zip(
            tree_leaves(ef0), tree_leaves(_np(st8.ef.residual)))))


def _lm_reference():
    """The reference's loss and gradients on each half of the batch."""
    jcfg = jax_smoke_config(LM_ARCH)
    cfg = get_smoke_config(LM_ARCH)
    tp = TTL.make_train_state(cfg, torch.Generator().manual_seed(0),
                              adamw(1e-3), device="cpu").params
    jp = tree_map(lambda t: jnp.array(t.numpy(), copy=True), tp)
    batch = _lm_batch()
    grad = jax.jit(jax.value_and_grad(lambda p, bt: JT.loss_fn(jcfg, p, bt),
                                      has_aux=True))
    half = LM_BATCH // 2
    want = []
    for i in (0, 1):
        (loss, _), g = grad(jp, {k: jnp.asarray(v[i * half:(i + 1) * half])
                                 for k, v in batch.items()})
        want.append((float(loss), jax.tree_util.tree_map(np.asarray, g)))
    return want


@pytest.fixture(scope="module")
def lm_run(dp_run):
    return dp_run["lm"]


def _walk(got, want, fn, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _walk(got[k], want[k], fn, f"{path}/{k}")
        else:
            fn(got[k], want[k], f"{path}/{k}")


def test_lm_data_parallel_step_syncs_the_reference_mean(lm_run):
    want, res = lm_run
    ref = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, want[0][1],
                                 want[1][1])

    def close(g, w, what):
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=what)
    for got in res:
        _walk(got["synced"], ref, close)
        assert got["synced_is_local_mean"]
        np.testing.assert_allclose(got["local_losses"], [w[0] for w in want],
                                   rtol=1e-5)
        assert got["losses"][0] == np.float32(
            (np.float32(got["local_losses"][0]) +
             np.float32(got["local_losses"][1])) / np.float32(2))


def test_lm_data_parallel_step_trains_and_keeps_replicas(lm_run):
    _, res = lm_run
    assert res[0]["losses"] == res[1]["losses"]
    for got in res:
        assert all(got["replicas"]) and np.isfinite(got["losses"]).all()
        assert got["losses"][-1] < got["losses"][0], got["losses"]
        assert np.isfinite(got["int8_loss"]) and got["int8_finite"]
        assert got["ef_untouched"]      # the wire's quantizer is stateless


def test_lm_data_parallel_step_checks_the_batch_split():
    cfg = get_smoke_config(LM_ARCH)
    mesh = types.SimpleNamespace(shape={"data": 3}, index=lambda a: 0,
                                 group=lambda a: None)
    step, opt = TTL.make_data_parallel_step(cfg, mesh)
    state = TTL.make_train_state(cfg, torch.Generator().manual_seed(0), opt,
                                 device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _lm_batch().items()}
    with pytest.raises(ValueError, match="does not split over the 3 ranks"):
        step(state, batch)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

def test_launcher_trains_data_parallel_on_cpu_ranks(tmp_path):
    """Two ranks it starts itself; a fault injected at step 7 fails that
    step on both ranks, which restore the same emergency checkpoint (rank
    0 writes it) and finish with a lower loss; only rank 0 prints. One
    compute thread a rank (``OMP_NUM_THREADS``), as the suite's other
    workers share the cores."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--mode", "lm",
           "--arch", LM_ARCH, "--smoke", "--mesh-data", "2", "--grad-sync",
           "shardmap", "--device", "cpu", "--steps", "20", "--lr", "3e-3",
           "--inject-fault", "7", "--ckpt-every", "5", "--ckpt-dir",
           str(tmp_path / "ckpt")]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=RANK_TIMEOUT, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("[lm] llama3-smoke (dense) on cpu, mesh "
                               "{'data': 2, 'model': 1} (gloo)"), lines[0]
    assert sum(line.startswith("[lm]") for line in lines) == 1
    assert "restarts=1 emergency_saves=1 last step 20" in out.stdout
    assert "loss decreased: OK" in out.stdout
    from repro_torch.ckpt import latest_step
    assert latest_step(str(tmp_path / "ckpt")) == 20
    bad = subprocess.run(cmd[:-2] + ["--mesh-model", "2"], capture_output=True,
                         text=True, env=env, timeout=RANK_TIMEOUT)
    # the explicit data-parallel step replicates the params over the mesh
    assert bad.returncode == 2 and \
        "--grad-sync shardmap with --mesh-model > 1" in bad.stderr
