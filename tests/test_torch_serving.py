"""The port's serving slice against the JAX reference: autotuner picks,
the TuningDB, the feature cache, and whole-slice parity — the same params
(initialized by the reference, handed over as numpy) and the same seeds
served by both packages' ``GNNServer`` in ``sampled`` and ``full`` modes.

Whole-slice tolerance: rtol 1e-4, atol 1e-5 times the largest logit
magnitude of the reference answer (at least 1e-5). Both sides sum the same
fp32 terms in another order (XLA segment sums vs ``index_add_`` and the
packed ELL/SELL reductions), so the absolute error follows the size of the
summed terms: GIN's full-neighbor sums reach logits of a few hundred,
where one fp32 ulp is already ~3e-5."""
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from repro.core.autotune import HardwareModel as JHardware
from repro.core.autotune import TuningDB as JTuningDB
from repro.core.autotune import autotune as jax_autotune
from repro.serving import GNNServer as JServer
from repro.serving.server import SERVE_MODES as JSERVE_MODES
from repro.train.gnn_minibatch import make_block_model as jax_block_model

from repro_torch import obs
from repro_torch.core import sparse as tsp
from repro_torch.core.autotune import (H100, TPU_V5E, KernelPlan, TuningDB,
                                       autotune, probe_hardware)
from repro_torch.data import make_dataset
from repro_torch.kernels import ops as tops
from repro_torch.models.gnn import params_from_jax
from repro_torch.sampling import BlockPlanCache, NeighborSampler
from repro_torch.serving import FeatureCache, GNNServer
from repro_torch.serving.server import SERVE_MODES
from repro_torch.train.gnn_minibatch import make_block_model

from conftest import random_coo

FANOUTS = (5, 5)
SEED_SETS = ([3, 7, 11], [0], list(range(20, 52)))


def _port_coo(coo):
    return tsp.coo_from_edges(np.asarray(coo.col)[: coo.nse],
                              np.asarray(coo.row)[: coo.nse],
                              np.asarray(coo.val)[: coo.nse],
                              coo.nrows, coo.ncols)


# --------------------------------------------------------------------------
# autotuner and TuningDB
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 48, 500), (200, 120, 900),
                                   (90, 300, 400)])
@pytest.mark.parametrize("k", [16, 128, 256, 602])
@pytest.mark.parametrize("semiring", ["sum", "mean", "max"])
def test_autotune_v5e_model_matches_reference(rng, shape, k, semiring):
    ref, _ = random_coo(rng, *shape)
    want = jax_autotune(ref, k, hw=JHardware(), semiring_reduce=semiring)
    got = autotune(_port_coo(ref), k, hw=TPU_V5E, semiring_reduce=semiring)
    # every field of the reference's model, and the port's BSR fields at
    # their defaults: the reference's Pallas kernel and its rule
    ref_hw = dataclasses.asdict(JHardware())
    port_hw = dataclasses.asdict(TPU_V5E)
    assert {f: port_hw.pop(f) for f in ref_hw} == ref_hw
    assert port_hw == dict(bsr_k_tile=0, bsr_depth=1, bsr_rows=(),
                           bsr_flops=0.0)
    assert got.to_json() == want.to_json()


def test_h100_model_reaches_kernels_at_k602(tiny_dataset):
    """Layer 0 of a sampled reddit flush (K = 602, not a multiple of 128)
    is gated to trusted by the TPU model and reaches a kernel on H100."""
    ds = make_dataset("reddit", scale=1 / 512, seed=1)
    blk = NeighborSampler(tsp.csr_from_coo(ds.coo), (10, 25),
                          seed=0).sample(np.arange(64))[0]
    rep = tsp.COO(row=blk.row, col=blk.col, val=blk.val, nrows=blk.n_dst,
                  ncols=blk.n_src, nse=blk.nnz)
    plan = autotune(rep, 602, hw=H100, tile_candidates=())
    assert plan.kind in ("ell", "sell") and plan.k_hint == 602
    assert plan.est_generated_s < plan.est_trusted_s
    assert autotune(rep, 602, hw=TPU_V5E, tile_candidates=()).kind == \
        "trusted"
    assert H100.lane == 1 and H100.sublane == 1
    assert H100.hbm_bw == 3.35e12 and H100.vmem_bytes == 232_448
    assert probe_hardware() is H100


def test_measured_tuning_not_ported(rng):
    ref, _ = random_coo(rng, 20, 20, 50)
    with pytest.raises(NotImplementedError, match="CUDA events"):
        autotune(_port_coo(ref), 16, measure=True)


def test_tuning_db_round_trip_and_reference_format(tmp_path, rng):
    ref, _ = random_coo(rng, 40, 30, 120)
    coo = _port_coo(ref)
    path = str(tmp_path / "db.json")
    db = TuningDB(path)
    plan = KernelPlan(kind="sell", sell_c=16, k_hint=602,
                      est_generated_s=1e-6, est_trusted_s=3e-6)
    db.put(coo, 602, plan, semiring="mean")
    db.put_key("block128x256nse1280k602srmean", plan)
    db.save()
    again = TuningDB(path)
    assert len(again) == 2 and again.get(coo, 602, "mean") == plan
    assert TuningDB.key(coo, 602, "mean") == JTuningDB.key(ref, 602, "mean")
    # the reference reads the port's file (same schema-2 envelope)
    assert JTuningDB(path).get_key(
        "block128x256nse1280k602srmean").sell_c == 16


def test_tuning_db_quarantines_corrupt_file(tmp_path):
    path = tmp_path / "db.json"
    path.write_text("{not json")
    with pytest.warns(UserWarning, match="quarantined"):
        db = TuningDB(str(path))
    assert len(db) == 0 and (tmp_path / "db.json.corrupt").exists()


def test_block_plan_cache_uses_pinned_db_plan(tmp_path):
    ds = make_dataset("reddit", scale=1 / 512, seed=1)
    blk = NeighborSampler(tsp.csr_from_coo(ds.coo), (4, 4),
                          seed=0).sample(np.arange(8))[1]
    db = TuningDB(str(tmp_path / "db.json"))
    pinned = KernelPlan(kind="ell", k_hint=16)
    db.put_key(BlockPlanCache.key(16, 128, 64, 16, "mean"), pinned)
    cache = BlockPlanCache(semiring="mean", db=db)
    assert cache.plan_for(blk, n_dst=16, n_src=128, nnz=64,
                          k_hint=16) == pinned


# --------------------------------------------------------------------------
# feature cache
# --------------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [0, 1, 6, 64])
def test_feature_cache_rows_are_bitwise_fallback(capacity):
    x = np.random.default_rng(3).standard_normal((40, 5)).astype(np.float32)
    cache = FeatureCache(x, capacity, device="cpu")
    for ids in ([1, 2, 3, 40], [3, 2, 9, 41], [1, 2, 3, 40], list(range(12))):
        got = cache.gather(np.asarray(ids))
        assert torch.equal(got, cache.gather_reference(np.asarray(ids)))
        cache.check_consistency()
    if capacity == 0:
        assert cache.stats.insertions == 0
    if capacity >= 6:
        assert cache.stats.hits > 0
    assert len(cache.cached_ids()) <= capacity


# --------------------------------------------------------------------------
# whole slice: the port's GNNServer against the reference's
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_dataset():
    return make_dataset("reddit", scale=1 / 512, seed=1)


@pytest.fixture(scope="module", params=["sage-sum", "sage-mean", "gin"])
def arch_params(request, tiny_dataset):
    init, _, _, _ = jax_block_model(request.param,
                                    tiny_dataset.num_features, 16,
                                    tiny_dataset.num_classes, len(FANOUTS))
    jp = init(jax.random.PRNGKey(0))
    return request.param, jp, jax.tree_util.tree_map(np.asarray, jp)


def _tolerance(want: np.ndarray) -> dict:
    return dict(rtol=1e-4, atol=1e-5 * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("mode", ["sampled", "full"])
@pytest.mark.parametrize("tune", [False, True])
def test_serving_matches_reference(arch_params, tiny_dataset, port_dataset,
                                   mode, tune):
    arch, jp, np_params = arch_params
    common = dict(arch=arch, fanouts=FANOUTS, mode=mode, tune=tune,
                  start=False, cache_capacity=256)
    ref = JServer(jp, tiny_dataset, **common)
    port = GNNServer(params_from_jax(np_params, device="cpu"), port_dataset,
                     device="cpu", **common)
    for seeds in SEED_SETS:
        want, got = ref.predict(seeds), port.predict(seeds)
        assert got.shape == want.shape == (len(seeds),
                                           tiny_dataset.num_classes)
        np.testing.assert_allclose(got, want, **_tolerance(want))
    if tune:      # the port's H100 tuner takes K = 602 to the kernels
        assert set(port.plan_cache.kinds()) & {"ell", "sell"}
    assert port.cache.stats.hits > 0


@pytest.mark.parametrize("tune", [False, True])
def test_historical_and_offline_logits_match_reference(
        arch_params, tiny_dataset, port_dataset, tune):
    """Historical mode (one full-neighbour hop over the layer-(L-1)
    matrix of the offline sweep) and ``offline_logits`` against the
    reference's, before and after ``refresh_embeddings``; historical
    answers also equal the offline rows."""
    arch, jp, np_params = arch_params
    common = dict(arch=arch, fanouts=FANOUTS, mode="historical", tune=tune,
                  start=False, cache_capacity=64)
    ref = JServer(jp, tiny_dataset, **common)
    port = GNNServer(params_from_jax(np_params, device="cpu"), port_dataset,
                     device="cpu", **common)
    want_off = ref.offline_logits()
    got_off = port.offline_logits()
    assert got_off.shape == (port_dataset.num_nodes,
                             port_dataset.num_classes)
    np.testing.assert_allclose(got_off, want_off, **_tolerance(want_off))
    for refresh in (False, True):
        if refresh:
            ref.refresh_embeddings()
            port.refresh_embeddings()
            assert port.cache.epoch == ref.cache.epoch == 1
        for seeds in SEED_SETS:
            want, got = ref.predict(seeds), port.predict(seeds)
            np.testing.assert_allclose(got, want, **_tolerance(want))
            np.testing.assert_allclose(got, got_off[seeds],
                                       **_tolerance(want))
    assert port.cache.stats.hits > 0 and port.cache.stats.stale > 0


def test_params_from_jax_and_generator_init(arch_params):
    arch, _, np_params = arch_params
    tp = params_from_jax(np_params, device="cpu")
    assert tp.keys() == np_params.keys()
    for layer, p in np_params.items():
        for name, leaf in p.items():
            assert torch.equal(tp[layer][name],
                               torch.tensor(np.asarray(leaf)))
    init, _, _, dims = make_block_model(arch, 602, 16, 41, 2)
    a = init(torch.Generator().manual_seed(0), device="cpu")
    b = init(torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a[layer][n], b[layer][n])
               for layer in a for n in a[layer])
    assert dims == [602, 16, 41]


def test_unported_modes_and_missing_card_raise(tiny_dataset, port_dataset):
    """Every mode of the reference is ported; an unknown one raises, and
    so does the card's default device where there is no card."""
    init, _, _, _ = make_block_model("sage-mean", 602, 16, 41, 2)
    params = init(torch.Generator().manual_seed(0), device="cpu")
    assert SERVE_MODES == JSERVE_MODES
    with pytest.raises(ValueError, match="mode must be one of"):
        GNNServer(params, port_dataset, mode="stale", device="cpu",
                  start=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GNNServer(params, port_dataset, start=False)


def test_threaded_clients_and_stop_drains(port_dataset):
    init, _, _, _ = make_block_model("sage-mean", 602, 16, 41, 2)
    params = init(torch.Generator().manual_seed(1), device="cpu")
    srv = GNNServer(params, port_dataset, arch="sage-mean", fanouts=(4, 4),
                    mode="sampled", device="cpu", max_batch=8,
                    max_delay_s=0.002)
    results, errors = {}, []

    def client(i):
        try:
            results[i] = srv.predict([i, i + 100], timeout=60.0)
        except Exception as exc:           # surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
    late = srv.submit([5])
    srv.stop()
    assert not errors and all(not t.is_alive() for t in threads)
    assert late.done() and late.result(1.0).shape == (1, 41)
    assert sorted(results) == list(range(8))
    assert all(np.isfinite(r).all() and r.shape == (2, 41)
               for r in results.values())
    st = srv.latency_stats()
    assert st["requests"] == 9 and st["p99_ms"] >= st["p50_ms"] > 0


def test_profiled_flush_records_spans_and_ops(port_dataset):
    init, _, _, _ = make_block_model("sage-mean", 602, 16, 41, 2)
    params = init(torch.Generator().manual_seed(2), device="cpu")
    srv = GNNServer(params, port_dataset, arch="sage-mean",
                    fanouts=(10, 25), mode="sampled", device="cpu",
                    start=False)
    tops.reset_kernel_launches()
    with obs.profiled() as tracer:
        srv.predict([1, 2, 3])
    names = {s.name for s in tracer.snapshot()}
    assert {"serve.flush", "serve.sample", "serve.pack", "serve.gather",
            "serve.apply", "op.block_spmm"} <= names
    assert names & {"op.ell_spmm", "op.sell_spmm"}
    assert not obs.enabled()
    # on the CPU the plain versions ran: no kernel launch was counted
    launches = tops.kernel_launches()
    assert {"ell_spmm", "sell_spmm", "bsr_spmm"} <= set(launches)
    assert not any(launches.values())
