"""The port's sharding rules and partition tables (``repro_torch.dist.
sharding``, ``dist.partition``, the mesh builders of ``dist.mesh``,
``train/lm.shaped_*(mesh=)``) against the JAX reference, on the CPU,
without ranks.

The reference's rules only read a mesh's ``shape``, so a plain object
with a ``shape`` dict stands in for its meshes: ``{data: 2, model: 2}``,
``{data: 1, model: 4}`` and the production 16 x 16 and 2 x 16 x 16. Its
parameter shapes come from ``jax.eval_shape`` of its ``init_params``
(full configs too: nothing is allocated); the port's from
``init_params`` on the ``meta`` device. Every leaf of every config in
the registry, full and smoke, must get the reference's logical axes and
spec, and the port's ``param_shardings`` the same spec and each rank's
block of it. The cache and batch axes, ``graph2d_shardings``, the rule
sets' override and nesting, and the guard that refuses to cut a head
are checked the same way."""
import types

import jax
import numpy as np
import pytest
import torch

import repro.models.lm.transformer as JT
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.dist import partition as jpart
from repro.dist import sharding as jsh

from repro_torch import dist as tdist
from repro_torch.configs import arch_names, get_config, get_smoke_config
from repro_torch.dist import partition as tpart
from repro_torch.dist import sharding as tsh
from repro_torch.models.lm import transformer as TT
from repro_torch.optim import adamw
from repro_torch.optim.optimizer import tree_leaves
from repro_torch.train import lm as TTL

MESHES = {"d2m2": {"data": 2, "model": 2}, "d1m4": {"data": 1, "model": 4},
          "pod": {"data": 16, "model": 16},
          "multipod": {"pod": 2, "data": 16, "model": 16}}


def _stand_in(shape: dict, coords: dict | None = None):
    """A shape-only mesh of the port (what ``make_production_mesh``
    builds), at ``coords``."""
    return tdist.Mesh(shape=dict(shape), coords=coords or {k: 0 for k in
                                                          shape},
                      device=torch.device("meta"), backend=None,
                      groups={k: None for k in shape}, abstract=True)


def _configs(arch):
    return ((get_config(arch), jax_config(arch)),
            (get_smoke_config(arch), jax_smoke_config(arch)))


def _flat_port(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_port(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


def _jspec(axes, mesh_shape, shape):
    return tuple(jsh.resolve_spec(axes, types.SimpleNamespace(
        shape=mesh_shape), shape, jpart.LM_RULES))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", arch_names())
def test_param_axes_and_specs_match_reference(arch, mesh_name):
    shape = MESHES[mesh_name]
    mesh = _stand_in(shape, {k: v - 1 for k, v in shape.items()})
    for cfg, jcfg in _configs(arch):
        jshapes = jax.eval_shape(lambda: JT.init_params(
            jcfg, jax.random.PRNGKey(0)))
        jleaves = jax.tree_util.tree_flatten_with_path(jshapes)[0]
        port = _flat_port(TT.init_params(cfg, None, device="meta"))
        sh = _flat_port(tpart.param_shardings(mesh, TT.init_params(
            cfg, None, device="meta")))
        assert len(port) == len(jleaves), cfg.name
        for jpath, leaf in jleaves:
            key = tuple(k.key for k in jpath)
            got = port[key]
            assert tuple(got.shape) == tuple(leaf.shape), key
            axes = jpart.param_logical_axes(jpath, leaf)
            assert tpart.param_logical_axes(key, got) == tuple(axes), key
            want = _jspec(axes, shape, leaf.shape)
            assert tsh.resolve_spec(axes, mesh, leaf.shape) == want, key
            assert sh[key].spec == want, key
            # this rank (the last coordinate on every axis) holds the
            # last block of each split dim
            local = sh[key].local_shape(leaf.shape)
            for i, n in enumerate(leaf.shape):
                k = int(np.prod([shape[a] for a in sh[key].dim_axes(i)]))
                assert local[i] * k == n, (key, i)
                assert sh[key].block(i) == k - 1, (key, i)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", arch_names())
def test_cache_and_batch_axes_match_reference(arch, mesh_name):
    shape = MESHES[mesh_name]
    mesh = _stand_in(shape)
    cfg, jcfg = get_config(arch), jax_config(arch)
    for b in (1, 32):
        want = jax.eval_shape(lambda: JT.init_cache(jcfg, b, 4096))
        got = TT.init_cache(cfg, b, 4096, device="meta")
        assert set(got) == set(want)
        sh = tpart.cache_shardings(mesh, got)
        for key, spec in want.items():
            assert tuple(got[key].shape) == spec.shape, key
            axes = jpart._CACHE_AXES.get(key, ())
            axes = tuple(axes)[:len(spec.shape)] + (None,) * max(
                0, len(spec.shape) - len(axes))
            assert sh[key].spec == _jspec(axes, shape, spec.shape), key
        local = TTL.shaped_cache(cfg, b, 4096, mesh=mesh)
        for key, t in local.items():
            assert tuple(t.shape) == t.sharding.local_shape(
                want[key].shape), key
        batch = TTL.shaped_batch(cfg, b, 2048)
        for key, s in tpart.batch_shardings(mesh, batch).items():
            axes = ("batch", "seq") + (None,) * (batch[key].dim() - 2)
            assert s.spec == _jspec(axes, shape, tuple(batch[key].shape))


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "qwen2-1.5b",
                                  "mixtral-8x7b"])
def test_shaped_state_carries_the_params_shardings(arch):
    """``shaped_state(mesh=)``: params and both moments in each rank's
    block of the whole leaf, by the params' spec."""
    mesh = tdist.make_production_mesh()
    cfg = get_config(arch)
    opt = adamw(1e-3, state_dtype=torch.float32)
    whole = TTL.shaped_state(cfg, opt)
    local = TTL.shaped_state(cfg, opt, mesh=mesh)
    sh = tpart.param_shardings(mesh, whole.params)
    for tree in (local.params, local.opt_state.mu, local.opt_state.nu):
        for t, w, s in zip(tree_leaves(tree), tree_leaves(whole.params),
                           tree_leaves(sh)):
            assert t.device.type == "meta"
            assert t.sharding.spec == s.spec
            assert tuple(t.shape) == s.local_shape(w.shape)
    assert local.opt_state.step.shape == ()


def test_graph2d_shardings_spec_matches_reference():
    jmesh = jax.make_mesh((1, 1), ("row", "col"))
    arrays = {"idx": np.zeros((4, 6, 3), np.int32),
              "inv_deg": np.zeros((12,), np.float32)}
    want = jpart.graph2d_shardings(jmesh, arrays)
    got = tpart.graph2d_shardings(_stand_in({"row": 2, "col": 2}), arrays)
    for key in arrays:
        assert got[key].spec == tuple(want[key].spec), key
    # a ('data', 'model') mesh runs the grid over its first two axes
    got = tpart.graph2d_shardings(_stand_in(MESHES["d2m2"]), arrays)
    assert got["idx"].spec == (("data", "model"), None, None)
    # the port's Graph2D: each array field on the grid's two axes, the
    # block of rank (i, j) its tile i * pc + j, as Graph2D.local takes it
    from repro_torch.core import sparse as tsp
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 40, 300), rng.integers(0, 40, 300)
    g2 = tdist.partition_2d(tsp.coo_from_edges(
        src, dst, np.ones(300, np.float32), 40, 40), 2, 2)
    mesh = _stand_in({"row": 2, "col": 2}, {"row": 1, "col": 0})
    got = tpart.graph2d_shardings(mesh, g2)
    assert set(got) >= {"idx", "val", "inv_deg"}
    for key, sh in got.items():
        assert sh.spec[0] == ("row", "col") and sh.block(0) == 2, key
    np.testing.assert_array_equal(got["idx"].local(g2.idx).numpy(),
                                  g2.idx[2:3].numpy())


def test_rules_override_and_nesting():
    assert dict(tpart.LM_RULES.table) == dict(jpart.LM_RULES.table)
    assert tsh.current_rules() is tpart.LM_RULES
    sp = tpart.LM_RULES.override(seq="model", batch=("data",))
    jsp = jpart.LM_RULES.override(seq="model", batch=("data",))
    assert dict(sp.table) == dict(jsp.table)
    assert sp.axes_for("seq") == ("model",)
    assert tpart.LM_RULES.axes_for("seq") == ()     # the original stays
    off = tsh.Rules({})
    with tsh.use_rules(sp):
        assert tsh.current_rules() is sp
        with tsh.use_rules(off):
            assert tsh.current_rules() is off
            mesh = _stand_in(MESHES["d2m2"])
            with mesh:
                assert tsh.split_axes(("d_model", "d_ff"), (8, 8), 1) == ()
        assert tsh.current_rules() is sp
    assert tsh.current_rules() is tpart.LM_RULES
    # resolution's three skips: an absent axis, a used axis, no divide
    m = types.SimpleNamespace(shape={"data": 2, "model": 4})
    rules = tsh.Rules({"a": ("pod", "model"), "b": ("model", "data"),
                       "c": ("data",)})
    assert tsh.resolve_spec(("a", "b"), m, (8, 6), rules) == ("model",
                                                              "data")
    assert tsh.resolve_spec(("c", "a"), m, (3, 6), rules) == ()
    assert tsh.resolve_spec(("b", None), m, (16, 5), rules) == (
        ("model", "data"),)
    assert tsh.shard_constraint(torch.ones(2), ("batch",)).shape == (2,)


def test_local_block_of_a_multi_axis_spec():
    mesh = _stand_in(MESHES["multipod"], {"pod": 1, "data": 5, "model": 7})
    s = tsh.Sharding(mesh, (("pod", "data"), "model"))
    full = torch.arange(64 * 32).reshape(64, 32)
    blk = s.block(0)
    assert blk == 1 * 16 + 5 and s.block(1) == 7
    np.testing.assert_array_equal(
        s.local(full).numpy(), full[2 * blk:2 * blk + 2, 14:16].numpy())
    assert s.local_shape((64, 32)) == (2, 2)


def test_production_mesh_and_placement_builders():
    one = tdist.make_production_mesh()
    two = tdist.make_production_mesh(multi_pod=True)
    assert one.shape == {"data": 16, "model": 16} and one.size == 256
    assert two.shape == {"pod": 2, "data": 16, "model": 16}
    assert two.device.type == "meta" and tuple(two.shape) == (
        "pod", "data", "model")
    with pytest.raises(RuntimeError, match="shape-only"):
        one.group("model")
    with pytest.raises(RuntimeError, match="shape-only"):
        tdist.psum({"x": torch.ones(2)}, one, "data")
    assert tdist.replicated_sharding(one).spec == ()
    assert not tdist.replicated_sharding(one).is_split
    assert tdist.leading_axis_sharding(one).spec == ("data",)
    assert tdist.leading_axis_sharding(one, "model").shards(0) == 16
    local = tdist.make_data_mesh(device="cpu")
    x = tdist.replicated_device_put(np.arange(3), local)
    assert x.device.type == "cpu" and x.tolist() == [0, 1, 2]
    assert tdist.replicated_device_put([1.0], device="cpu").tolist() == [1.0]
    assert tdist.current_mesh() is None
    with local:
        assert tdist.current_mesh() is local
    assert tdist.current_mesh() is None


@pytest.mark.parametrize("arch,model,leaf", [
    ("qwen2-1.5b", 4, "wk"),     # 2 KV heads of 128: 256 columns over 4
    ("llama3-8b", 16, "wk"),     # 8 KV heads over 16 ranks
    ("gemma-7b", 32, "wq")])     # 16 heads of 256 over 32 ranks
def test_a_spec_that_cuts_a_head_raises(arch, model, leaf):
    cfg = get_config(arch)
    mesh = _stand_in({"data": 1, "model": model})
    with mesh, pytest.raises(ValueError, match=f"{leaf}'s .* cuts its"):
        TT._head_split(cfg)
    half = _stand_in({"data": 1, "model": 2})
    with half:
        axes, n = TT._head_split(cfg)
    assert axes == ("model",) and n == 2


def test_unported_rule_sets_and_families_raise():
    mesh = _stand_in(MESHES["d2m2"])
    cfg = get_smoke_config("llama3-8b")
    with mesh, tsh.use_rules(tpart.LM_RULES.override(seq="model")):
        with pytest.raises(NotImplementedError, match="item 5b.5"):
            TT._check_mesh(cfg)
    with mesh, tsh.use_rules(tpart.LM_RULES.override(d_model="model")):
        with pytest.raises(NotImplementedError, match="'d_model'"):
            TT._check_mesh(cfg)
    for arch in ("mamba2-1.3b", "hymba-1.5b"):
        with mesh, pytest.raises(NotImplementedError, match="item 5b.5"):
            TT._check_mesh(get_smoke_config(arch))
    with mesh, tsh.use_rules(tsh.Rules({})):
        TT._check_mesh(get_smoke_config("mamba2-1.3b"))   # nothing split
    # int8 error feedback under a 'model' axis is ported: the step builds
    step_fn, _ = TTL.make_train_step(cfg, compression=True, mesh=mesh)
    assert callable(step_fn)
    # a 'model' axis wider than the KV heads is refused under the default
    # rules (item 5b.5); the whole-attention rules keep the heads whole
    wide = _stand_in({"data": 1, "model": 4})
    with wide, pytest.raises(ValueError, match="wk's .* cuts its"):
        TT._head_split(cfg)
    with wide, tsh.use_rules(tpart.WHOLE_ATTENTION_RULES):
        assert TT._head_split(cfg) == ((), 1)
