"""The fused sampling hop and the ordered segment sum of the port, on the
CPU, against the JAX reference.

* ``sample_hop_plain`` (the composition the card's one-launch hop must
  equal) against the reference's per-hop composition of
  ``segment_sample`` / ``expand_indptr`` / ``flat_gather``, on its XLA
  path and in Pallas interpret mode: **bitwise**. Widths 1, 10, 25, 32,
  33 and 64, with and without replacement, rows of degree 0, <= width
  and width + 1 (and hubs), and sentinel frontier rows.
* A Python emulation of the card's warp-per-row draw (every key drawn
  ahead; up to 32 slots each lookup one warp vote plus the highest set
  bit and the ``vals`` chain resolved by pointer jumping, wider rows a
  ballot over 32 slots at a time from the top, step by step) against
  the reference: **bitwise** at the same grid.
* The ordered segment sum (``kernels/segment_sum``): its plain version
  against ``index_add_`` in another order within 2 d eps sum|terms| (fp32,
  d the target's slots), the ordered transposes and sums the card routes
  through against the CPU's ``index_add_`` paths bit for bit (same
  order), the block backward against ``jax.grad`` of the reference's
  block SpMM (rtol 1e-5, atol 1e-6 x max(1, max|ref|)), and an emulation
  of the kernel's cut of long targets into pieces (every slot summed
  once, a target's pieces in order).

Inputs are made with numpy from a seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.autotune import KernelPlan as JPlan
from repro.core.patch import patched as jax_patched
from repro.core import sparse as jsp
from repro.data import make_dataset as jax_make_dataset
from repro.kernels import sample as jks
from repro.sampling import NeighborSampler as JSampler
from repro.sampling import block_spmm as jax_block_spmm
from repro.sampling import pack_block as jax_pack_block

from repro_torch.core import sparse as tsp
from repro_torch.core.autotune import KernelPlan
from repro_torch.core.cache import build_cached_graph
from repro_torch.core.semiring import get_semiring
from repro_torch.core.spmm import _backward_maxmin, _subgradient_ordered
from repro_torch.data import make_dataset
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sample as tks
from repro_torch.kernels import segment_sum as tss
from repro_torch.sampling import NeighborSampler, pack_block

EPS32 = 2.0 ** -24
WIDTHS = [1, 10, 25, 32, 33, 64]


# --------------------------------------------------------------------------
# the fused hop (bitwise)
# --------------------------------------------------------------------------

def _graph(rng, width, n=300):
    """A CSR whose rows have degree 0, 1, width - 1, width, width + 1 and
    hubs (and random ones), sentinel-extended: (indptr, indices, val)."""
    deg = rng.integers(0, 3 * width + 4, n).astype(np.int64)
    deg[:8] = [0, 1, max(width - 1, 0), width, width + 1, 3 * width + 2,
               700, 0]
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    nse = int(indptr[-1])
    indices = np.concatenate([rng.integers(0, n, nse), [n]]).astype(np.int32)
    val = np.concatenate([rng.standard_normal(nse), [0.0]]).astype(np.float32)
    return indptr, indices, val


def _frontier(rng, n, f=24):
    """The special rows first, random ones, and sentinel (id n) rows."""
    fr = np.concatenate([np.arange(8), rng.integers(0, n, f - 11),
                         [n, n, n]]).astype(np.int32)
    return fr


def _reference_hop(indptr, indices, val, frontier, rnd, *, interpret,
                   **kw):
    """The reference device sampler's hop, up to the relabel."""
    n, nse = indptr.shape[0] - 1, indices.shape[0] - 1
    indptr, frontier = jnp.asarray(indptr), jnp.asarray(frontier)
    start = jnp.take(indptr, frontier, mode="clip")
    end = jnp.take(indptr, jnp.minimum(frontier + 1, n), mode="clip")
    deg = end - start
    ranks = jks.segment_sample(deg, frontier, jnp.int32(rnd),
                               interpret=interpret, **kw)
    valid = jks.sample_valid_mask(deg, width=kw["width"],
                                  fanout=kw["fanout"],
                                  replace=kw["replace"])
    pos = jks.expand_indptr(start, ranks, valid, sentinel=nse,
                            interpret=interpret)
    return (np.asarray(jks.flat_gather(jnp.asarray(indices), pos,
                                       interpret=interpret)),
            np.asarray(jks.flat_gather(jnp.asarray(val), pos,
                                       interpret=interpret)),
            np.asarray(valid))


@pytest.mark.parametrize("replace", [False, True])
@pytest.mark.parametrize("width", WIDTHS)
def test_sample_hop_plain_matches_reference_hop_bitwise(width, replace):
    rng = np.random.default_rng(width + 100 * int(replace))
    indptr, indices, val = _graph(rng, width)
    frontier = _frontier(rng, indptr.shape[0] - 1)
    kw = dict(width=width, fanout=width, seed=7, hop=1, replace=replace)
    rnd = 12_345
    got = tks.sample_hop(torch.from_numpy(indptr), torch.from_numpy(indices),
                         torch.from_numpy(val), torch.from_numpy(frontier),
                         rnd, **kw)
    assert [t.shape for t in got] == [(frontier.shape[0], width)] * 3
    assert [t.dtype for t in got] == [torch.int32, torch.float32,
                                      torch.bool]
    for interpret in (None, True):
        want = _reference_hop(indptr, indices, val, frontier, rnd,
                              interpret=interpret, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    # sentinel rows hold the inert edge in every slot
    assert (got[0][-3:] == indptr.shape[0] - 1).all()
    assert not got[2][-3:].any() and (got[1][-3:] == 0).all()


def test_sample_hop_full_neighbourhood_and_empty_frontier():
    rng = np.random.default_rng(1)
    indptr, indices, val = _graph(rng, 6, n=40)
    width = int(np.diff(indptr).max())
    frontier = _frontier(rng, 40, f=16)
    args = [torch.from_numpy(a) for a in (indptr, indices, val, frontier)]
    kw = dict(width=width, fanout=None, seed=0, hop=0, replace=False)
    got = tks.sample_hop(*args, 3, **kw)
    want = _reference_hop(indptr, indices, val, frontier, 3,
                          interpret=None, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    tops.reset_kernel_launches()
    empty = tks.sample_hop(*args[:3], torch.zeros(0, dtype=torch.int32), 3,
                           **kw)
    assert [tuple(t.shape) for t in empty] == [(0, width)] * 3
    assert not any(tops.kernel_launches().values())
    assert "sample_hop" in tops.kernel_launches()


def _highest(mask):
    return mask.bit_length() - 1 if mask else -1


def _warp_fisher_yates_32(keys):
    """``warp_fisher_yates_32`` lane by lane: sr from __match_any_sync,
    sj from one ballot a slot value, both masked to the lanes below, the
    vals chain by pointer jumping (5 shuffles)."""
    width = len(keys)
    key = keys + [-1] * (32 - width)
    root = []
    for lane in range(32):
        below = (1 << lane) - 1
        mj = sum(1 << s for s in range(32) if key[s] == lane) \
            if lane < width else 0
        sj = _highest(mj & below)
        root.append(sj if sj >= 0 else lane)
    for _ in range(5):
        root = [root[root[lane]] for lane in range(32)]
    out = []
    for j in range(width):
        same = sum(1 << s for s in range(32) if key[s] == key[j])
        sr = _highest(same & ((1 << j) - 1))
        out.append(root[sr] if sr >= 0 else key[j])
    return out


def _warp_ranks(deg, gid, rnd, *, width, seed, hop, replace):
    """The card's draw, lane by lane: every key r_s is drawn up front (it
    depends on (hash, s, deg) only). Up to 32 slots, one slot a lane and
    every lookup one warp vote (:func:`_warp_fisher_yates_32`); wider,
    lane s owns slots s, s + 32, ... and step j finds the latest slot
    below j whose key is r_j (and j) by a ballot over one group of 32
    slots at a time from the top and the highest set bit; only ``vals``
    chains."""
    f = deg.shape[0]
    out = np.empty((f, width), np.int32)
    slots = torch.arange(width, dtype=torch.int64)
    for i in range(f):
        d = int(deg[i])
        bits = tks._edge_bits(seed, rnd, hop, torch.tensor(int(gid[i])),
                              slots)
        u = tks._bits_to_uniform(bits)
        if replace:
            r = torch.floor(u * torch.tensor(float(d), dtype=torch.float32))
            out[i] = torch.minimum(r.to(torch.int64),
                                   torch.tensor(max(d - 1, 0))).numpy()
            continue
        if d <= width:
            out[i] = np.arange(width)
            continue
        span = torch.tensor(float(d), dtype=torch.float32) - \
            slots.to(torch.float32)
        keys = (slots + torch.minimum(torch.floor(u * span).to(torch.int64),
                                      torch.clamp(d - slots - 1, min=0))
                ).tolist()
        if width <= 32:
            out[i] = _warp_fisher_yates_32(keys)
            continue
        vals = [0] * width
        for j in range(width):
            rj, sr, sj = keys[j], -1, -1
            g = (j - 1) // 32 if j > 0 else -1
            while g >= 0 and (sr < 0 or sj < 0):
                mr = mj = 0
                for lane in range(32):
                    s = 32 * g + lane
                    if s < j:
                        mr |= (keys[s] == rj) << lane
                        mj |= (keys[s] == j) << lane
                if sr < 0 and mr:
                    sr = 32 * g + mr.bit_length() - 1
                if sj < 0 and mj:
                    sj = 32 * g + mj.bit_length() - 1
                g -= 1
            vals[j] = vals[sj] if sj >= 0 else j
            out[i, j] = vals[sr] if sr >= 0 else rj
    return out


@pytest.mark.parametrize("replace", [False, True])
@pytest.mark.parametrize("width", WIDTHS)
def test_warp_draw_emulation_matches_reference_bitwise(width, replace):
    rng = np.random.default_rng(3 * width + int(replace))
    f = 40
    deg = rng.integers(0, 4 * width + 3, f).astype(np.int32)
    deg[:5] = [0, 1, width, width + 1, 5000]
    gid = rng.integers(0, 1 << 30, f).astype(np.int32)
    gid[-3:], deg[-3:] = 1 << 30, 0
    kw = dict(width=width, seed=2 ** 32 - 1, hop=2, replace=replace)
    got = _warp_ranks(deg, gid, -1, **kw)
    want = np.asarray(jks.segment_sample(jnp.asarray(deg), jnp.asarray(gid),
                                         jnp.int32(-1), fanout=width, **kw))
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# the ordered segment sum
# --------------------------------------------------------------------------

def _segments(rng, n_t, n_slots, hub=600):
    """Random sorted targets with a hub of ``hub`` slots and empty
    targets; returns (targets (n_slots,), offsets (n_t + 1,))."""
    t = np.sort(rng.integers(0, n_t, n_slots))
    t = np.sort(np.concatenate([t, np.full(hub, n_t // 2)]))
    offsets = np.searchsorted(t, np.arange(n_t + 1)).astype(np.int64)
    return torch.from_numpy(t), torch.from_numpy(offsets)


@pytest.mark.parametrize("k", [1, 7, 16])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("accumulate", [False, True])
def test_segment_sum_plain_matches_index_add_within_bound(k, weighted,
                                                          accumulate):
    rng = np.random.default_rng(k + 2 * weighted + 4 * accumulate)
    n_t, n_src = 90, 70
    tgt, offsets = _segments(rng, n_t, 1500)
    n = tgt.shape[0]
    src = torch.from_numpy(rng.standard_normal((n_src, k)).astype(np.float32))
    index = torch.from_numpy(rng.integers(-2, n_src + 2, n).astype(np.int32))
    weight = torch.from_numpy(rng.standard_normal(n).astype(np.float32)) \
        if weighted else None
    out0 = torch.from_numpy(rng.standard_normal((n_t, k)).astype(np.float32))
    out = out0.clone() if accumulate else None
    got = tss.segment_sum_sorted(src, offsets, index=index, weight=weight,
                                 out=out)
    if accumulate:
        assert got is out
    # index_add_ over the slots in another (reversed) order
    ok = (index >= 0) & (index < n_src)
    w = weight if weighted else torch.ones(n)
    terms = w[ok][:, None] * src[index[ok].long()]
    want = out0.clone() if accumulate else torch.zeros((n_t, k))
    mag = out0.abs() if accumulate else torch.zeros((n_t, k))
    want.index_add_(0, tgt[ok].flip(0), terms.flip(0))
    mag.index_add_(0, tgt[ok], terms.abs())
    d = torch.bincount(tgt[ok], minlength=n_t).float()[:, None] + \
        float(accumulate)
    assert ((got - want).abs() <= 2 * EPS32 * d * mag + 1e-30).all()
    # in slot order it is index_add_ in slot order, bit for bit
    seq = out0.clone() if accumulate else torch.zeros((n_t, k))
    seq.index_add_(0, tgt[ok], terms)
    assert torch.equal(got, seq)


def test_segment_order_sorts_stably_with_static_shapes():
    t = torch.tensor([3, 1, 3, 0, 9, 1, 3, -1], dtype=torch.int32)
    order = tss.segment_order(t, 5)
    assert order.perm.dtype == torch.int32 and order.offsets.dtype == \
        torch.int64 and order.offsets.shape == (6,)
    assert order.perm.tolist()[1:7] == [3, 1, 5, 0, 2, 6]
    assert order.offsets.tolist() == [1, 2, 4, 4, 7, 7]


def test_cached_graph_orders_are_the_stable_sorts():
    ds = make_dataset("reddit", scale=1 / 512, seed=1)
    g = build_cached_graph(ds.coo, tune=False)
    n = ds.coo.nse
    row, col = ds.coo.row[:n], ds.coo.col[:n]
    assert torch.equal(g.row_order.perm.long(),       # row-sorted COO
                       torch.arange(n))
    assert torch.equal(g.row_order.offsets,
                       torch.searchsorted(row, torch.arange(
                           ds.num_nodes + 1, dtype=torch.int32)))
    perm = g.col_order.perm.long()
    assert torch.equal(perm, torch.sort(col, stable=True).indices)
    # the column order is the cached transpose's order
    assert torch.equal(row[perm], g.coo_t.col[:n])
    assert torch.equal(col[perm], g.coo_t.row[:n])


@pytest.mark.parametrize("kind", ["ell", "sell"])
def test_ordered_transposes_equal_index_add_paths_bitwise(kind):
    """The card's block backward (slots sorted stably by column, summed
    in slot order), run here through the plain primitive, gives the CPU
    path's ``index_add_`` bits: the same order."""
    rng = np.random.default_rng(4)
    n, m, nnz = 80, 60, 500
    lin = rng.choice(n * m, size=nnz, replace=False)
    coo = tsp.coo_from_edges(lin % m, lin // m,
                             rng.standard_normal(nnz).astype(np.float32), n,
                             m)
    a = tsp.ell_from_coo(coo) if kind == "ell" else \
        tsp.sell_from_coo(coo, c=8, sigma=0)
    dout = torch.from_numpy(rng.standard_normal((n, 24)).astype(np.float32))
    fns = (tref.ell_transpose_reduce, tref.ell_transpose_ordered) \
        if kind == "ell" else (tref.sell_transpose_reduce,
                               tref.sell_transpose_ordered)
    assert torch.equal(fns[1](a, dout), fns[0](a, dout))


@pytest.fixture(scope="module")
def graphs():
    return (jsp.csr_from_coo(jax_make_dataset("reddit", scale=1 / 512,
                                              seed=1).coo),
            tsp.csr_from_coo(make_dataset("reddit", scale=1 / 512,
                                          seed=1).coo))


@pytest.mark.parametrize("kind", ["ell", "sell"])
def test_ordered_block_backward_matches_jax_grad(graphs, kind):
    jcsr, tcsr = graphs
    seeds = np.arange(0, 90, 3)
    sizes = dict(n_dst=32, n_src=256, nnz=32 * 6, ell_width=6)
    jplan = JPlan(kind="ell") if kind == "ell" else JPlan(kind="sell",
                                                          sell_c=8)
    tplan = KernelPlan(kind="ell") if kind == "ell" else KernelPlan(
        kind="sell", sell_c=8)
    jpb = jax_pack_block(JSampler(jcsr, (6,), seed=2).sample(seeds, round=1)
                         [0], plan=jplan, **sizes)
    tpb = pack_block(NeighborSampler(tcsr, (6,), seed=2).sample(
        seeds, round=1)[0], plan=tplan, **sizes)
    rng = np.random.default_rng(6)
    h = rng.standard_normal((256, 8)).astype(np.float32)
    w = rng.standard_normal((32, 8)).astype(np.float32)
    with jax_patched(True):
        want = jax.grad(lambda hh: jnp.sum(jax_block_spmm(jpb, hh, "sum")
                                           * w))(jnp.asarray(h))
    ordered = tref.ell_transpose_ordered if kind == "ell" else \
        tref.sell_transpose_ordered
    got = ordered(tpb.ell if kind == "ell" else tpb.sell, torch.from_numpy(w))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-6 * max(1.0, float(np.abs(want)
                                                          .max())))


@pytest.fixture()
def card_routes(monkeypatch):
    """The card's routes on the CPU: ``on_card`` says yes and the kernel
    is its plain version (a product tensor and a sequential
    ``index_add_`` in sorted-slot order)."""
    monkeypatch.setattr(tss, "on_card", lambda t: True)
    monkeypatch.setattr(tss, "segment_sum_sorted_cuda",
                        tss.segment_sum_sorted_plain)


@pytest.mark.parametrize("combine", ["mul", "second", "add"])
def test_ordered_coo_sum_equals_index_add_bitwise(card_routes, combine):
    """``coo_reduce``'s route on the card (a gather-scale-sum over the
    cached order, no message tensor; for ``add`` messages chunk by chunk
    of the sorted edges), over A and over A^T by column."""
    ds = make_dataset("reddit", scale=1 / 512, seed=1)
    g = build_cached_graph(ds.coo, tune=False)
    c = g.coo
    sr = get_semiring("sum", combine)
    h = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (c.ncols, 12)).astype(np.float32))
    for order, rows, cols, nt in ((g.row_order, c.row, c.col, c.nrows),
                                  (g.col_order, c.col, c.row, c.ncols)):
        got = tref.coo_reduce(rows, cols, c.val, c.nse, nt, h, sr,
                              order=order)
        want = tref.coo_reduce(rows, cols, c.val, c.nse, nt, h, sr)
        assert torch.equal(got, want)


def test_scatter_sum_ordered_equals_index_add_bitwise(card_routes):
    rng = np.random.default_rng(9)
    tgt = torch.from_numpy(rng.integers(0, 30, 400).astype(np.int32))
    order = tss.segment_order(tgt, 30)
    for shape in ((400,), (400, 5)):
        data = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        want = torch.zeros((30,) + shape[1:]).index_add(0, tgt.long(), data)
        assert torch.equal(tss.scatter_sum(data, tgt, 30, order), want)
    # under autograd the sum stays index_add (differentiable)
    data = data.requires_grad_(True)
    out = tss.scatter_sum(data, tgt, 30, order)
    out.sum().backward()
    assert torch.equal(data.grad, torch.ones_like(data))


@pytest.mark.parametrize("arch", ["gat", "sage-max", "sage-mean"])
def test_card_routes_equal_cpu_paths_bitwise(card_routes, arch,
                                             monkeypatch):
    """A patched full-graph step through every ordered route of the card
    (FusedMM's recompute backward and trusted layer, the max
    subgradient, the trusted sum and its transpose), run through the
    plain primitive: the same loss and gradients, bit for bit, as the
    CPU's ``index_add_`` paths (the same order)."""
    from repro_torch.core.patch import patched
    from repro_torch.models.gnn import build_bundle, make_gnn
    from repro_torch.optim.optimizer import tree_map
    from repro_torch.train.gnn import loss_and_grads
    ds = make_dataset("reddit", scale=1 / 512, seed=1)
    plan = KernelPlan(kind="bsr", br=128, bc=128, fk=64) \
        if arch == "gat" else KernelPlan.trusted(128)
    bundle = build_bundle(ds, k_hint=128, arch=arch, plan=plan)
    init, apply = make_gnn(arch, ds.num_features, 128, ds.num_classes)
    params = init(torch.Generator().manual_seed(0), device="cpu")
    args = (apply, params, bundle, ds.x, ds.y, ds.train_mask)
    with patched(True):
        loss, grads = loss_and_grads(*args)
        monkeypatch.setattr(tss, "on_card", lambda t: False)
        want_loss, want_grads = loss_and_grads(*args)
    assert torch.equal(loss, want_loss)
    same = []
    tree_map(lambda a, b: same.append(torch.equal(a, b)), grads, want_grads)
    assert same and all(same)


@pytest.mark.parametrize("combine", ["mul", "second"])
@pytest.mark.parametrize("reduce", ["max", "min"])
def test_ordered_subgradient_equals_index_add_bitwise(reduce, combine):
    ds = make_dataset("reddit", scale=1 / 512, seed=1)
    g = build_cached_graph(ds.coo, tune=False)
    c = g.coo
    sr = get_semiring(reduce, combine)
    rng = np.random.default_rng(10)
    h = torch.from_numpy(rng.standard_normal((c.ncols, 6)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((c.nrows, 6)).astype(
        np.float32))
    out = tref.coo_reduce(c.row, c.col, c.val, c.nse, c.nrows, h, sr)
    want = _backward_maxmin(c, g.col_order, h, out, dy, sr)
    # the card's route, from the same winners
    k, n = h.shape[1], c.nse
    winner = torch.full((c.nrows, k), torch.iinfo(torch.int64).max)
    msgs = sr.apply_combine(c.val[:n, None], tref.take_rows(h, c.col[:n]))
    cand = torch.where(msgs == out[c.row[:n].long()],
                       torch.arange(n)[:, None], winner.max())
    winner.scatter_reduce_(0, c.row[:n].long()[:, None].expand_as(cand),
                           cand, "amin")
    for step in (n, 97):          # one chunk, and many
        got = _subgradient_ordered(c, g.col_order, winner, dy, sr, step)
        assert torch.equal(got, want)


def _pieces(offsets, n_slots, chunk=tss.CHUNK):
    """The work items of ``csrc/segment_sum.cu``: ``piece_of`` for every
    window and every target (clamped offsets, bisection for a window's
    target), and the reducer's walk over a long target's windows."""
    off = [min(max(int(o), 0), n_slots) for o in offsets]
    n_t = len(off) - 1
    nwin = -(-n_slots // chunk) if n_slots > chunk else 0
    pieces = []
    for item in range(nwin):
        w0 = item * chunk
        if off[0] > w0:
            continue
        lo, hi = 0, n_t
        while lo < hi:
            mid = (lo + hi + 1) >> 1
            if off[mid] <= w0:
                lo = mid
            else:
                hi = mid - 1
        if lo >= n_t:
            continue
        o0, o1 = off[lo], off[lo + 1]
        j = (w0 - o0 + chunk - 1) // chunk
        c = o0 + j * chunk
        if j >= 1 and c < o1 and c < w0 + chunk:
            pieces.append((lo, c, min(c + chunk, o1), item))
    for t in range(n_t):
        p0 = off[t]
        pieces.append((t, p0, max(p0, min(p0 + chunk, off[t + 1])), -1))
    return pieces, off


@pytest.mark.parametrize("seed", range(4))
def test_segment_sum_pieces_cover_every_slot_once_in_order(seed):
    """The kernel's cut of long targets into pieces of 256 slots, as
    ``csrc/segment_sum.cu`` computes it: every slot of a target in
    exactly one piece, the first piece stored to the target, every later
    one to the workspace row of the window it starts in, where the
    reducer reads it (chunk order)."""
    rng = np.random.default_rng(seed)
    n_t = 60
    degs = rng.integers(0, 40, n_t)
    degs[rng.integers(0, n_t, 3)] = [257, 1000, 3000]
    degs[5:9] = 0
    pre = int(rng.integers(0, 3))            # slots before target 0
    offsets = np.concatenate([[pre], pre + np.cumsum(degs)])
    n_slots = int(offsets[-1]) + int(rng.integers(0, 300))
    pieces, off = _pieces(offsets, n_slots)
    seen = np.zeros(n_slots, np.int64)
    ws_rows = {}
    for t, p0, p1, slot in pieces:
        seen[p0:p1] += 1
        assert off[t] <= p0 <= p1 <= off[t + 1] and p1 - p0 <= tss.CHUNK
        if slot >= 0:
            assert slot not in ws_rows and p0 // tss.CHUNK == slot
            ws_rows[slot] = (t, p0)
    covered = np.zeros(n_slots, np.int64)
    covered[off[0]:off[-1]] = 1
    np.testing.assert_array_equal(seen, covered)
    for t in range(n_t):                       # the reducer's reads
        for c in range(off[t] + tss.CHUNK, off[t + 1], tss.CHUNK):
            assert ws_rows[c // tss.CHUNK] == (t, c)
