"""Which collectives gloo runs on card tensors, and how large reddit's ELL
bands and tiles are: the two facts the distributed GNN path
(``repro_torch.dist.gnn``, ``gnn2d``) is designed around.

(1) Four ranks share cuda:0 (gloo, by ``dist.choose_backend``), started
by ``dist.run_ranks``. Each tries every collective of
``dist.collectives`` on card tensors and checks the values it got:
``all_gather_into_tensor``, ``all_gather``, ``reduce_scatter_tensor``,
``reduce_scatter``, ``all_to_all_single``, ``all_to_all``,
``all_reduce`` (sum, max), ``broadcast`` and ``isend`` / ``irecv`` in a
ring, each op in four ranks of its own (gloo aborts a process that hands
it a card pointer it cannot read). An op that raises, or whose ranks
die, is refused; one whose values are wrong is reported as such. (2) With ``--ell``, reddit's graph at scales 1, 1/2,
1/4 and 1/8 (``data.make_dataset``): the bytes of each 1-D ELL band and
2 x 2 ELL tile at 8 B a slot (int32 id + fp32 value), as
``dist.gnn.build_dist_graph`` and ``dist.gnn2d.partition_2d`` would pad
them (the band to the graph's largest degree, the tile to its largest
in-tile degree).

    python tools/gloo_probe.py [--ell] [--ops all_gather,broadcast]

Needs one CUDA card; writes ``chiprun_out/gloo_probe.json``.
"""
import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

OPS = ("all_gather_into_tensor", "all_gather", "reduce_scatter_tensor",
       "reduce_scatter", "all_to_all_single", "all_to_all",
       "all_reduce_sum", "all_reduce_max", "broadcast", "isend_irecv")


def probe_rank(mesh, only) -> dict:
    import torch
    import torch.distributed as dist
    r, n, dev = dist.get_rank(), dist.get_world_size(), mesh.device
    rows = 3
    mine = torch.arange(rows * 4, dtype=torch.float32, device=dev).reshape(
        rows, 4) + 100 * r
    every = torch.cat([torch.arange(rows * 4, dtype=torch.float32,
                                    device=dev).reshape(rows, 4) + 100 * q
                       for q in range(n)])
    full = torch.arange(n * rows * 4, dtype=torch.float32,
                        device=dev).reshape(n * rows, 4) * (r + 1)
    tri = n * (n + 1) // 2
    res = {}

    def run(name, fn):
        try:
            ok = bool(fn())
            res[name] = "ok" if ok else "wrong values"
        except Exception as exc:               # a refusal, reported
            res[name] = f"refused: {type(exc).__name__}: {str(exc)[:160]}"
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()

    def ag_tensor():
        out = torch.empty(n * rows, 4, device=dev)
        dist.all_gather_into_tensor(out, mine)
        return torch.equal(out, every)

    def ag_list():
        outs = [torch.empty(rows, 4, device=dev) for _ in range(n)]
        dist.all_gather(outs, mine)
        return torch.equal(torch.cat(outs), every)

    want_rs = full.view(n, rows, 4)[r] / (r + 1) * tri

    def rs_tensor():
        out = torch.empty(rows, 4, device=dev)
        dist.reduce_scatter_tensor(out, full)
        return torch.equal(out, want_rs)

    def rs_list():
        out = torch.empty(rows, 4, device=dev)
        dist.reduce_scatter(out, list(full.chunk(n)))
        return torch.equal(out, want_rs)

    want_a2a = torch.cat([full.view(n, rows, 4)[r] / (r + 1) * (q + 1)
                          for q in range(n)])

    def a2a_single():
        out = torch.empty(n * rows, 4, device=dev)
        dist.all_to_all_single(out, full)
        return torch.equal(out, want_a2a)

    def a2a_list():
        outs = [torch.empty(rows, 4, device=dev) for _ in range(n)]
        dist.all_to_all(outs, list(full.chunk(n)))
        return torch.equal(torch.cat(outs), want_a2a)

    def ar(op, want):
        t = mine.clone()
        dist.all_reduce(t, op=op)
        return torch.equal(t, want)

    def bcast():
        t = mine.clone()
        dist.broadcast(t, src=0)
        return torch.equal(t, every[:rows])

    def ring():
        got = torch.empty(rows, 4, device=dev)
        ops = [dist.P2POp(dist.isend, mine, (r - 1) % n),
               dist.P2POp(dist.irecv, got, (r + 1) % n)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return torch.equal(got, every.view(n, rows, 4)[(r + 1) % n])

    base = every.view(n, rows, 4)
    fns = dict(all_gather_into_tensor=ag_tensor, all_gather=ag_list,
               reduce_scatter_tensor=rs_tensor, reduce_scatter=rs_list,
               all_to_all_single=a2a_single, all_to_all=a2a_list,
               all_reduce_sum=lambda: ar(dist.ReduceOp.SUM, base.sum(0)),
               all_reduce_max=lambda: ar(dist.ReduceOp.MAX, base.amax(0)),
               broadcast=bcast, isend_irecv=ring)
    run(only, fns[only])
    return dict(rank=r, backend=mesh.backend, device=str(dev), ops=res)


def ell_sizes() -> list:
    import numpy as np
    from repro_torch.data import make_dataset
    rows = []
    for scale in (1, 1 / 2, 1 / 4, 1 / 8):
        ds = make_dataset("reddit", scale=scale)
        coo = ds.coo
        n, m = coo.nrows, coo.ncols
        row = coo.row[: coo.nse].numpy().astype(np.int64)
        col = coo.col[: coo.nse].numpy().astype(np.int64)
        deg = np.bincount(row, minlength=n)
        rp = -(-n // 4)
        band = rp * int(deg.max()) * 8
        rpt = -(-n // 2)
        rpt += rpt % 2                        # a multiple of pc
        cpt = -(-m // 2)
        cpt += cpt % 2
        tile_md = []
        for i in range(2):
            for j in range(2):
                sel = (row // rpt == i) & (col // cpt == j)
                c = np.bincount(row[sel] - i * rpt, minlength=rpt)
                tile_md.append(int(c.max()) if c.size else 0)
        md = max(max(tile_md), 1)
        rows.append(dict(scale=scale, nodes=n, edges=int(coo.nse),
                         max_deg=int(deg.max()), band_rows=rp,
                         band_bytes=band, tile_rows=rpt, tile_max_deg=md,
                         tile_bytes=rpt * md * 8,
                         tile_slots=rpt * md))
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main() -> int:
    import torch
    from repro_torch import dist as tdist
    ap = argparse.ArgumentParser()
    ap.add_argument("--ell", action="store_true")
    ap.add_argument("--ops", default="", help="comma-separated subset")
    args = ap.parse_args()
    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    out = dict(torch=torch.__version__, cuda=torch.version.cuda)
    (ROOT / "build").mkdir(exist_ok=True)
    out["ops"] = {}
    for op in args.ops.split(",") if args.ops else OPS:
        # each op in ranks of its own: gloo aborts the process where it
        # hands a card pointer to the socket ("writev ... Bad address")
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as store:
            try:
                ranks = tdist.run_ranks(probe_rank, 4, store, args=(op,),
                                        device="cuda", timeout_s=120.0)
                got = {r["ops"][op] for r in ranks}
                out["ops"][op] = got.pop() if len(got) == 1 else sorted(got)
            except RuntimeError as exc:
                out["ops"][op] = "refused: the ranks died (" + \
                    str(exc).replace("\n", " ")[-200:] + ")"
        print(op, out["ops"][op], flush=True)
    if args.ell:
        out["ell"] = ell_sizes()
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "gloo_probe.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":      # the ranks are spawned: they import this
    sys.exit(main())
