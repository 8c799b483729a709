"""Config-driven LM training and serving: the dense, MoE, ssm (mamba2),
hybrid (hymba), audio (hubert) and vlm (internvl2) families.

Params are the reference's pytree as a dict of tensors: the same keys,
layers stacked on a leading L axis (``params["layers"]["attn"]["wq"]`` is
(L, D, H·Dh)); a Python loop over the layers stands in for ``lax.scan``.
Each forward takes the stacked tensors apart once (``unbind``), so the
backward stacks each leaf's gradient once. Entry points run on ``cuda``
unless the caller passes ``device="cpu"`` (``init_params``,
``init_cache``; the others follow their params).

  init_params(cfg, generator)               parameter dict (stacked layers)
  loss_fn(cfg, params, batch)               -> (loss, metrics)    [train]
  prefill(cfg, params, batch, capacity)     -> (cache, last-token logits)
  decode_step(cfg, params, cache, tokens)   -> (logits, cache)
  init_cache(cfg, batch, capacity)          empty rolling-buffer cache
  forward_hidden(cfg, params, batch)        -> (hidden, aux loss)

Training recomputes each layer in the backward as ``cfg.remat`` says:
``"full"`` (every full config) wraps the block in
``torch.utils.checkpoint`` (non-reentrant), ``"dots"`` keeps the 2-D
matrix products' outputs and recomputes the rest (the reference's
``dots_with_no_batch_dims_saveable``), ``"none"`` keeps everything.

The prefill block's attention goes through ``kernels.ops.flash_attention``
(the hand kernel on the card; its plain version, ``chunked_attention``,
on the CPU), for full-attention and sliding-window layers alike: the two
branches of the reference's block (``chunked_attention`` /
``banded_attention``) compute the same masked softmax, and the kernel
skips the KV tiles outside the band and the sink prefix (hymba's
``n_meta_tokens`` meta tokens, prepended to every sequence, stay
visible to every layer's later queries). The MoE layers' expert products
go through ``kernels.ops.ragged_gemm``. Decode attention stays
``decode_attention``, as in the reference. Both kernels are
differentiable (``kernels/ops.py``): their backwards are hand kernels on
the card too.

The ssm block is the Mamba2 mixer alone (``models/lm/mamba2.py``, plain
PyTorch as the reference is plain XLA); the hybrid block runs attention
and the mixer side by side on the same normed input and mixes them with
per-path gains. ``prefill`` collects each layer's final SSM state and
conv tail in the same pass as its K / V (the reference replays the
mixers in a second pass; the states are the same function of the same
inputs). Decode runs the mixer's one-token recurrence.

The front ends are the reference's stubs (``_embed_batch``): the input
sequence is [meta tokens? | image prefix? | tokens or frames]. An audio
batch carries ``frames`` (B, S, d_model), precomputed frame embeddings
used as they are (no embedding lookup), and its encoder attends without
the causal mask (``cfg.causal`` False); a vlm batch may carry
``image_emb`` (B, n_prefix_tokens, d_model), prepended to the token
embeddings, so RoPE counts its positions, the causal mask covers it,
``prefill`` puts it in the cache's first slots and ``loss_fn`` skips it.

**Tensor and expert parallelism.** Under an active mesh (``with
mesh:``) and the active rules (``dist.sharding``; by default
``dist.partition.LM_RULES``), each rank holds its slice of every split
leaf (``dist.partition.shard_params``) and the blocks call the
collectives themselves, where the reference lets GSPMD place the data:
``_attn_qkv`` makes this rank's heads (``wq`` / ``wk`` / ``wv`` split by
columns, the input through ``copy_to_axis``) and ``wo`` is row-parallel
(``reduce_from_axis``); the embedding is a vocab-parallel lookup (rows
outside the rank's range are zeros, then the sum); the loss's chunked
cross-entropy is vocab-parallel (the max and the log-sum-exp reduced
over the vocab's axes, the target's logit from the rank that holds it;
a chunk's whole (B, c, V) never exists); ``prefill`` and
``decode_step`` return the whole logits on every rank; the MLP and the
MoE layer (``layers.glu_mlp``, ``moe.moe_layer``) split ``d_ff`` or the
experts, and where the ``'model'`` axis is exactly ``n_experts ·
n_expert_replicas`` wide and the sequence divides over it, the MoE layer
takes the manual expert-parallel path (each rank its sequence block, an
all-to-all over the expert-parallel groups; ``moe.moe_layer``): a train
step's and a prefill's layers do, a decode step's one position takes the
split einsum. A rule set that splits ``seq`` or ``d_model``, and the
ssm and hybrid families with a ``'model'`` axis, raise (ROADMAP.md queue
1, item 5b.5); so does a ``'model'`` axis wider than the KV heads under
rules that split them (``_head_split``; :func:`heads_split_cleanly`
asks): keep the attention whole there
(``dist.partition.WHOLE_ATTENTION_RULES``), as the launcher does.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import FULL_ATTN_WINDOW, ModelConfig
from repro_torch.dist.collectives import (copy_to_axis, gather_dim, pmax,
                                          reduce_from_axis)
from repro_torch.dist.mesh import current_mesh
from repro_torch.dist.sharding import (Sharding, current_rules,
                                       split_axes)
from repro_torch.kernels import ops as kops
from repro_torch.models.lm import mamba2 as M
from repro_torch.models.lm.attention import KVSlice, decode_attention
from repro_torch.models.lm.layers import (dtype_of, glu_mlp, init_glu_mlp,
                                          init_norm, norm_apply, rope,
                                          truncated_normal_init)
from repro_torch.models.lm.moe import init_moe, moe_layer

__all__ = ["Model", "init_params", "init_cache", "loss_fn", "prefill",
           "decode_step", "forward_hidden", "params_from_jax",
           "sequence_length", "heads_split_cleanly", "PORTED_FAMILIES",
           "REMAT_POLICIES"]

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


# ==========================================================================
# Parameter init
# ==========================================================================

def _init_attn(gen, cfg: ModelConfig, device) -> dict:
    dt = dtype_of(cfg)
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": truncated_normal_init(gen, (d, h * dh), 1.0, dt, device),
         "wk": truncated_normal_init(gen, (d, kv * dh), 1.0, dt, device),
         "wv": truncated_normal_init(gen, (d, kv * dh), 1.0, dt, device),
         "wo": truncated_normal_init(gen, (h * dh, d), 1.0, dt, device)}
    if cfg.qkv_bias:
        for name, width in (("bq", h * dh), ("bk", kv * dh), ("bv", kv * dh)):
            p[name] = torch.zeros((width,), dtype=dt, device=device)
    return p


def _init_layer(gen, cfg: ModelConfig, device) -> dict:
    p = {"ln1": init_norm(cfg, device)}
    if cfg.ssm:                       # the pure SSD block: the mixer only
        p["mixer"] = M.init_mamba2(gen, cfg, device)
        return p
    p["attn"] = _init_attn(gen, cfg, device)
    if cfg.hybrid:
        p["ssm"] = M.init_mamba2(gen, cfg, device)
        dt = dtype_of(cfg)            # per-path fusion gains
        p["mix_attn"] = torch.ones((cfg.d_model,), dtype=dt, device=device)
        p["mix_ssm"] = torch.ones((cfg.d_model,), dtype=dt, device=device)
    p["ln2"] = init_norm(cfg, device)
    if cfg.n_experts:
        p["moe"] = init_moe(gen, cfg, device)
    else:
        p["mlp"] = init_glu_mlp(gen, cfg, device)
    return p


def _stack(layers: list) -> dict:
    """Per-layer dicts -> one dict of (L, ...) tensors; each layer's
    tensors are released as their leaf is stacked. ``meta`` leaves (shapes
    only) are stacked as a new ``meta`` tensor: ``torch.stack`` on the
    meta device takes seconds the first time (it loads its Python
    decompositions), which every rank would pay."""
    out = {}
    for key in list(layers[0]):
        first = layers[0][key]
        if isinstance(first, dict):
            out[key] = _stack([lp[key] for lp in layers])
        elif first.device.type == "meta":
            out[key] = torch.empty((len(layers),) + tuple(first.shape),
                                   dtype=first.dtype, device="meta")
        else:
            out[key] = torch.stack([lp.pop(key) for lp in layers])
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", *, mesh=None) -> dict:
    """Random params from ``generator`` (drawn on its device, stored on
    ``device`` in the config's dtype), the reference's init rules. With
    ``mesh``: this rank's slices by the active rules
    (``dist.partition.shard_params``) on the mesh's device, each layer's
    leaves cut as soon as the layer is drawn, so no rank holds more than
    one whole layer; the generator is consumed in the same order, so the
    slices are bitwise the whole draw's."""
    dt = dtype_of(cfg)
    if mesh is None:
        keep = lambda tree: tree                           # noqa: E731
    else:
        from repro_torch.dist.partition import shard_params
        keep = lambda tree: shard_params(mesh, tree)       # noqa: E731
    params = keep({"embed": truncated_normal_init(
        generator, (cfg.vocab_padded, cfg.d_model), 1.0, dt, device)})
    params.update(keep({"out_norm": init_norm(cfg, device)}))
    params["layers"] = _stack([
        keep({"layers": _init_layer(generator, cfg, device)})["layers"]
        for _ in range(cfg.n_layers)])
    if not cfg.tie_embeddings:
        params.update(keep({"lm_head": truncated_normal_init(
            generator, (cfg.d_model, cfg.vocab_padded), 1.0, dt, device)}))
    if cfg.n_meta_tokens:
        params.update(keep({"meta": truncated_normal_init(
            generator, (cfg.n_meta_tokens, cfg.d_model), 1.0, dt, device)}))
    return params


def params_from_jax(params: dict, device="cuda") -> dict:
    """The reference's LM params (a nested dict of arrays, stacked layers
    kept; leaves as numpy arrays or anything ``np.asarray`` takes, bf16
    included) as the port's: the same keys and dtypes, tensors on
    ``device``."""
    def leaf(x):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16).to(device)
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    def walk(p):
        return {key: walk(val) if hasattr(val, "items") else leaf(val)
                for key, val in p.items()}
    return walk(params)


def _unstack(tree: dict, n: int) -> list:
    """The stacked (L, ...) layer tensors as ``n`` per-layer dicts: each
    leaf is unbound once (views; the backward of ``unbind`` stacks the
    per-layer gradients once)."""
    out = [{} for _ in range(n)]
    for key, val in tree.items():
        parts = _unstack(val, n) if isinstance(val, dict) else val.unbind(0)
        for i in range(n):
            out[i][key] = parts[i]
    return out


# ==========================================================================
# Block body
# ==========================================================================

_ITEM = "ROADMAP.md queue 1, item 5b.5"


def _split(axes) -> tuple:
    """(shards, this rank's block) of a dim split over ``axes`` under the
    active mesh."""
    sh = Sharding(current_mesh(), (axes,))
    return sh.shards(0), sh.block(0)


def _check_mesh(cfg: ModelConfig) -> None:
    """Refuse what the port's split layers cannot run: rule sets that
    split ``seq`` or ``d_model``, and a ``'model'`` axis under the ssm and
    hybrid families (mamba2's ``in_proj`` packs z, x, B, C and dt into one
    ``d_inner`` dim that no column slice computes alone)."""
    mesh = current_mesh()
    if mesh is None or mesh.size <= 1:
        return
    rules = current_rules()
    for name in ("seq", "d_model"):
        if any(int(mesh.shape.get(a, 1)) > 1 for a in rules.axes_for(name)):
            raise NotImplementedError(
                f"{cfg.name}: rules that split {name!r} over "
                f"{rules.axes_for(name)} are not ported ({_ITEM})")
    inner = [a for a in rules.axes_for("d_inner")
             if int(mesh.shape.get(a, 1)) > 1]
    if (cfg.ssm or cfg.hybrid) and inner:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family with 'd_inner' over "
            f"{inner} of mesh {mesh.shape} is not ported ({_ITEM})")


def _head_split(cfg: ModelConfig) -> tuple:
    """The mesh axes this rank's heads are split over, and their count:
    ((), 1) when ``wq`` / ``wk`` / ``wv`` are whole. Raises, naming the
    leaf and the mesh, where the rules would cut a head (a column split
    that divides H·Dh or KV·Dh but not H or KV) or split the query heads
    without the KV heads."""
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    aq = split_axes(("d_model", "qkv"), (d, h * dh), 1)
    ak = split_axes(("d_model", "qkv"), (d, kv * dh), 1)
    if not aq and not ak:
        return (), 1
    mesh = current_mesh()
    for leaf, axes, heads in (("wq", aq, h), ("wk", ak, kv)):
        n = _split(axes)[0] if axes else 1
        if heads % n:
            raise ValueError(
                f"{cfg.name}: the rules split {leaf}'s {heads * dh} "
                f"columns over {axes} ({n} ranks of mesh {mesh.shape}), "
                f"which cuts its {heads} heads of {dh} (keep the attention "
                f"whole: dist.WHOLE_ATTENTION_RULES; the KV heads "
                f"replicated over the ranks are {_ITEM})")
    if aq != ak:
        raise ValueError(f"{cfg.name}: the rules split wq's columns over "
                         f"{aq} and wk's over {ak} on mesh {mesh.shape}: "
                         "the GQA groups would cross ranks")
    return aq, _split(aq)[0]


def heads_split_cleanly(cfg: ModelConfig) -> bool:
    """Whether the active mesh and rules split the attention without
    cutting a head (the layers raise where they would)."""
    try:
        _head_split(cfg)
    except ValueError:
        return False
    return True


def _attn_qkv(cfg, p, x, positions):
    """This rank's q, k, v heads: (B, H/n, S, Dh), (B, KV/n, S, Dh)."""
    b, s, _ = x.shape
    axes, n = _head_split(cfg)
    h, kv, dh = cfg.n_heads // n, cfg.n_kv_heads // n, cfg.head_dim
    if axes:
        x = copy_to_axis(x, current_mesh(), axes)
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rope(q.reshape(b, s, h, dh), positions, cfg.rope_theta).transpose(1, 2)
    k = rope(k.reshape(b, s, kv, dh), positions, cfg.rope_theta
             ).transpose(1, 2)
    v = v.reshape(b, s, kv, dh).transpose(1, 2)
    return q, k, v


def _mlp(cfg, p, x):
    if cfg.n_experts:
        return moe_layer(cfg, p["moe"], x)
    return glu_mlp(cfg, p["mlp"], x), torch.zeros((), device=x.device)


def _block(cfg: ModelConfig, p: dict, x: torch.Tensor, positions,
           is_global: bool, want_state: bool = False):
    """Full-sequence block. Returns (x', aux_loss, (k, v) or None, the
    mixer's final SSMSlice or None); the SSMSlice only with
    ``want_state`` (prefill)."""
    b, s, _ = x.shape
    aux = torch.zeros((), device=x.device)
    if cfg.ssm:
        out = M.mamba2_forward(cfg, p["mixer"], norm_apply(cfg, p["ln1"], x),
                               return_state=want_state)
        out, state = out if want_state else (out, None)
        return x + out, aux, None, state
    xn = norm_apply(cfg, p["ln1"], x)
    q, k, v = _attn_qkv(cfg, p["attn"], xn, positions)
    win = None if (is_global or cfg.window is None) else cfg.window
    attn = kops.flash_attention(q, k, v, causal=cfg.causal, window=win,
                                meta_len=cfg.n_meta_tokens)
    attn = _attn_out(cfg, p["attn"], attn.transpose(1, 2).reshape(b, s, -1))
    state = None
    if cfg.hybrid:
        out = M.mamba2_forward(cfg, p["ssm"], xn, return_state=want_state)
        ssm_out, state = out if want_state else (out, None)
        x = x + 0.5 * (attn * p["mix_attn"] + ssm_out * p["mix_ssm"])
    else:
        x = x + attn
    mlp_out, aux = _mlp(cfg, p, norm_apply(cfg, p["ln2"], x))
    return x + mlp_out, aux, (k, v), state


def _attn_out(cfg, p, attn):
    """(B, S, H·Dh) heads -> (B, S, D) through ``wo``: row-parallel, its
    partial products summed over the heads' axes, where they are
    split."""
    axes, _ = _head_split(cfg)
    out = attn @ p["wo"]
    return reduce_from_axis(out, current_mesh(), axes) if axes else out


# ==========================================================================
# Embedding / unembedding / the layer stack
# ==========================================================================

def _vocab_split(cfg: ModelConfig) -> tuple:
    """The axes the vocabulary is split over (the embedding's rows, the
    head's columns), or ()."""
    if cfg.tie_embeddings:
        return split_axes(("vocab", "d_model"),
                          (cfg.vocab_padded, cfg.d_model), 0)
    return split_axes(("d_model", "vocab"), (cfg.d_model, cfg.vocab_padded),
                      1)


def _vocab_range(cfg: ModelConfig, axes) -> tuple:
    """(first row, rows) of this rank's vocabulary slice."""
    n, blk = _split(axes)
    rows = cfg.vocab_padded // n
    return blk * rows, rows


def _embed_tokens(cfg: ModelConfig, params: dict, tokens: torch.Tensor):
    """The embedding lookup; vocab-parallel where the rows are split:
    rows outside this rank's range give zeros, then the sum over the
    vocabulary's axes (each token's row comes from the one rank that
    holds it, so the sum is exact)."""
    axes = split_axes(("vocab", "d_model"), (cfg.vocab_padded, cfg.d_model),
                      0)
    if not axes:
        return params["embed"][tokens.long()]
    lo, rows = _vocab_range(cfg, axes)
    t = tokens.long() - lo
    inside = (t >= 0) & (t < rows)
    x = params["embed"][t.clamp(0, rows - 1)]
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
    return reduce_from_axis(x, current_mesh(), axes)


def _embed_batch(cfg: ModelConfig, params: dict, batch: dict):
    """The input sequence: [meta tokens? | image prefix? | token
    embeddings or audio frames], in the config's dtype."""
    if cfg.family == "audio":
        x = batch["frames"].to(dtype_of(cfg))     # the stub front end's
    else:
        x = _embed_tokens(cfg, params, batch["tokens"])
    if cfg.family == "vlm" and "image_emb" in batch:
        x = torch.cat([batch["image_emb"].to(x.dtype), x], dim=1)
    if cfg.n_meta_tokens:
        meta = params["meta"][None].expand(x.shape[0], -1, -1).to(x.dtype)
        x = torch.cat([meta, x], dim=1)
    return x


def sequence_length(cfg: ModelConfig, batch: dict) -> int:
    """The positions the layers see for ``batch``: ``_embed_batch``'s
    sequence, without embedding it."""
    s = int(batch["frames" if cfg.family == "audio" else "tokens"].shape[1])
    if cfg.family == "vlm" and "image_emb" in batch:
        s += int(batch["image_emb"].shape[1])
    return s + cfg.n_meta_tokens


def _unembed(cfg: ModelConfig, params: dict, h: torch.Tensor):
    """The whole logits, on every rank: a vocab-split head's columns are
    gathered over their axes."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    axes = _vocab_split(cfg)
    logits = h @ w
    for a in reversed(axes):                      # the minor axis first
        logits = gather_dim(logits, current_mesh(), a, logits.dim() - 1)
    return logits


def _layer_segments(cfg: ModelConfig) -> list:
    """Contiguous runs of (start, stop, is_global) over the layer stack."""
    glob = set(cfg.global_layers) if cfg.window is not None else set()
    segs = []
    for i in range(cfg.n_layers):
        g = (i in glob) or cfg.window is None
        if segs and segs[-1][2] == g:
            segs[-1] = (segs[-1][0], i + 1, g)
        else:
            segs.append((i, i + 1, g))
    return segs


# ops whose outputs "dots" keeps: the 2-D matrix products (the
# reference's dots_with_no_batch_dims_saveable); batched products (the
# attention's, the experts' kernels) are recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else ckpt.CheckpointPolicy.PREFER_RECOMPUTE


REMAT_POLICIES = ("none", "full", "dots")


def _remat_block(cfg: ModelConfig):
    """``_block`` under ``cfg.remat`` when a gradient is being recorded."""
    if cfg.remat not in REMAT_POLICIES:
        raise ValueError(f"{cfg.name}: remat {cfg.remat!r} is not one of "
                         f"{REMAT_POLICIES}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return _block
    kw = dict(use_reentrant=False)
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
    return functools.partial(ckpt.checkpoint, _block, **kw)


def _run_layers(cfg, params, x, positions, kv_sink=None, ssm_sink=None):
    """All layers in order; ``kv_sink(i, k, v)`` receives each attention
    layer's K and V, ``ssm_sink(i, slice)`` each mixer's final SSMSlice.
    Returns (x, summed aux loss)."""
    aux = torch.zeros((), device=x.device)
    layers = _unstack(params["layers"], cfg.n_layers)
    block = _remat_block(cfg)
    want_state = ssm_sink is not None
    for lo, hi, is_global in _layer_segments(cfg):
        for i in range(lo, hi):
            x, a, kv, state = block(cfg, layers[i], x, positions, is_global,
                                    want_state)
            aux = aux + a
            if kv_sink is not None and kv is not None:
                kv_sink(i, *kv)
            if want_state:
                ssm_sink(i, state)
    return x, aux


def forward_hidden(cfg: ModelConfig, params: dict, batch: dict) -> tuple:
    """Embeds, runs all layers, final norm. -> (hidden, aux loss)."""
    _check_mesh(cfg)
    x = _embed_batch(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, aux = _run_layers(cfg, params, x, positions)
    return norm_apply(cfg, params["out_norm"], x), aux


def _chunked_xent(cfg: ModelConfig, params: dict, h: torch.Tensor,
                  targets: torch.Tensor, prefix_len: int) -> torch.Tensor:
    """Mean-per-token cross-entropy over B·S without the whole (B, S, V)
    logits at once: fp32 logits a chunk of ``cfg.logit_chunk`` positions
    at a time, the remainder chunk last, as the reference sums them.
    ``prefix_len`` leading positions (meta tokens, an image prefix) are
    skipped."""
    b = h.shape[0]
    h = h[:, prefix_len:]
    s = h.shape[1]
    t = targets[:, :s].long()
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    c = min(cfg.logit_chunk, s)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    axes = _vocab_split(cfg)
    if axes:
        mesh = current_mesh()
        v_lo, rows = _vocab_range(cfg, axes)
        h = copy_to_axis(h, mesh, axes)
    for lo in range(0, s, c):
        logits = (h[:, lo:lo + c] @ w).float()
        tc = t[:, lo:lo + c]
        if not axes:
            picked = logits.gather(-1, tc[..., None])[..., 0]
            tot = tot + torch.sum(torch.logsumexp(logits, dim=-1) - picked)
            continue
        # vocab-parallel: this rank's (B, c, V/n) columns only
        m = logits.detach().amax(-1)
        for a in axes:
            m = pmax(m, mesh, a)
        se = reduce_from_axis(torch.exp(logits - m[..., None]).sum(-1),
                              mesh, axes)
        tl = tc - v_lo
        inside = (tl >= 0) & (tl < rows)
        picked = logits.gather(-1, tl.clamp(0, rows - 1)[..., None])[..., 0]
        picked = reduce_from_axis(torch.where(inside, picked, 0.0), mesh,
                                  axes)
        tot = tot + torch.sum(m + torch.log(se) - picked)
    return tot / (b * s)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict) -> tuple:
    """-> (scalar loss, {"xent", "aux"}): the mean cross-entropy of the
    positions of ``batch["tokens"]`` (an audio batch's ``frames``)
    against ``batch["targets"]`` ((B, S) ints; the meta tokens' and an
    image prefix's positions skipped) plus ``cfg.router_aux_weight`` x
    the summed MoE load-balancing loss."""
    hidden, aux = forward_hidden(cfg, params, batch)
    prefix = cfg.n_meta_tokens + (
        cfg.n_prefix_tokens if cfg.family == "vlm" and "image_emb" in batch
        else 0)
    xent = _chunked_xent(cfg, params, hidden, batch["targets"], prefix)
    loss = xent + cfg.router_aux_weight * aux
    return loss, {"xent": xent, "aux": aux}


# ==========================================================================
# Serve path: cache init / prefill / decode
# ==========================================================================

def _slot_for(cfg: ModelConfig, pos: torch.Tensor, capacity: int):
    """Rolling-buffer slot with meta-token pinning."""
    m = cfg.n_meta_tokens
    if capacity >= FULL_ATTN_WINDOW:
        return pos
    roll = m + (pos - m) % max(capacity - m, 1)
    return torch.where(pos < m, pos, roll).to(torch.int32)


def _empty_cache(cfg: ModelConfig, b: int, kv: int, capacity: int,
                 device) -> dict:
    dt = dtype_of(cfg)
    l = cfg.n_layers
    cache = {"pos": torch.zeros((b,), dtype=torch.int32, device=device)}
    if cfg.has_attention:
        dh = cfg.head_dim
        cache["k"] = torch.zeros((l, b, kv, capacity, dh), dtype=dt,
                                 device=device)
        cache["v"] = torch.zeros((l, b, kv, capacity, dh), dtype=dt,
                                 device=device)
        cache["slot_pos"] = torch.full((b, capacity), -1, dtype=torch.int32,
                                       device=device)
    if cfg.ssm or cfg.hybrid:
        cache["ssm_state"] = torch.zeros(
            (l, b, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.d_state),
            dtype=torch.float32, device=device)
        cache["conv_buf"] = torch.zeros(
            (l, b, cfg.d_conv - 1, cfg.conv_dim), dtype=dt, device=device)
    return cache


def init_cache(cfg: ModelConfig, batch_size: int, capacity: int,
               device="cuda", mesh=None) -> dict:
    """Empty decode cache: with attention zero K/V (L, B, KV, C, Dh) and
    every slot -1; with a mixer (ssm, hybrid) zero fp32 SSM states (L, B,
    H, P, N) and conv tails (L, B, d_conv - 1, conv_dim). With ``mesh``
    (``batch_size`` the global batch), this rank's batch rows and KV
    heads, as ``dist.partition.cache_shardings`` splits them, on the
    mesh's device unless ``device`` is ``meta``."""
    if mesh is None:
        return _empty_cache(cfg, batch_size, cfg.n_kv_heads, capacity,
                            device)
    from repro_torch.dist.partition import cache_shardings
    full = _empty_cache(cfg, batch_size, cfg.n_kv_heads, capacity, "meta")
    sh = cache_shardings(mesh, full)
    b = sh["pos"].local_shape(full["pos"].shape)[0]
    kv = sh["k"].local_shape(full["k"].shape)[2] if "k" in full \
        else cfg.n_kv_heads
    dev = device if torch.device(device).type == "meta" else mesh.device
    return _empty_cache(cfg, b, kv, capacity, dev)


def prefill(cfg: ModelConfig, params: dict, batch: dict, capacity: int
            ) -> tuple:
    """Process a full prompt (``batch["tokens"]``, (B, S) int, or an audio
    batch's ``frames``); return (cache, last-position logits (B, 1,
    vocab_padded)). The meta tokens, where the config has them, and then
    a vlm batch's ``image_emb`` come first and take the cache's first
    slots."""
    _check_mesh(cfg)
    x = _embed_batch(cfg, params, batch)
    b, s, _ = x.shape
    if capacity < s:
        raise ValueError(f"prefill: a {s}-token prompt does not fit a "
                         f"{capacity}-slot cache")
    positions = torch.arange(s, device=x.device)[None, :]
    kv = cfg.n_kv_heads // _head_split(cfg)[1] if cfg.has_attention \
        else cfg.n_kv_heads
    cache = _empty_cache(cfg, b, kv, capacity, x.device)

    def kv_sink(i, k, v):
        cache["k"][i, :, :, :s] = k
        cache["v"][i, :, :, :s] = v

    def ssm_sink(i, state):
        cache["ssm_state"][i] = state.state
        cache["conv_buf"][i] = state.conv_buf

    x, _ = _run_layers(cfg, params, x, positions, kv_sink=kv_sink,
                       ssm_sink=ssm_sink if (cfg.ssm or cfg.hybrid)
                       else None)
    if cfg.has_attention:
        slots = torch.arange(capacity, device=x.device)[None].expand(
            b, capacity)
        cache["slot_pos"] = torch.where(slots < s, slots, -1).to(torch.int32)
    cache["pos"] = torch.full((b,), s, dtype=torch.int32, device=x.device)
    x = norm_apply(cfg, params["out_norm"], x)
    return cache, _unembed(cfg, params, x[:, -1:])


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor) -> tuple:
    """One decode step. tokens: (B, 1) int. Returns (logits (B, 1,
    vocab_padded), new cache). The new token's K/V, and each mixer's new
    SSM state and conv tail, are written into the cache's tensors in place
    (the returned cache holds the same tensors); ``pos`` and ``slot_pos``
    are new tensors."""
    _check_mesh(cfg)
    b = tokens.shape[0]
    pos = cache["pos"]                                  # (B,)
    x = _embed_tokens(cfg, params, tokens)              # (B, 1, D)
    windows = cfg.layer_windows(FULL_ATTN_WINDOW)
    bidx = torch.arange(b, device=x.device)
    slot_pos = None
    if cfg.has_attention:
        slot = _slot_for(cfg, pos, cache["k"].shape[3]).long()
        slot_pos = cache["slot_pos"].clone()  # register the incoming token
        slot_pos[bidx, slot] = pos            # BEFORE attention

    def mixer(i, p, xn):
        out, st = M.mamba2_decode(cfg, p, xn, M.SSMSlice(
            cache["ssm_state"][i], cache["conv_buf"][i]))
        cache["ssm_state"][i] = st.state
        cache["conv_buf"][i] = st.conv_buf
        return out

    for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
        xn = norm_apply(cfg, lp["ln1"], x)
        if cfg.ssm:
            x = x + mixer(i, lp["mixer"], xn)
            continue
        q, k, v = _attn_qkv(cfg, lp["attn"], xn, pos[:, None])
        cache["k"][i][bidx, :, slot] = k[:, :, 0]
        cache["v"][i][bidx, :, slot] = v[:, :, 0]
        kv = KVSlice(cache["k"][i], cache["v"][i], slot_pos)
        attn = decode_attention(q, kv, pos, window=int(windows[i]),
                                meta_len=cfg.n_meta_tokens)
        attn = _attn_out(cfg, lp["attn"], attn.reshape(b, 1, -1))
        if cfg.hybrid:
            ssm_out = mixer(i, lp["ssm"], xn)
            x = x + 0.5 * (attn * lp["mix_attn"] + ssm_out * lp["mix_ssm"])
        else:
            x = x + attn
        mlp_out, _ = _mlp(cfg, lp, norm_apply(cfg, lp["ln2"], x))
        x = x + mlp_out
    new_cache = dict(cache, pos=pos + 1)
    if cfg.has_attention:
        new_cache["slot_pos"] = slot_pos
    x = norm_apply(cfg, params["out_norm"], x)
    return _unembed(cfg, params, x), new_cache


class Model:
    """Thin OO facade over the functional API."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def init(self, generator: torch.Generator, device="cuda"):
        return init_params(self.cfg, generator, device)

    def loss(self, params, batch):
        return loss_fn(self.cfg, params, batch)

    def prefill(self, params, batch, capacity: int):
        return prefill(self.cfg, params, batch, capacity)

    def decode(self, params, cache, tokens):
        """One decode step; writes the new K/V into ``cache``'s ``k`` /
        ``v`` tensors and the new SSM states into ``ssm_state`` /
        ``conv_buf`` in place (the returned cache holds them too), so a
        caller that keeps an earlier cache copies it first."""
        return decode_step(self.cfg, params, cache, tokens)
