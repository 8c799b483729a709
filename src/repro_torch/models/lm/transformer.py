"""Config-driven LM training and serving: the dense and MoE families.

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
skips the KV tiles outside the band. The MoE layers' expert products go
through ``kernels.ops.ragged_gemm``. Decode attention stays
``decode_attention``, as in the reference. Both kernels are
differentiable (``kernels/ops.py``): their backwards are hand kernels on
the card too.

Not ported yet (ROADMAP queue 1): the ssm / hybrid families (mamba2,
hymba) and the audio and vlm front ends.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import FULL_ATTN_WINDOW, ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.lm.attention import KVSlice, decode_attention
from repro_torch.models.lm.layers import (dtype_of, glu_mlp, init_glu_mlp,
                                          init_norm, norm_apply, rope,
                                          truncated_normal_init)
from repro_torch.models.lm.moe import init_moe, moe_layer

__all__ = ["Model", "init_params", "init_cache", "loss_fn", "prefill",
           "decode_step", "forward_hidden", "params_from_jax",
           "PORTED_FAMILIES", "REMAT_POLICIES"]

PORTED_FAMILIES = ("dense", "moe")


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported to "
            f"repro_torch yet (ROADMAP queue 1: the ssm/hybrid families, "
            f"the audio and vlm front ends); ported: {PORTED_FAMILIES}")


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
    p = {"ln1": init_norm(cfg, device), "attn": _init_attn(gen, cfg, device),
         "ln2": init_norm(cfg, device)}
    if cfg.n_experts:
        p["moe"] = init_moe(gen, cfg, device)
    else:
        p["mlp"] = init_glu_mlp(gen, cfg, device)
    return p


def _stack(layers: list) -> dict:
    """Per-layer dicts -> one dict of (L, ...) tensors; each layer's
    tensors are released as their leaf is stacked."""
    out = {}
    for key in list(layers[0]):
        if isinstance(layers[0][key], dict):
            out[key] = _stack([lp[key] for lp in layers])
        else:
            out[key] = torch.stack([lp.pop(key) for lp in layers])
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Random params from ``generator`` (drawn on its device, stored on
    ``device`` in the config's dtype), the reference's init rules."""
    _check_ported(cfg)
    dt = dtype_of(cfg)
    params = {
        "embed": truncated_normal_init(
            generator, (cfg.vocab_padded, cfg.d_model), 1.0, dt, device),
        "out_norm": init_norm(cfg, device),
        "layers": _stack([_init_layer(generator, cfg, device)
                          for _ in range(cfg.n_layers)]),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = truncated_normal_init(
            generator, (cfg.d_model, cfg.vocab_padded), 1.0, dt, device)
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

def _attn_qkv(cfg, p, x, positions):
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
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
           is_global: bool):
    """Full-sequence block. Returns (x', aux_loss, (k, v))."""
    b, s, _ = x.shape
    xn = norm_apply(cfg, p["ln1"], x)
    q, k, v = _attn_qkv(cfg, p["attn"], xn, positions)
    win = None if (is_global or cfg.window is None) else cfg.window
    attn = kops.flash_attention(q, k, v, causal=cfg.causal, window=win)
    attn = attn.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim) \
        @ p["attn"]["wo"]
    x = x + attn
    mlp_out, aux = _mlp(cfg, p, norm_apply(cfg, p["ln2"], x))
    return x + mlp_out, aux, (k, v)


# ==========================================================================
# Embedding / unembedding / the layer stack
# ==========================================================================

def _embed_batch(cfg: ModelConfig, params: dict, batch: dict):
    return params["embed"][batch["tokens"].long()]


def _unembed(cfg: ModelConfig, params: dict, h: torch.Tensor):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w


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


def _run_layers(cfg, params, x, positions, kv_sink=None):
    """All layers in order; ``kv_sink(i, k, v)`` receives each layer's K
    and V. Returns (x, summed aux loss)."""
    aux = torch.zeros((), device=x.device)
    layers = _unstack(params["layers"], cfg.n_layers)
    block = _remat_block(cfg)
    for lo, hi, is_global in _layer_segments(cfg):
        for i in range(lo, hi):
            x, a, (k, v) = block(cfg, layers[i], x, positions, is_global)
            aux = aux + a
            if kv_sink is not None:
                kv_sink(i, k, v)
    return x, aux


def forward_hidden(cfg: ModelConfig, params: dict, batch: dict) -> tuple:
    """Embeds, runs all layers, final norm. -> (hidden, aux loss)."""
    _check_ported(cfg)
    x = _embed_batch(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, aux = _run_layers(cfg, params, x, positions)
    return norm_apply(cfg, params["out_norm"], x), aux


def _chunked_xent(cfg: ModelConfig, params: dict, h: torch.Tensor,
                  targets: torch.Tensor, prefix_len: int) -> torch.Tensor:
    """Mean-per-token cross-entropy over B·S without the whole (B, S, V)
    logits at once: fp32 logits a chunk of ``cfg.logit_chunk`` positions
    at a time, the remainder chunk last, as the reference sums them.
    ``prefix_len`` leading positions are skipped."""
    b = h.shape[0]
    h = h[:, prefix_len:]
    s = h.shape[1]
    t = targets[:, :s].long()
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    c = min(cfg.logit_chunk, s)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo in range(0, s, c):
        logits = (h[:, lo:lo + c] @ w).float()
        picked = logits.gather(-1, t[:, lo:lo + c, None])[..., 0]
        tot = tot + torch.sum(torch.logsumexp(logits, dim=-1) - picked)
    return tot / (b * s)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict) -> tuple:
    """-> (scalar loss, {"xent", "aux"}): the mean next-token
    cross-entropy of ``batch["tokens"]`` against ``batch["targets"]``
    ((B, S) ints) plus ``cfg.router_aux_weight`` x the summed MoE
    load-balancing loss."""
    hidden, aux = forward_hidden(cfg, params, batch)
    xent = _chunked_xent(cfg, params, hidden, batch["targets"],
                         cfg.n_meta_tokens)
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


def init_cache(cfg: ModelConfig, batch_size: int, capacity: int,
               device="cuda") -> dict:
    """Empty decode cache: zero K/V (L, B, KV, C, Dh), every slot -1."""
    _check_ported(cfg)
    dt = dtype_of(cfg)
    l, kv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    return {
        "pos": torch.zeros((batch_size,), dtype=torch.int32, device=device),
        "k": torch.zeros((l, batch_size, kv, capacity, dh), dtype=dt,
                         device=device),
        "v": torch.zeros((l, batch_size, kv, capacity, dh), dtype=dt,
                         device=device),
        "slot_pos": torch.full((batch_size, capacity), -1,
                               dtype=torch.int32, device=device),
    }


def prefill(cfg: ModelConfig, params: dict, batch: dict, capacity: int
            ) -> tuple:
    """Process a full prompt (``batch["tokens"]``, (B, S) int); return
    (cache, last-token logits (B, 1, vocab_padded))."""
    _check_ported(cfg)
    x = _embed_batch(cfg, params, batch)
    b, s, _ = x.shape
    if capacity < s:
        raise ValueError(f"prefill: a {s}-token prompt does not fit a "
                         f"{capacity}-slot cache")
    positions = torch.arange(s, device=x.device)[None, :]
    cache = init_cache(cfg, b, capacity, device=x.device)

    def sink(i, k, v):
        cache["k"][i, :, :, :s] = k
        cache["v"][i, :, :, :s] = v

    x, _ = _run_layers(cfg, params, x, positions, kv_sink=sink)
    slots = torch.arange(capacity, device=x.device)[None].expand(b, capacity)
    cache["slot_pos"] = torch.where(slots < s, slots, -1).to(torch.int32)
    cache["pos"] = torch.full((b,), s, dtype=torch.int32, device=x.device)
    x = norm_apply(cfg, params["out_norm"], x)
    return cache, _unembed(cfg, params, x[:, -1:])


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor) -> tuple:
    """One decode step. tokens: (B, 1) int. Returns (logits (B, 1,
    vocab_padded), new cache). The new token's K/V are written into the
    cache's K/V tensors in place (the returned cache holds the same
    tensors); ``pos`` and ``slot_pos`` are new tensors."""
    _check_ported(cfg)
    b = tokens.shape[0]
    pos = cache["pos"]                                  # (B,)
    x = params["embed"][tokens.long()]                  # (B, 1, D)
    windows = cfg.layer_windows(FULL_ATTN_WINDOW)
    capacity = cache["k"].shape[3]
    slot = _slot_for(cfg, pos, capacity).long()
    bidx = torch.arange(b, device=x.device)
    slot_pos = cache["slot_pos"].clone()     # register the incoming token
    slot_pos[bidx, slot] = pos               # BEFORE attention
    h, dh = cfg.n_heads, cfg.head_dim
    for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
        xn = norm_apply(cfg, lp["ln1"], x)
        q, k, v = _attn_qkv(cfg, lp["attn"], xn, pos[:, None])
        cache["k"][i][bidx, :, slot] = k[:, :, 0]
        cache["v"][i][bidx, :, slot] = v[:, :, 0]
        kv = KVSlice(cache["k"][i], cache["v"][i], slot_pos)
        attn = decode_attention(q, kv, pos, window=int(windows[i]))
        x = x + attn.reshape(b, 1, h * dh) @ lp["attn"]["wo"]
        mlp_out, _ = _mlp(cfg, lp, norm_apply(cfg, lp["ln2"], x))
        x = x + mlp_out
    new_cache = dict(cache, slot_pos=slot_pos, pos=pos + 1)
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
        ``v`` tensors in place (the returned cache holds them too), so a
        caller that keeps an earlier cache copies it first."""
        return decode_step(self.cfg, params, cache, tokens)
