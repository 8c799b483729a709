"""Shared LM building blocks: norms, RoPE, dense and GLU-MLP params.

Functional, like the reference: params are dicts of tensors with the
reference's keys (per layer stacked on a leading L axis by the
transformer), and forwards are plain functions of (cfg, params, x).
Random init draws from an explicit ``torch.Generator`` on that
generator's device and then moves to ``device``; on the ``meta`` device
it draws nothing (shapes only: ``train/lm.shaped_state``).

Under an active mesh whose rules split ``d_ff`` (``dist.sharding``),
:func:`glu_mlp` holds this rank's columns of ``wg`` / ``wu`` and rows of
``wd`` and is Megatron's pair: the input through ``copy_to_axis``, the
output through ``reduce_from_axis``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.collectives import copy_to_axis, reduce_from_axis
from repro_torch.dist.mesh import current_mesh
from repro_torch.dist.sharding import split_axes

__all__ = ["dtype_of", "rmsnorm", "layernorm", "norm_apply", "rope",
           "glu_mlp", "act_fn", "init_norm", "init_dense", "init_glu_mlp",
           "truncated_normal_init", "PARAM_AXES"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def act_fn(cfg):
    """silu, or gelu in its tanh form (``jax.nn.gelu``'s default)."""
    if cfg.act == "silu":
        return F.silu
    return lambda x: F.gelu(x, approximate="tanh")


def truncated_normal_init(generator: torch.Generator, shape, scale: float,
                          dtype, device="cuda") -> torch.Tensor:
    """Normal truncated to ±2 std, std = scale / sqrt(shape[0]) (the
    reference's fan-in rule, which takes the leading dim: E for a stacked
    expert weight), drawn in fp32 on the generator's device."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[0] if len(shape) > 1 else 1
    std = scale / max(fan_in, 1) ** 0.5
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * std).to(device=device, dtype=dtype)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def init_norm(cfg, device="cuda") -> dict:
    p = {"scale": torch.ones((cfg.d_model,), dtype=torch.float32,
                             device=device)}
    if cfg.norm == "layer":
        p["bias"] = torch.zeros((cfg.d_model,), dtype=torch.float32,
                                device=device)
    return p


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def norm_apply(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layer":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., S, H, D) rotary over the last dim, each head split in
    halves (not interleaved); positions: (..., S). Frequencies in fp32,
    ``log(theta)`` taken in fp32 as the reference takes it."""
    d = x.shape[-1]
    half = d // 2
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32)
                      * (log_theta / half)).to(x.device)       # (half,)
    ang = positions[..., None].float() * freqs                 # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                         # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Dense / GLU MLP
# --------------------------------------------------------------------------

def init_dense(generator: torch.Generator, in_dim: int, out_dim: int, dtype,
               *, bias: bool = False, scale: float = 1.0,
               device="cuda") -> dict:
    p = {"w": truncated_normal_init(generator, (in_dim, out_dim), scale,
                                    dtype, device)}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=dtype, device=device)
    return p


def init_glu_mlp(generator: torch.Generator, cfg, device="cuda") -> dict:
    dt = dtype_of(cfg)
    d, f = cfg.d_model, cfg.d_ff
    return {"wg": truncated_normal_init(generator, (d, f), 1.0, dt, device),
            "wu": truncated_normal_init(generator, (d, f), 1.0, dt, device),
            "wd": truncated_normal_init(generator, (f, d), 1.0, dt, device)}


def glu_mlp(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """(act(x wg) * x wu) wd; column-parallel ``wg`` / ``wu`` and
    row-parallel ``wd`` where the active rules split ``d_ff``."""
    act = act_fn(cfg)
    axes = split_axes(PARAM_AXES["wg"], (cfg.d_model, cfg.d_ff), 1)
    if axes:
        x = copy_to_axis(x, current_mesh(), axes)
    g = x @ p["wg"]
    u = x @ p["wu"]
    out = (act(g) * u) @ p["wd"]
    return reduce_from_axis(out, current_mesh(), axes) if axes else out


# Logical axes of the GLU MLP's leaves (``dist/partition.py`` holds every
# leaf's, by name).
PARAM_AXES = {
    "wg": ("d_model", "d_ff"),
    "wu": ("d_model", "d_ff"),
    "wd": ("d_ff", "d_model"),
}
