"""Shared LM building blocks: norms, RoPE, dense and GLU-MLP params.

Functional, like the reference: params are dicts of tensors with the
reference's keys (per layer stacked on a leading L axis by the
transformer), and forwards are plain functions of (cfg, params, x).
Random init draws from an explicit ``torch.Generator`` on that
generator's device and then moves to ``device``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["dtype_of", "rmsnorm", "layernorm", "norm_apply", "rope",
           "glu_mlp", "act_fn", "init_norm", "init_dense", "init_glu_mlp",
           "truncated_normal_init"]

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
    act = act_fn(cfg)
    g = x @ p["wg"]
    u = x @ p["wu"]
    return (act(g) * u) @ p["wd"]
