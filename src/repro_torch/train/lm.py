"""LM serving step factories: plain callables over the port's transformer
(PyTorch runs eagerly; there is nothing to jit). Training (``loss_fn``,
the train step, its optimizer and compression) is not ported yet."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import transformer as T

__all__ = ["make_prefill_step", "make_decode_step"]


def make_prefill_step(cfg: ModelConfig, capacity: int):
    def pre(params, batch):
        return T.prefill(cfg, params, batch, capacity)
    return pre


def make_decode_step(cfg: ModelConfig):
    def dec(params, cache, tokens):
        return T.decode_step(cfg, params, cache, tokens)
    return dec
