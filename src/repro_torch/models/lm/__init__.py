"""repro_torch.models.lm — the LM path of the port (dense and MoE
families): ``init_params``, ``loss_fn``, ``prefill``, ``decode_step`` and
their building blocks (``layers``, ``attention``, ``moe``,
``transformer``)."""
from repro_torch.models.lm.transformer import (PORTED_FAMILIES, Model,
                                               decode_step, forward_hidden,
                                               init_cache, init_params,
                                               loss_fn, params_from_jax,
                                               prefill)

__all__ = ["Model", "init_params", "init_cache", "loss_fn", "prefill",
           "decode_step", "forward_hidden", "params_from_jax",
           "PORTED_FAMILIES"]
