"""Ragged (grouped) GEMM for MoE experts: the hand-written CUDA kernel and
its plain PyTorch version.

``ragged_gemm_cuda`` launches ``csrc/ragged_gemm.cu``, the Hopper
replacement of the TPU kernel ``ragged_gemm_pallas``
(``src/repro/kernels/ragged_gemm.py``): ``out[m-tile] = x[m-tile] @
w[tile_expert[m]]`` over tm-row token tiles, each tile one expert's (the
dispatch pads every expert's rows to a multiple of tm). One CTA owns one
output tile and walks D itself, fp32 accumulation rounded to the output
type once. :func:`ragged_instance` picks the instance from dtype, shape
and alignment alone: ``wgmma`` (bf16 with D and F multiples of 8 and
16-byte aligned operands, the main path: TMA ring, ``wgmma`` m64n256k16,
128 x 256 tiles), ``wmma`` (other bf16 shapes: ``mma.sync`` on masked
shared-memory slices) or ``f32`` (the CUDA cores). The kernel is bound by
operations at prefill shapes and by the bytes of the expert weights at
decode shapes; the source's header says what each design does about
that. ``ragged_gemm_plain`` is the reference's XLA route (a gathered
weight per tile and one batched product); the CPU dispatch and the tests
use it.

Neither pads: ``T % tm`` or a ``tile_expert`` of the wrong length raises.

The backward (``kernels.ops.ragged_gemm`` is an ``autograd.Function``):
dX = dY · W[e]ᵀ is ``ragged_gemm_cuda(dY, W, tile_expert,
direction="backward")``, the same kernel reading the forward's (E, D, F)
weights transposed in place (the ``wgmma`` instance as its K-major B
operand: element (f, d) of Wᵀ is ``w[e][d][f]``, contiguous along the
product's depth F), counted as a ``backward`` launch in
``ragged_gemm_cuda.launches_by_direction``; nothing copies W. dW is
:func:`ragged_gemm_dw`, a batched product over experts laid out in equal
contiguous groups of rows (``moe_mlp``'s buffer). No TPU kernel computes
dW: the reference forms it by differentiating its einsum route in XLA.
"""
from __future__ import annotations

import torch

__all__ = ["ragged_gemm_cuda", "ragged_gemm_plain", "check_ragged_shapes",
           "ragged_instance", "ragged_gemm_dw", "INSTANCES"]

_ROW_TILE = 128                # the kernels' rows per CTA; tm % it == 0
_GRID_Y = 65_535               # the wmma / f32 instances' grid rows
# instance -> C entry point of csrc/ragged_gemm.cu
INSTANCES = {"wgmma": "ragged_gemm_bf16_wgmma", "wmma": "ragged_gemm_bf16",
             "f32": "ragged_gemm_f32"}


def ragged_instance(dtype: torch.dtype, d: int, f: int, x_ptr: int,
                    w_ptr: int) -> str:
    """The kernel instance for these operands, from dtype, shape and
    alignment alone: ``wgmma`` where TMA can stride both operands (bf16,
    D and F multiples of 8, x and w 16-byte aligned), ``wmma`` for any
    other bf16 operands, ``f32`` for fp32. Raises for any other dtype."""
    if dtype == torch.float32:
        return "f32"
    if dtype != torch.bfloat16:
        raise ValueError(f"ragged_gemm: x and w must both be bf16 or fp32, "
                         f"got {dtype}")
    if d % 8 == 0 and f % 8 == 0 and x_ptr % 16 == 0 and w_ptr % 16 == 0:
        return "wgmma"
    return "wmma"


def check_ragged_shapes(x: torch.Tensor, w: torch.Tensor,
                        tile_expert: torch.Tensor, tm: int,
                        transpose_w: bool = False) -> None:
    """Raise unless x is (T, D) with T % tm == 0 (with ``transpose_w``
    (T, F)), w is (E, D, F) and tile_expert holds one expert id per
    tm-row tile."""
    depth = 2 if transpose_w else 1
    if x.dim() != 2 or w.dim() != 3 or w.shape[depth] != x.shape[1]:
        want = "(T, F)" if transpose_w else "(T, D)"
        raise ValueError(f"ragged_gemm: x {want} and w (E, D, F) expected, "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if tm <= 0 or x.shape[0] % tm:
        raise ValueError(f"ragged_gemm: T = {x.shape[0]} is not a multiple "
                         f"of tm = {tm} (the dispatch pads each expert's "
                         f"rows to tm; nothing is padded here)")
    if tuple(tile_expert.shape) != (x.shape[0] // tm,):
        raise ValueError(f"ragged_gemm: tile_expert has shape "
                         f"{tuple(tile_expert.shape)}, want "
                         f"({x.shape[0] // tm},): one expert per {tm}-row "
                         f"tile")


def ragged_gemm_plain(x: torch.Tensor, w: torch.Tensor,
                      tile_expert: torch.Tensor, *, tm: int = 128,
                      transpose_w: bool = False) -> torch.Tensor:
    """Plain PyTorch ragged GEMM, the reference's XLA route: the (T // tm,
    D, F) gathered expert weights and one batched product. (T, F) in x's
    dtype; with ``transpose_w`` x is (T, F) and the result x @ w[e]ᵀ, (T,
    D) (the backward's dX, w read through a transposed view)."""
    check_ragged_shapes(x, w, tile_expert, tm, transpose_w)
    xt = x.reshape(-1, tm, x.shape[1])
    wt = w[tile_expert.long()]
    if transpose_w:
        return torch.bmm(xt, wt.transpose(1, 2)).reshape(x.shape[0],
                                                         w.shape[1])
    return torch.bmm(xt, wt).reshape(x.shape[0], w.shape[2])


def ragged_gemm_dw(x: torch.Tensor, dy: torch.Tensor, n_experts: int
                   ) -> torch.Tensor:
    """The weight gradient of the ragged GEMM where the T rows of x (T, D)
    and dy (T, F) are ``n_experts`` equal contiguous groups, expert e's
    rows e·T/E .. (e+1)·T/E (``moe_mlp``'s padded buffer, the layout of
    the reference's (E, C, D) einsum): dW[e] = x_eᵀ dy_e, (E, D, F) in
    x's dtype, one ``torch.bmm``."""
    t, d = x.shape
    if n_experts <= 0 or t % n_experts or dy.shape[0] != t:
        raise ValueError(f"ragged_gemm: dW needs the {t} rows in "
                         f"{n_experts} equal expert groups")
    c = t // n_experts
    return torch.bmm(x.reshape(n_experts, c, d).transpose(1, 2),
                     dy.reshape(n_experts, c, dy.shape[1]))


def ragged_gemm_cuda(x: torch.Tensor, w: torch.Tensor,
                     tile_expert: torch.Tensor, *, tm: int = 128,
                     direction: str = "forward") -> torch.Tensor:
    """(T, F) = x @ w[expert(token)] on the card through the hand kernel.
    x (T, D) and w (E, D, F) contiguous, both bf16 or both fp32;
    tile_expert (T // tm,) int32 with ids in [0, E) (not checked on the
    device: a host read would stall the stream). ``direction="backward"``
    is the autograd backward's dX: x is dY (T, F), w the forward's (E, D,
    F) read transposed in place, and the result dY @ w[e]ᵀ, (T, D).
    Counts its launches in ``ragged_gemm_cuda.launches``, by
    :func:`ragged_instance` in ``ragged_gemm_cuda.launches_by_instance``
    and by ``direction`` in ``ragged_gemm_cuda.launches_by_direction``. A
    build or launch failure raises; no other instance is tried."""
    from repro_torch.kernels.build import load_kernel

    if direction not in ragged_gemm_cuda.launches_by_direction:
        raise ValueError(f"ragged_gemm: direction {direction!r} is not "
                         f"forward or backward")
    trans = direction == "backward"
    check_ragged_shapes(x, w, tile_expert, tm, trans)
    if x.device.type != "cuda":
        raise ValueError(f"ragged_gemm: x must be a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32) or w.dtype != x.dtype:
        raise ValueError(f"ragged_gemm: x and w must both be bf16 or fp32, "
                         f"got {x.dtype} and {w.dtype}")
    for name, arr in (("x", x), ("w", w), ("tile_expert", tile_expert)):
        if arr.device != x.device or not arr.is_contiguous():
            raise ValueError(f"ragged_gemm: {name} must be contiguous on "
                             f"{x.device}")
    if tile_expert.dtype != torch.int32:
        raise ValueError(f"ragged_gemm: tile_expert must be int32, got "
                         f"{tile_expert.dtype}")
    if tm % _ROW_TILE:
        raise ValueError(f"ragged_gemm: tm = {tm} is not a multiple of the "
                         f"kernel's {_ROW_TILE}-row tile")
    t = x.shape[0]
    e, d, f = w.shape
    inst = ragged_instance(x.dtype, d, f, x.data_ptr(), w.data_ptr())
    if (inst != "wgmma" and t // 64 > _GRID_Y) or d >= 2 ** 31 or \
            f >= 2 ** 31:
        raise ValueError(f"ragged_gemm: shape {t} x {d} x {f} exceeds the "
                         f"launch grid")
    width = d if trans else f
    out = torch.empty((t, width), dtype=x.dtype, device=x.device)
    if t == 0 or width == 0:
        return out
    if x.shape[1] == 0:
        return out.zero_()
    fn = getattr(load_kernel("ragged_gemm"), INSTANCES[inst])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), tile_expert.data_ptr(),
                out.data_ptr(), t, d, f, tm, e, int(trans), stream)
    if rc != 0:
        raise RuntimeError(f"ragged_gemm launch failed ({inst}): CUDA error "
                           f"{rc}")
    ragged_gemm_cuda.launches += 1
    ragged_gemm_cuda.launches_by_instance[inst] += 1
    ragged_gemm_cuda.launches_by_direction[direction] += 1
    return out


ragged_gemm_cuda.launches = 0
ragged_gemm_cuda.launches_by_instance = dict.fromkeys(INSTANCES, 0)
ragged_gemm_cuda.launches_by_direction = dict.fromkeys(
    ("forward", "backward"), 0)
