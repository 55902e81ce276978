"""Fused exact GELU -> per-row int8 quantization (the int8 hub's MLP epilogue).

Counterpart of oneprot_tpu/kernels/gelu_quant.py. Between the int8 fc1 and
fc2 products, `fused_gelu_quant(y)` turns y [..., N] (bf16 or f32) into
(q int8 [..., N], s f32 [..., 1]) with g = gelu(y) in f32 (exact erf),
s = max(max|g|, 1e-12) / 127 and q = round_half_even(g / s), which
`Int8Dense(pre_quant=...)` consumes. On a CUDA tensor it launches the kernel
of `csrc/gelu_quant.cu` or raises; on a CPU tensor it runs
`gelu_quant_reference`. The kernel takes erf from Abramowitz-Stegun 7.1.26,
as the TPU kernel does, and multiplies by one reciprocal of the scale a
row, so a code may differ by one from the plain version's where g / s sits
at a .5 tie (a few in a million of the hub's values).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from oneprot_tpu_torch.kernels import _build


def _check(y: torch.Tensor) -> None:
    if y.ndim < 1 or y.shape[-1] == 0:
        raise ValueError(f"expected [..., N] with N > 0, got {tuple(y.shape)}")
    if y.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"expected bfloat16 or float32, got {y.dtype}")


def gelu_quant_reference(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version (any device): f32 exact gelu + per-row symmetric
    abs-max int8 quantization. Returns (q int8 [..., N], s f32 [..., 1])."""
    _check(y)
    g = F.gelu(y.float(), approximate="none")
    s = g.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 127.0
    return torch.round(g / s).to(torch.int8), s


def gelu_quant_cuda(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on a contiguous bf16/f32 tensor on the card."""
    _check(y)
    if y.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got {y.device}")
    if not y.is_contiguous():
        raise ValueError("y must be contiguous")
    N = y.shape[-1]
    M = y.numel() // N
    q = torch.empty(y.shape, dtype=torch.int8, device=y.device)
    s = torch.empty((*y.shape[:-1], 1), dtype=torch.float32, device=y.device)
    if M == 0:
        return q, s
    fn = _build.library("gelu_quant")
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = fn(y.data_ptr(), int(y.dtype == torch.float32), q.data_ptr(),
                s.data_ptr(), M, N, stream)
    _build.check(rc, "gelu_quant")
    gelu_quant_cuda.launches += 1
    return q, s


gelu_quant_cuda.launches = 0


def fused_gelu_quant(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """gelu -> int8 on [..., N]: the plain version for a CPU tensor, the
    kernel for a CUDA tensor."""
    if y.device.type == "cpu":
        return gelu_quant_reference(y)
    return gelu_quant_cuda(y)
