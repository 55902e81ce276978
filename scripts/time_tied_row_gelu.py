#!/usr/bin/env python3
"""The tied-row attention and GELU->int8 kernels on the card.

    python3 scripts/time_tied_row_gelu.py [--root CHECKOUT] [--label NAME]

Times, in the checkout at CHECKOUT (default: the one holding this script),
`tied_row_attention_cuda(q, k, v, 12, col_bias=...)` at B=4 H=12 D=64, at
depths 16 (embed_msas's) and 50 (the MSA data config's) and at 1024 and 512
columns, and on a batch padded as embed_msas pads one (four MSAs of 1000,
302, 517 and 190 columns in the bucket 1024), each beside
scaled_dot_product_attention over the same function (heads of R*64, the
scale and the column mask); and `gelu_quant_cuda(y)` at M=16384 rows of
5120 (the 650M hub's fc1 width) and 20480 (the ESM2-15B width's), bf16.
CUDA events over 30 calls after a warm-up (the checkout's
`chip_smoke.time_ms`); then the tied-row attention on heads of 16 (the
debug MSA tower's: B=2 R=4 L=128 H=4, and depth 50 at B=4 L=1024 H=4, the
last element's last third of columns padded), beside SDPA on heads of
R*16. `--root` lets one call time a parent checkout and
this one in turns. Prints one line a case with the time, the yardstick's
and the bound (bytes over 3.35 TB/s or bf16 operations over 989 TFLOP/s,
over the keys that carry weight), and the card's name and power limit.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_tied_row_gelu: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from chip_smoke import time_ms
    from oneprot_tpu_torch.kernels import gelu_quant
    from oneprot_tpu_torch.kernels import tied_row_attention as tra

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    label = args.label or args.root
    gen = torch.Generator(device="cuda").manual_seed(0)

    B, H = 4, 12
    for R, L, lens in ((16, 1024, None), (50, 1024, None), (16, 512, None),
                       (50, 512, None), (16, 1024, (1000, 302, 517, 190))):
        q, k, v = (torch.randn(B, R, L, H * 64, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(3))
        lens = lens or (L,) * B
        bias = torch.zeros(B, 1, 1, L, device="cuda")
        for b, n in enumerate(lens):
            bias[b, ..., n:] = -1e9
        ms = time_ms(lambda: tra.tied_row_attention_cuda(q, k, v, H, col_bias=bias), 30)
        tied = lambda x: x.view(B, R, L, H, 64).permute(0, 3, 2, 1, 4).reshape(
            B, H, L, R * 64)
        qt, kt, vt, mask = tied(q), tied(k), tied(v), bias.to(torch.bfloat16)
        ref = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=tra.tied_scale(64, R)), 30)
        keys, row_bytes = sum(lens), R * H * 64 * 2
        bound = max((2 * B * L + 2 * keys) * row_bytes / 3.35e12,
                    4.0 * H * L * keys * R * 64 / 989e12) * 1e3
        print(f"{label}: tied_row_attention_cuda B={B} R={R} L={L} H={H} columns "
              f"{'/'.join(map(str, lens))}: kernel {ms:.4f} ms, SDPA {ref:.4f} ms, "
              f"ratio {ms / ref:.3f}, bound {bound:.4f} ms ({smi})", flush=True)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()

    for B, R, L, H in ((2, 4, 128, 4), (4, 50, 1024, 4)):
        D = 16
        q, k, v = (torch.randn(B, R, L, H * D, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(3))
        bias = torch.zeros(B, 1, 1, L, device="cuda")
        bias[-1, ..., L - L // 3:] = -1e9
        ms = time_ms(lambda: tra.tied_row_attention_cuda(q, k, v, H, col_bias=bias), 30)
        tied = lambda x: x.view(B, R, L, H, D).permute(0, 3, 2, 1, 4).reshape(
            B, H, L, R * D)
        qt, kt, vt, mask = tied(q), tied(k), tied(v), bias.to(torch.bfloat16)
        ref = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=tra.tied_scale(D, R)), 30)
        keys, row_bytes = (B - 1) * L + L - L // 3, R * H * D * 2
        bound = max((2 * B * L + 2 * keys) * row_bytes / 3.35e12,
                    4.0 * H * L * keys * R * D / 989e12) * 1e3
        print(f"{label}: tied_row_attention_cuda B={B} R={R} L={L} H={H} D={D}: "
              f"kernel {ms:.4f} ms, SDPA {ref:.4f} ms, ratio {ms / ref:.3f}, "
              f"bound {bound:.4f} ms ({smi})", flush=True)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()

    for M, N in ((16384, 5120), (16384, 20480)):
        y = (torch.randn(M, N, device="cuda", generator=gen) * 2.0).to(torch.bfloat16)
        ms = time_ms(lambda: gelu_quant.gelu_quant_cuda(y), 30)
        bound = (3 * M * N + 4 * M) / 3.35e12 * 1e3
        print(f"{label}: gelu_quant_cuda M={M} N={N}: kernel {ms:.4f} ms, bound "
              f"{bound:.4f} ms ({smi})", flush=True)
        del y
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
