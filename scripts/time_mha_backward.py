#!/usr/bin/env python3
"""The whole flash-MHA backward on the card against SDPA's.

    python3 scripts/time_mha_backward.py [--root CHECKOUT] [--label NAME]

Times `flash_mha_bwd_cuda(q, k, v, out, lse, dout, H, ...)` of the checkout
at CHECKOUT (default: the one holding this script) at the 35M
struct-token tower's packed shape (B=16 rows of L=1024 tokens, 20 heads of
24, rotary, a padding bias), once with 16 equal segments a row and once
with the struct-token segment ids of a real packed batch (the checkout's
`chip_smoke.make_packed_batch`, numpy seed 3), and
scaled_dot_product_attention's backward on the same inputs (forward +
backward minus forward, on pre-rotated heads with the dense mask), with
CUDA events over 30 calls after a warm-up (the checkout's
`chip_smoke.time_ms`). `--root` lets one call time a
parent checkout and this one in turns. Prints one line a case with both
times and their ratio, and the card's name and power limit. Needs one CUDA
card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

B, L, H, D = 16, 1024, 20, 24


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_mha_backward: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from chip_smoke import make_packed_batch, time_ms
    from oneprot_tpu_torch.kernels import flash_mha
    from oneprot_tpu_torch.models.esm2 import rotary_cos_sin

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(B, L, H * D, device="cuda", generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    cos, sin = rotary_cos_sin(L, D, device="cuda")
    lens = torch.randint(L // 2, L + 1, (B,), device="cuda", generator=gen)
    valid = torch.arange(L, device="cuda")[None, :] < lens[:, None]
    equal = torch.where(valid, torch.arange(L, device="cuda")[None, :] * 16 // L,
                        -1).to(torch.int32)
    real = torch.from_numpy(make_packed_batch(np.random.RandomState(3))
                            ["mod"]["segment_ids"]).cuda()
    heads = lambda x: x.view(B, L, H, D).transpose(1, 2)
    qr = flash_mha.apply_rotary(heads(q).float(), cos, sin).to(torch.bfloat16)
    kr = flash_mha.apply_rotary(heads(k).float(), cos, sin).to(torch.bfloat16)
    leaves = [x.detach().contiguous().requires_grad_() for x in (qr, kr, heads(v))]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, seg in (("16 segments a row", equal), ("real packed batch", real)):
        bias = ((seg < 0).float() * -1e9)[:, None, None, :]
        side = dict(bias=bias, rope_cos=cos, rope_sin=sin, segment_ids=seg)
        dout = (torch.randn(B, L, H * D, device="cuda", generator=gen)
                * (seg >= 0)[..., None]).to(torch.bfloat16)
        out, lse = flash_mha.flash_mha_cuda(q, k, v, H, **side)
        whole = time_ms(lambda: flash_mha.flash_mha_bwd_cuda(
            q, k, v, out, lse, dout, H, **side), 30)
        mask = flash_mha.packed_segment_bias(seg, bias, mask_value=-1e30).to(
            torch.bfloat16)
        do_h = heads(dout).contiguous()
        fwd = time_ms(lambda: sdpa(*leaves, attn_mask=mask), 30)
        fwd_bwd = time_ms(lambda: torch.autograd.grad(
            sdpa(*leaves, attn_mask=mask), leaves, do_h), 30)
        print(f"{args.label or args.root}: {name}: flash_mha_bwd_cuda "
              f"{whole:.4f} ms, SDPA backward {fwd_bwd - fwd:.4f} ms, ratio "
              f"{whole / (fwd_bwd - fwd):.3f} (B={B} L={L} H={H} D={D}; {smi})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
