#!/usr/bin/env python3
"""The whole FlashAttention-2 backward on the card against SDPA's.

    python3 scripts/time_fa_backward.py [--root CHECKOUT] [--label NAME]

Times `flash_attention_bwd_cuda(q, k, v, bias, out, lse, dout)` of the
checkout at CHECKOUT (default: the one holding this script) at the LoRA-15B
step's largest shape (B=16, 40 heads of 128, L=1024, q, k, v and dout as
views of [B, L, H*D] projections, a key-padding bias), and
scaled_dot_product_attention's backward on the same inputs (forward +
backward minus forward, the bias as a bf16 mask), with CUDA events over 30
calls after a warm-up. `--root` lets one call time a parent checkout and
this one in turns. Prints one line with both times and their ratio, and
the card's name and power limit. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

B, H, L, D = 16, 40, 1024, 128


def time_ms(fn, iters: int = 30) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_fa_backward: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from oneprot_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(B, L, H * D, device="cuda", generator=gen)
               .to(torch.bfloat16).view(B, L, H, D).transpose(1, 2)
               for _ in range(3))
    lens = torch.randint(L // 2, L + 1, (B,), device="cuda", generator=gen)
    valid = torch.arange(L, device="cuda")[None, :] < lens[:, None]
    bias = ((1.0 - valid.float()) * -1e9)[:, None, None, :]
    dout = (torch.randn(B, L, H, D, device="cuda", generator=gen)
            * valid[:, :, None, None]).to(torch.bfloat16).transpose(1, 2)
    out, lse = fa.flash_attention_fwd_cuda(q, k, v, bias)
    whole = time_ms(lambda: fa.flash_attention_bwd_cuda(q, k, v, bias, out,
                                                        lse, dout))
    leaves = [x.detach().contiguous().requires_grad_() for x in (q, k, v)]
    mask, do_c = bias.to(torch.bfloat16), dout.contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd = time_ms(lambda: sdpa(*leaves, attn_mask=mask))
    fwd_bwd = time_ms(lambda: torch.autograd.grad(
        sdpa(*leaves, attn_mask=mask), leaves, do_c))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"{args.label or args.root}: flash_attention_bwd_cuda {whole:.4f} ms, "
          f"SDPA backward {fwd_bwd - fwd:.4f} ms, ratio "
          f"{whole / (fwd_bwd - fwd):.3f} (B={B} H={H} L={L} D={D}; {smi})",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
