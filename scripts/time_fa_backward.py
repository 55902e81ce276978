#!/usr/bin/env python3
"""The FlashAttention-2 backward on the card against SDPA's, kernel by kernel.

    python3 scripts/time_fa_backward.py [--root CHECKOUT] [--label NAME]
        [--shape B,H,L,D] [--ids]

Times, in the checkout at CHECKOUT (default: the one holding this script),
the dq kernel alone (`flash_attention_bwd_dq_cuda`, its prologue included),
the dk/dv kernel alone (`flash_attention_bwd_dkv_cuda`, on the dq kernel's
q_s and delta) and the whole card backward (`flash_attention_bwd_cuda`) at
one shape (default the LoRA-15B step's largest: B=16, 40 heads of 128,
L=1024), q, k, v and dout as views of [B, L, H*D] projections with a
key-padding bias; and scaled_dot_product_attention's backward on the same
inputs (forward + backward minus forward, the bias as a bf16 mask). With
`--ids` the same again on the hub's segment ids of train_packed's real
packed batch (the checkout's `chip_smoke.make_packed_batch` at
PACKED_SEG_SEED, its first B rows; L must be its 1024), SDPA then taking
the dense bf16 segment mask. CUDA events over 30 calls after a warm-up.
`--root` lets one call time a parent checkout and this one in turns.
Prints one line per kernel and case with the bound (3 and 4 products of
2BHL^2D for dq and dk/dv, 5 for the whole backward, at 989 TFLOP/s, over
the pairs of equal ids with `--ids`; or the bytes at 3.35 TB/s, if more), and the card's name and power limit.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

BF16_FLOPS, HBM_BYTES_S = 989e12, 3.35e12


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


def shape_arg(text: str):
    B, H, L, D = (int(x) for x in text.split(","))
    return B, H, L, D


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    ap.add_argument("--shape", type=shape_arg, default=(16, 40, 1024, 128),
                    help="B,H,L,D")
    ap.add_argument("--ids", action="store_true",
                    help="also time on a real packed batch's segment ids")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_fa_backward: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from chip_smoke import PACKED_SEG_SEED, make_packed_batch
    from oneprot_tpu_torch.kernels import flash_attention as fa
    from oneprot_tpu_torch.kernels import flash_mha

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    label = args.label or args.root
    B, H, L, D = args.shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(B, L, H * D, device="cuda", generator=gen)
               .to(torch.bfloat16).view(B, L, H, D).transpose(1, 2)
               for _ in range(3))
    lens = torch.randint(L // 2, L + 1, (B,), device="cuda", generator=gen)
    pad_valid = torch.arange(L, device="cuda")[None, :] < lens[:, None]
    dout_raw = torch.randn(B, L, H, D, device="cuda", generator=gen)
    cases = [("key-padding bias", pad_valid, None)]
    if args.ids:
        seg = torch.from_numpy(make_packed_batch(np.random.RandomState(
            PACKED_SEG_SEED))["seq"]["segment_ids"][:B]).cuda()
        if tuple(seg.shape) != (B, L):
            raise SystemExit(f"--ids needs B <= 16 and L = 1024, got {B}, {L}")
        cases.append(("real packed batch's ids", seg >= 0, seg))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for what, valid, seg in cases:
        bias = ((1.0 - valid.float()) * -1e9)[:, None, None, :]
        dout = (dout_raw * valid[:, :, None, None]).to(torch.bfloat16).transpose(1, 2)
        out, lse = fa.flash_attention_fwd_cuda(q, k, v, bias, seg)
        _, qs, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, bias, out, lse,
                                                      dout, seg)
        times = {
            "flash_attention_bwd_dq_cuda": time_ms(
                lambda: fa.flash_attention_bwd_dq_cuda(q, k, v, bias, out, lse,
                                                       dout, seg)),
            "flash_attention_bwd_dkv_cuda": time_ms(
                lambda: fa.flash_attention_bwd_dkv_cuda(qs, k, v, bias, dout,
                                                        lse, delta, seg)),
            "flash_attention_bwd_cuda": time_ms(
                lambda: fa.flash_attention_bwd_cuda(q, k, v, bias, out, lse,
                                                    dout, seg))}
        mask = (bias if seg is None else flash_mha.packed_segment_bias(
            seg, bias, mask_value=-1e30)).to(torch.bfloat16)
        leaves = [x.detach().contiguous().requires_grad_() for x in (q, k, v)]
        do_c = dout.contiguous()
        fwd = time_ms(lambda: sdpa(*leaves, attn_mask=mask))
        fwd_bwd = time_ms(lambda: torch.autograd.grad(
            sdpa(*leaves, attn_mask=mask), leaves, do_c))
        ref = fwd_bwd - fwd
        if seg is None:
            pairs = B * H * L * L
        else:
            s = seg.long()
            pairs = H * int(sum((r[:, None] == r[None, :]).sum().item() for r in s))
        tiles = ""
        if seg is not None:  # the skip rule's share at each kernel's tiles
            key_block = getattr(fa, "dkv_key_block", lambda d: fa.BLOCK)(D)
            share = lambda block: flash_mha.segment_tile_hits(
                seg, fa.TILE, block).float().mean().item()
            tiles = (f", skip rule's share of tiles: #6 {share(fa.BLOCK):.4f}, "
                     f"#7 {share(key_block):.4f}")
        qkvo, row, side = B * H * L * D * 2, B * H * L * 4, B * L * 8
        for name, gemms, nbytes in (
                ("flash_attention_bwd_dq_cuda", 3, 7 * qkvo + 2 * row + side),
                ("flash_attention_bwd_dkv_cuda", 4, 6 * qkvo + 2 * row + side),
                ("flash_attention_bwd_cuda", 5, 8 * qkvo + row + side)):
            t_ops = 2.0 * gemms * pairs * D / BF16_FLOPS
            t_bytes = nbytes / HBM_BYTES_S
            by = "bytes" if t_bytes >= t_ops else "operations"
            print(f"{label}: {name} B={B} H={H} L={L} D={D} {what}: "
                  f"{times[name]:.4f} ms, bound {max(t_ops, t_bytes) * 1e3:.4f} "
                  f"ms ({by}), "
                  f"SDPA backward {ref:.4f} ms (fwd+bwd {fwd_bwd:.4f} - fwd "
                  f"{fwd:.4f}), ratio to SDPA {times[name] / ref:.3f}{tiles} "
                  f"({smi})", flush=True)
        del out, lse, qs, delta, dout, leaves, do_c, mask
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
