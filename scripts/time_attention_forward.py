#!/usr/bin/env python3
"""The two attention forwards on the card against SDPA's forward.

    python3 scripts/time_attention_forward.py [--root CHECKOUT] [--label NAME]
        [--shape B,H,L,D ...] [--ids]

Times, in the checkout at CHECKOUT (default: the one holding this script),
the flash-MHA forward `flash_mha_cuda(q, k, v, H, ...)` (rotary, a padding
bias) at the 650M hub's unpacked serving shape (B=32 L=1024 H=20 D=64) and
at the 35M struct-token tower's packed shape (B=16 L=1024 H=20 D=24), once
with 16 equal segments a row and once with the struct-token segment ids of
a real packed batch (the checkout's `chip_smoke.make_packed_batch`, numpy
seed 3); and the FlashAttention-2 forward `flash_attention_fwd_cuda(q, k,
v, bias)` (a padding bias, heads viewed out of [B, L, H*D]) at the ESM2-15B
width's serving shape (B=32 H=40 L=1024 D=128) and at D=64 and 256 (B=8
H=16 L=1024). Beside each, scaled_dot_product_attention's forward on the
same inputs (pre-rotated heads; the bias, or the dense segment mask, as a
bf16 mask). `--shape` (one or more) times the FlashAttention-2 forward alone
at those shapes instead of all of the above; `--ids` adds each FA-2 shape
again on the hub's segment ids of train_packed's real packed batch (the
checkout's `chip_smoke.make_packed_batch` at PACKED_SEG_SEED, its first B
rows; L = 1024), with the skip rule's share of tiles and the bound over the
pairs of equal ids. CUDA events over 30 calls after a warm-up (the
checkout's `chip_smoke.time_ms`). `--root` lets one call time a parent
checkout and this one in turns. Prints one line a case with both times and
their ratio, and the card's name and power limit. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    ap.add_argument("--shape", action="append", default=[],
                    type=lambda t: tuple(int(x) for x in t.split(",")),
                    help="B,H,L,D of the FA-2 forward (repeatable)")
    ap.add_argument("--ids", action="store_true",
                    help="also time the FA-2 shapes on real segment ids")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_attention_forward: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from chip_smoke import PACKED_SEG_SEED, make_packed_batch, time_ms
    from oneprot_tpu_torch.kernels import flash_attention as fa
    from oneprot_tpu_torch.kernels import flash_mha
    from oneprot_tpu_torch.models.esm2 import rotary_cos_sin

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    label = args.label or args.root
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(0)

    def report(what, ms, ref, extra=""):
        print(f"{label}: {what}: kernel {ms:.4f} ms, SDPA forward {ref:.4f} ms, "
              f"ratio {ms / ref:.3f}{extra} ({smi})", flush=True)

    # flash-MHA forward (#1)
    real = torch.from_numpy(make_packed_batch(np.random.RandomState(3))
                            ["mod"]["segment_ids"]).cuda()
    mha_cases = () if args.shape else (
        (32, 1024, 20, 64, "unpacked"), (16, 1024, 20, 24, "16 segments a row"),
        (16, 1024, 20, 24, "real packed batch"))
    for B, L, H, D, layout in mha_cases:
        q, k, v = (torch.randn(B, L, H * D, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(3))
        cos, sin = rotary_cos_sin(L, D, device="cuda")
        if layout == "real packed batch":
            seg = real
        else:
            lens = torch.randint(L // 2, L + 1, (B,), device="cuda", generator=gen)
            valid = torch.arange(L, device="cuda")[None, :] < lens[:, None]
            seg = torch.where(valid, torch.arange(L, device="cuda")[None, :] * 16 // L,
                              -1).to(torch.int32)
        bias = ((seg < 0).float() * -1e9)[:, None, None, :]
        side = dict(bias=bias, rope_cos=cos, rope_sin=sin)
        mask = bias
        if layout != "unpacked":
            side["segment_ids"] = seg
            mask = flash_mha.packed_segment_bias(seg, bias, mask_value=-1e30)
        ms = time_ms(lambda: flash_mha.flash_mha_cuda(q, k, v, H, **side), 30)
        heads = lambda x: x.view(B, L, H, D).transpose(1, 2)
        qr = flash_mha.apply_rotary(heads(q).float(), cos, sin).to(torch.bfloat16)
        kr = flash_mha.apply_rotary(heads(k).float(), cos, sin).to(torch.bfloat16)
        vh, m16 = heads(v).contiguous(), mask.to(torch.bfloat16)
        ref = time_ms(lambda: sdpa(qr, kr, vh, attn_mask=m16), 30)
        report(f"flash_mha_cuda B={B} L={L} H={H} D={D} {layout}", ms, ref)
        del q, k, v, qr, kr, vh, m16, mask
        torch.cuda.empty_cache()

    # FlashAttention-2 forward (#5)
    hub_ids = make_packed_batch(np.random.RandomState(PACKED_SEG_SEED))[
        "seq"]["segment_ids"]
    for B, H, L, D in args.shape or ((32, 40, 1024, 128), (8, 16, 1024, 64),
                                     (8, 16, 1024, 256)):
        q, k, v = (torch.randn(B, L, H * D, device="cuda", generator=gen)
                   .to(torch.bfloat16).view(B, L, H, D).transpose(1, 2)
                   for _ in range(3))
        lens = torch.randint(L // 2, L + 1, (B,), device="cuda", generator=gen)
        valid = torch.arange(L, device="cuda")[None, :] < lens[:, None]
        bias = ((1.0 - valid.float()) * -1e9)[:, None, None, :]
        ms = time_ms(lambda: fa.flash_attention_fwd_cuda(q, k, v, bias), 30)
        m16 = bias.to(torch.bfloat16)
        ref = time_ms(lambda: sdpa(q, k, v, attn_mask=m16), 30)
        bound = 4.0 * B * H * L * L * D / 989e12 * 1e3
        report(f"flash_attention_fwd_cuda B={B} H={H} L={L} D={D}", ms, ref,
               f", bound {bound:.4f} ms (operations)")
        if args.ids:
            seg = torch.from_numpy(hub_ids[:B]).cuda()
            if tuple(seg.shape) != (B, L):
                raise SystemExit(f"--ids needs B <= 16 and L = 1024, got {B}, {L}")
            sbias = ((seg < 0).float() * -1e9)[:, None, None, :]
            ms = time_ms(lambda: fa.flash_attention_fwd_cuda(q, k, v, sbias,
                                                             seg), 30)
            m16 = flash_mha.packed_segment_bias(seg, sbias, mask_value=-1e30
                                                ).to(torch.bfloat16)
            ref = time_ms(lambda: sdpa(q, k, v, attn_mask=m16), 30)
            s64 = seg.long()
            pairs = H * int(sum((r[:, None] == r[None, :]).sum().item()
                                for r in s64))
            share = flash_mha.segment_tile_hits(
                seg, fa.fwd_key_tile(D), fa.BLOCK).float().mean().item()
            report(f"flash_attention_fwd_cuda B={B} H={H} L={L} D={D} real "
                   f"packed batch's ids", ms, ref,
                   f", skip rule's share of tiles {share:.4f}, pairs needed "
                   f"{pairs / (B * H * L * L):.4f}, needed-work bound "
                   f"{4.0 * pairs * D / 989e12 * 1e3:.4f} ms (operations)")
        del q, k, v
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
