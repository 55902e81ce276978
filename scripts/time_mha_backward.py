#!/usr/bin/env python3
"""The flash-MHA kernels (#1-#3) of a checkout on the card, in bf16 or f32.

    python3 scripts/time_mha_backward.py [--root CHECKOUT] [--label NAME]
        [--dtype bf16|f32] [--experiments]

Times the kernels of the checkout at CHECKOUT (default: the one holding
this script) with CUDA events over 30 calls after a warm-up (the
checkout's `chip_smoke.time_ms`), on inputs made here from torch seed 0,
so two checkouts see the same ones: `--root` lets one call time a parent
checkout and this one in turns (parent, change, change, parent). Prints
one line a case and the card's name and power limit. Needs one CUDA card.

--dtype bf16 (the default): the whole backward `flash_mha_bwd_cuda` at the
35M struct-token tower's packed shape (B=16 rows of L=1024 tokens, 20
heads of 24, rotary, a padding bias), once with 16 equal segments a row
and once with the struct-token segment ids of a real packed batch (the
checkout's `chip_smoke.make_packed_batch`, numpy seed 3), beside
scaled_dot_product_attention's backward on the same inputs (forward +
backward minus forward, on pre-rotated heads with the dense mask) and
their ratio.

--dtype f32: the f32 forward (#1 f32, `flash_mha_cuda`), dq (#2 f32,
`flash_mha_bwd_dq_cuda`, its prologue included) and dk/dv (#3 f32,
`flash_mha_bwd_dkv_cuda`) one by one, at `F32_SHAPES`: the debug hubs'
packed rows (20 heads of 16, rotary, 16 equal segments a row, rows of
256-1024 tokens), the same width on the real packed batch's ids,
`bert_tiny`'s (2 heads of 64, a key-padding bias, no rotary), ragged
packed rows (L=200, rows of 50-200 tokens), and the debug hub's rows with
every tile visited (no segment ids, no bias) with and without rotary:
their dense TFLOP/s (4 B H L^2 D for the forward, 6 and 8 for dq and dk/dv)
against the 67 of f32 FMA and, with segment ids, the share of the 64 x 64
tile pairs the kernels visit (the pairs whose segment ranges meet) and, of
those, the share whose pairs all hold one id; then, on a line of its own,
dq + dk/dv beside scaled_dot_product_attention's f32 backward on the same
inputs (pre-rotated heads, the dense f32 mask of bias and segments, TF32
off): its forward, its forward + backward, and their difference, the
backward (both passes of it), each timed by CUDA events around 30 calls
(the stream's time, which the host's pace sets where launches outrun the
card) and as device time (the sum of the calls' kernels under
torch.profiler, over 10 calls). Then the registers and spills
`-Xptxas -v` reported for each instance in the three libraries (the
checkout's last build). --experiments then runs the checkout's
`chip_smoke.f32_experiments_phase` (debug_struct_token, train_packed and
debug_all_modalities through `cli.train.main` in f32) and prints each
experiment's wall seconds.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

B, L, H, D = 16, 1024, 20, 24
# (name, B, L, H, D, rotary, segments: a count a row or "real", padding
# bias, rows' shortest fraction)
F32_SHAPES = (("debug hub, packed", 16, 1024, 20, 16, True, 16, True, 4),
              ("debug hub, real packed batch", 16, 1024, 20, 16, True, "real",
               True, 4),
              ("bert_tiny", 16, 512, 2, 64, False, 0, True, 4),
              ("ragged packed rows", 8, 200, 20, 16, True, 3, True, 4),
              ("debug hub, every tile", 16, 1024, 20, 16, True, 0, False, 4),
              ("debug hub, every tile, no rotary", 16, 1024, 20, 16, False,
               0, False, 4))
FLOPS_PER_PAIR_D = {"fwd": 4, "dq": 6, "dkv": 8}
F32_LIBS = ("flash_mha_fwd_f32", "flash_mha_bwd_dq_f32",
            "flash_mha_bwd_dkv_f32")


def real_segments(make_packed_batch) -> torch.Tensor:
    """The struct-token segment ids [16, 1024] of the real packed batch."""
    return torch.from_numpy(make_packed_batch(np.random.RandomState(3))
                            ["mod"]["segment_ids"]).cuda()


def tile_shares(seg: torch.Tensor, tile: int = 64) -> tuple:
    """The share of tile x tile pairs a row's tiles visit (segment ranges
    [min, max] of their ids other than -1 meet, or both hold padding) and,
    of the visited, the share whose pairs all hold one id (one and the same
    id in both tiles, or padding only in both)."""
    visited = one_id = total = 0
    for row in seg.cpu().numpy():
        spans = []
        for t0 in range(0, len(row), tile):
            ids = row[t0:t0 + tile]
            real = ids[ids >= 0]
            spans.append((real.min() if real.size else None,
                          real.max() if real.size else None,
                          bool((ids < 0).any())))
        for lo_a, hi_a, pad_a in spans:
            for lo_b, hi_b, pad_b in spans:
                total += 1
                meet = (lo_a is not None and lo_b is not None
                        and lo_a <= hi_b and lo_b <= hi_a)
                if meet or (pad_a and pad_b):
                    visited += 1
                    one_id += ((meet and not pad_a and not pad_b
                                and lo_a == hi_a == lo_b == hi_b)
                               or (pad_a and pad_b and lo_a is None
                                   and lo_b is None))
    return visited / total, one_id / max(visited, 1)


def time_bf16(label, smi, make_packed_batch, time_ms, flash_mha,
              rotary_cos_sin) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(B, L, H * D, device="cuda", generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    cos, sin = rotary_cos_sin(L, D, device="cuda")
    lens = torch.randint(L // 2, L + 1, (B,), device="cuda", generator=gen)
    valid = torch.arange(L, device="cuda")[None, :] < lens[:, None]
    equal = torch.where(valid, torch.arange(L, device="cuda")[None, :] * 16 // L,
                        -1).to(torch.int32)
    real = real_segments(make_packed_batch)
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
        print(f"{label}: {name}: flash_mha_bwd_cuda "
              f"{whole:.4f} ms, SDPA backward {fwd_bwd - fwd:.4f} ms, ratio "
              f"{whole / (fwd_bwd - fwd):.3f} (B={B} L={L} H={H} D={D}; {smi})",
              flush=True)


def f32_inputs(shape, gen, make_packed_batch, rotary_cos_sin):
    _, b, n, h, d, rotary, segments, bias, shortest = shape
    q, k, v, dout = (torch.randn(b, n, h * d, device="cuda", generator=gen)
                     for _ in range(4))
    lens = torch.randint(n // shortest, n + 1, (b,), device="cuda",
                         generator=gen)
    valid = torch.arange(n, device="cuda")[None, :] < lens[:, None]
    seg = None
    if segments == "real":
        seg = real_segments(make_packed_batch).to(torch.int32)
        valid = seg >= 0
    elif segments:
        seg = torch.where(valid, (torch.arange(n, device="cuda")[None, :]
                                  * segments // n).repeat(b, 1),
                          -1).to(torch.int32)
    if not bias:
        valid = torch.ones_like(valid)
    side = {"bias": ((1.0 - valid.float()) * -1e9)[:, None, None, :]}
    if rotary:
        side["rope_cos"], side["rope_sin"] = rotary_cos_sin(n, d, device="cuda")
    if seg is not None:
        side["segment_ids"] = seg
    return q, k, v, dout * valid[..., None], side


def device_ms(fn, iters: int = 10) -> float:
    """Device time of one fn() call: the sum of the times of the kernels
    it launches under torch.profiler (the host's pace left out), over
    `iters` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total
               for e in prof.key_averages()) / iters / 1e3


def sdpa_f32_ms(q, k, v, dout, h, side, time_ms, flash_mha) -> tuple:
    """SDPA in f32 on the inputs of one f32 shape, on rotated heads with
    the dense f32 mask: (forward ms, forward + backward ms) by CUDA events,
    then the same two as device time."""
    b, n, hd = q.shape
    heads = lambda x: x.view(b, n, h, hd // h).transpose(1, 2)
    qh, kh = heads(q), heads(k)
    if "rope_cos" in side:
        qh, kh = (flash_mha.apply_rotary(x, side["rope_cos"], side["rope_sin"])
                  for x in (qh, kh))
    leaves = [x.detach().contiguous().requires_grad_()
              for x in (qh, kh, heads(v))]
    mask = side["bias"].expand(b, 1, n, n)
    if "segment_ids" in side:
        mask = mask + flash_mha.packed_segment_bias(
            side["segment_ids"], mask_value=flash_mha.SEG_MASK)
    mask = mask.contiguous()
    do_h = heads(dout).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd = lambda: sdpa(*leaves, attn_mask=mask)
    fwd_bwd = lambda: torch.autograd.grad(fwd(), leaves, do_h)
    return (time_ms(fwd, 30), time_ms(fwd_bwd, 30), device_ms(fwd),
            device_ms(fwd_bwd))


def time_f32(label, smi, make_packed_batch, time_ms, flash_mha,
             rotary_cos_sin) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in F32_SHAPES:
        name, b, n, h, d = shape[:5]
        q, k, v, dout, side = f32_inputs(shape, gen, make_packed_batch,
                                         rotary_cos_sin)
        out, lse = flash_mha.flash_mha_cuda(q, k, v, h, **side)
        _, q_r, delta = flash_mha.flash_mha_bwd_dq_cuda(q, k, v, out, lse,
                                                        dout, h, **side)
        times = {
            "fwd": time_ms(lambda: flash_mha.flash_mha_cuda(q, k, v, h, **side),
                           30),
            "dq": time_ms(lambda: flash_mha.flash_mha_bwd_dq_cuda(
                q, k, v, out, lse, dout, h, **side), 30),
            "dkv": time_ms(lambda: flash_mha.flash_mha_bwd_dkv_cuda(
                q_r, k, v, dout, lse, delta, h, **side), 30)}
        if "segment_ids" in side:
            shares = tile_shares(side["segment_ids"])
            extra = (f" ({100 * shares[0]:.1f}% of the 64 x 64 tile pairs "
                     f"visited, {100 * shares[1]:.1f}% of those one id)")
        else:
            extra = " (" + ", ".join(
                f"{kern} {FLOPS_PER_PAIR_D[kern] * b * h * n * n * d / ms / 1e9:.1f}"
                for kern, ms in times.items()) + " dense TFLOP/s)"
        print(f"{label}: {name} (B={b} L={n} H={h} D={d}): "
              + ", ".join(f"{kern} {ms:.4f} ms" for kern, ms in times.items())
              + f"{extra} ({smi})", flush=True)
        fwd, fwd_bwd, dev_fwd, dev_fwd_bwd = sdpa_f32_ms(
            q, k, v, dout, h, side, time_ms, flash_mha)
        both = times["dq"] + times["dkv"]
        dev_both = device_ms(lambda: flash_mha.flash_mha_bwd_dq_cuda(
            q, k, v, out, lse, dout, h, **side)) + device_ms(
            lambda: flash_mha.flash_mha_bwd_dkv_cuda(q_r, k, v, dout, lse,
                                                     delta, h, **side))
        print(f"{label}: {name}: dq + dkv {both:.4f} ms, SDPA f32 backward "
              f"{fwd_bwd - fwd:.4f} ms (forward + backward {fwd_bwd:.4f} "
              f"minus forward {fwd:.4f}), ratio {both / (fwd_bwd - fwd):.3f}; "
              f"device time: dq + dkv {dev_both:.4f} ms, SDPA f32 backward "
              f"{dev_fwd_bwd - dev_fwd:.4f} ms ({dev_fwd_bwd:.4f} minus "
              f"{dev_fwd:.4f}) ({smi})", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--experiments", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_mha_backward: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    import chip_smoke
    from oneprot_tpu_torch.kernels import _build, flash_mha
    from oneprot_tpu_torch.models.esm2 import rotary_cos_sin

    label = args.label or args.root
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    _build.build_all()
    common = (label, smi, chip_smoke.make_packed_batch, chip_smoke.time_ms,
              flash_mha, rotary_cos_sin)
    if args.dtype == "bf16":
        time_bf16(*common)
        return 0
    chip_smoke.exact_f32()
    time_f32(*common)
    for lib in F32_LIBS:
        for instance, line in chip_smoke.ptxas_report(_build.build_log(lib)):
            print(f"{label}: {lib} {instance}: {line}", flush=True)
    if args.experiments:
        chip_smoke.count_plain_calls()
        runs = chip_smoke.f32_experiments_phase(smi, {})
        for name, _ in chip_smoke.F32_EXPERIMENTS:
            print(f"{label}: f32 {name}: main {runs[name]['main_s']:.4f} s, "
                  f"{runs[name]['steps']} steps ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
