#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/H100 port (oneprot_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the checkout; imports torch, numpy, the
standard library and oneprot_tpu_torch only. Phases, each announced with
the elapsed seconds:

1. device: card name, power limit, torch and CUDA versions;
2. build: every CUDA kernel of the serving and training paths, from the
   checkout's sources, one nvcc call per source, all at once;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes its path gives it (the flash-MHA forward and backward at the
   35M tower's and the hub's packed shapes, at the tower's unpacked shape
   and on the struct-token segment ids of a real packed batch, the
   backward's dq kernel with its prologue (q_r and delta) and its dk/dv
   kernel each against its own plain version too, each case timed beside
   SDPA's backward with the share of tiles the kernels visit and the bound
   over the logit pairs the inputs need, and the forward timed at each case
   beside SDPA's forward with the share of its query-block x key-tile pairs
   it visits and its needed-work and dense bounds; the tied-row attention at
   embed_msas's depth 16 and the MSA data config's depth 50 at 1024 and 512
   columns, off the tile grid and on a batch padded to its bucket; the
   GELU->int8 kernel at the 650M hub's fc1 width and the 15B width's; the
   FlashAttention-2 forward at the ESM2-15B width's B=32 H=40 L=1024
   D=128, at D=64 and 256, at L=300 and on heads of 24 padded by
   dot_product_attention, its dq kernel (with the backward's prologue:
   q_s and delta) and dk/dv kernel at the LoRA step's B=16 H=40 L=1024
   D=128, at D=64 and 256 and at L=300), with its time, the plain
   version's, a library call's where one computes the same function, and
   the card's lower bound; the whole FA-2 backward on the card (dq, then
   dk/dv) is timed beside scaled_dot_product_attention's backward;
4. serving: the full-width ESM2-650M hub (random weights from a seed) with
   the 1024-wide mlp head answers 3 requests of 32 sequences and one top-10
   retrieval, bf16 hub then int8 hub, each built by `create_sequence_encoder`
   with its defaults (bf16, on the card); the launch counters, set to 0
   before each hub and read after it, show its kernels ran;
5. parity: the same weights at 2 layers on the card (bf16, kernels) against
   the CPU (f32, plain versions);
6. serving at the ESM2-15B width: `create_sequence_encoder` on the
   committed HF config.json of esm2_t48_15B_UR50D (48 layers of 5120, 40
   heads of 128, FFN 20480; random weights from a seed, bf16, 30 GB on
   the card) with the mlp head answers 3 requests of 32 sequences (their
   own numpy seed) and one top-10 retrieval; every attention runs through
   the FlashAttention-2 kernel, none through flash-MHA; then the same
   weights at 2 layers, card (bf16, kernels) against CPU (f32, plain), as
   they are and quantized to the int8 hub (its 20480-wide fc1 rows through
   the GELU->int8 kernel), and the hub is freed;
7. serving MSA-1b: the full-width esm_msa1b tower (12 x 768, random weights
   from a seed) with its mlp head, built by `create_msa_encoder` with its
   defaults, answers 3 requests of 4 synthetic .a3m MSAs (64 homologs
   each, with gaps and insertions) through `embed_msas`'s defaults (depth
   16, batch 4, up to 1024 columns) and one top-10 retrieval; every row
   attention runs through the tied-row kernel;
8. MSA parity: the same weights at 2 layers, card (bf16, kernel) against
   CPU (f32, plain version), on the tower's output token by token and on
   the embeddings;
9. training: bench.py's model at full width (frozen ESM2-650M hub with its
   mlp head, trainable ESM2-35M struct-token tower, CLIP + 0.01 L1, clipped
   Adam at SMOKE_LR), built by `create_sequence_encoder`,
   `create_struct_token_encoder` and `OneProtModule`, takes 6
   `train_step_packed` steps on one packed batch (16 rows of 1024 tokens,
   16 slots), then 6
   `train_step_packed_cached` steps on the hub's pooled features; the
   counters, set to 0 before each path, show every attention ran through
   the kernels (and no plain version ran), and the loss falls;
10. training parity: the same weights at 2 hub + 2 tower layers, one packed
   step on the card (bf16, kernels) against the CPU (f32, plain versions),
   and cached == uncached on the card;
11. LoRA training at the ESM2-15B width: `create_sequence_encoder` on the
   committed config.json with LoRA (r 16, alpha 16, dropout 0.1 on q, k,
   v), frozen bf16 weights and per-layer remat, the mlp head, the
   trainable ESM2-35M struct-token tower, CLIP + 0.01 L1 and clipped Adam
   at SMOKE_LR, takes 4 unpacked `train_step`s, each on a fresh batch of
   16 pairs bucketed to at most 1024 tokens; the counters show the exact
   launches per step (the FlashAttention-2 forward twice a hub layer,
   forward and remat recompute; its dq and dk/dv kernels once a hub
   layer; flash-MHA once a tower layer each way; no plain version), a
   fifth step is split into forward, backward and clip + Adam by CUDA
   events, and a sixth, on the same batch, is profiled (torch.profiler:
   device time by kernel group);
12. LoRA training parity: the same initial weights at 2 hub + 2 tower
   layers, LoRA dropout 0, two unpacked steps on the card (bf16, kernels)
   against the CPU (f32, plain versions); the second step starts both
   from the CPU's weights after the first (see `lora_parity`).

Every check raises on failure, so the exit code is non-zero. The last line
is {"ok": true, "device": {...}}; the line before it lists the kernels.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from oneprot_tpu_torch.data import packing
from oneprot_tpu_torch.kernels import _build, flash_mha, gelu_quant
from oneprot_tpu_torch.kernels import flash_attention as fa
from oneprot_tpu_torch.kernels import tied_row_attention as tra
from oneprot_tpu_torch.models import esm2, msa_transformer
from oneprot_tpu_torch.models.encoders import (
    OneProtModel,
    SequenceEncoder,
    StructTokenEncoder,
    create_msa_encoder,
    create_sequence_encoder,
    create_struct_token_encoder,
)
from oneprot_tpu_torch.serving import OneProtEmbedder
from oneprot_tpu_torch.train.module import OneProtModule
from oneprot_tpu_torch.train.optim import adam

T0 = time.time()

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor-core
# flop/s, f32 flop/s outside the tensor cores
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
FLASH_REL_TOL = 1.5e-2     # max |kernel - plain| / max |plain|, bf16
# exp2 a second on the card's special-function units (the FA-3 paper's
# figure for the H100 SXM: 3.9 TFLOP/s of exponentials)
SFU_EXP2_S = 3.9e12
SCALE_REL_TOL = 1e-5       # GELU->int8 row scales
CODE_FLIP_SHARE = 1e-3     # GELU->int8 codes off by one, at most this share
N_LAYERS = 33
# ESM2 at its largest published size, widths from its HF config.json
WIDE_HUB = esm2.HUB_CONFIG_DIR / "esm2_t48_15B_UR50D"
WIDE_LAYERS = 48
TOWER_LAYERS = 12
AAS = "ACDEFGHIKLMNPQRSTVWY"
BUCKETS = (256, 384, 512, 768, 1024)
# the packed step of configs/experiment/train_packed.yaml: 16 rows of 1024
# tokens (bench.py's 16384-token budget), 16 slots a row
ROWS, ROW_LEN, SLOTS = 16, 1024, 16
PACKED_SEG_SEED = 3  # the kernels phase's packed batch (segment ids only)
STEPS = 6
PARITY_ROWS = 4
# MSA serving: 3 requests of 4 MSAs, 64 homologs of one query each, through
# embed_msas's defaults (depth 16, batch 4, up to 1024 columns)
MSA_REQUESTS, MSAS_PER_REQUEST, HOMOLOGS = 3, 4, 64
MSA_LAYERS, MSA_DEPTH = 12, 16
# MSA parity: the least cosine of any unpadded token of the 2-layer tower's
# output, card (bf16) against CPU (f32)
MSA_TOKEN_COS = 0.999
# Adam's rate here: at bench.py's 1e-3 the loss of random weights on one
# repeated batch rises above its start within a few steps, in the JAX
# package's step as in the port's (tests/test_torch_train_steps.py holds the
# two step for step at the tower's full width; scripts/profile_torch_train.py
# shows it at full width on the card); at 1e-4 it falls step after step. The
# rate changes no work done in a step.
SMOKE_LR = 1e-4
# the LoRA-15B step: 16 pairs a step, LoRA as configs/model/components/
# sequence.yaml sets it (use_lora: r 16, alpha 16, dropout 0.1 on q/k/v)
LORA_BATCH, LORA_STEPS = 16, 4
LORA = dict(use_lora=True, lora_r=16, lora_alpha=16, lora_dropout=0.1)


def phase(name: str) -> None:
    print(f"[{time.time() - T0:7.1f} s] {name}", flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def sample_seqs(n: int, rng) -> list:
    """Log-normal lengths around 290 residues, clipped to [20, 1022]."""
    lens = np.clip(rng.lognormal(np.log(290.0), 0.75, n), 20, 1022).astype(int)
    return ["".join(rng.choice(list(AAS), n_res)) for n_res in lens]


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() over `iters` launches after a warm-up."""
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


LAUNCHERS = {"flash_mha_fwd": flash_mha.flash_mha_cuda,
             "flash_mha_bwd_dq": flash_mha.flash_mha_bwd_dq_cuda,
             "flash_mha_bwd_dkv": flash_mha.flash_mha_bwd_dkv_cuda,
             "gelu_quant": gelu_quant.gelu_quant_cuda,
             "tied_row_attention": tra.tied_row_attention_cuda,
             "flash_attention_fwd": fa.flash_attention_fwd_cuda,
             "flash_attention_bwd_dq": fa.flash_attention_bwd_dq_cuda,
             "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv_cuda}
# the plain versions, counted by the wrappers `count_plain_calls` installs
PLAINS = ((flash_mha, "mha_attention_plain"),
          (flash_mha, "mha_attention_bwd_plain"),
          (flash_mha, "flash_mha_bwd_dq_plain"),
          (flash_mha, "flash_mha_bwd_dkv_plain"),
          (gelu_quant, "gelu_quant_reference"),
          (tra, "tied_row_attention_plain"),
          (fa, "flash_attention_plain"),
          (fa, "flash_attention_bwd_plain"),
          (fa, "flash_attention_bwd_dq_plain"),
          (fa, "flash_attention_bwd_dkv_plain"))
PLAIN_CALLS = {name: 0 for _, name in PLAINS}


def count_plain_calls() -> None:
    """Count every call of a plain version from here on, so a run can show
    that none stood in for a kernel on the card."""
    for mod, name in PLAINS:
        def counted(*args, _fn=getattr(mod, name), _name=name, **kw):
            PLAIN_CALLS[_name] += 1
            return _fn(*args, **kw)

        setattr(mod, name, counted)


def reset_launches() -> None:
    for fn in LAUNCHERS.values():
        fn.launches = 0
    for name in PLAIN_CALLS:
        PLAIN_CALLS[name] = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in LAUNCHERS.items()}


def ptxas_report(log: str) -> list:
    """(template arguments, registers and spills) of each kernel instance
    in nvcc's -Xptxas=-v output, e.g. ("<128,64>", "Used 168 registers,
    ...; 0 bytes spill stores, 0 bytes spill loads"), and ("note", line)
    for each of ptxas's C75xx performance notes (wgmma serialised, ...)."""
    out, instance, spills = [], "", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            instance = "<" + ",".join(re.findall(r"Li(\d+)E", line)) + ">"
        elif re.search(r"\(C75\d\d\)", line):
            out.append(("note", line.strip()))
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line:
            out.append((instance, line.split(":", 1)[-1].strip() + "; " + spills))
    return out


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def attention_inputs(B, L, H, D, gen, segments=False, n_seg=4):
    dev = "cuda"
    q, k, v = (torch.randn(B, L, H * D, device=dev, generator=gen,
                           dtype=torch.float32).to(torch.bfloat16)
               for _ in range(3))
    lens = torch.randint(L // 2, L + 1, (B,), device=dev, generator=gen)
    valid = torch.arange(L, device=dev)[None, :] < lens[:, None]
    bias = ((1.0 - valid.float()) * -1e9)[:, None, None, :]
    cos, sin = esm2.rotary_cos_sin(L, D, device=dev)
    seg = None
    if segments:  # n_seg contiguous proteins per row, padding as its own id
        seg = (torch.arange(L, device=dev)[None, :] * n_seg // L).repeat(B, 1)
        seg = torch.where(valid, seg, -1).to(torch.int32)
    return q, k, v, bias, cos, sin, seg, valid


def check_flash(gen) -> dict:
    H, D = 20, 64
    worst_rel, worst_abs, worst_lse = 0.0, 0.0, 0.0
    cases = [(8, 64, False), (8, 512, False), (8, 1024, False), (8, 512, True),
             (32, 1024, False)]
    for B, L, segmented in cases:
        q, k, v, bias, cos, sin, seg, valid = attention_inputs(B, L, H, D, gen,
                                                               segmented)
        out, lse = flash_mha.mha_attention(q, k, v, H, bias=bias, rope_cos=cos,
                                           rope_sin=sin, segment_ids=seg)
        ref, ref_lse = flash_mha.mha_attention_plain(
            q, k, v, H, bias=bias, rope_cos=cos, rope_sin=sin, segment_ids=seg)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs().max().item()
        rel = diff / max(ref.float().abs().max().item(), 1e-6)
        # lse on real rows only: a padded row of a packed batch sees only
        # keys at -1e9, where f32 keeps no digits of the logits
        lse_err = (lse - ref_lse).abs()[valid[:, None, :].expand_as(lse)].max().item()
        require(torch.isfinite(out.float()).all().item(), f"flash L={L}: non-finite")
        print(f"  flash-MHA B={B} L={L} H={H} D={D} segments={segmented}: "
              f"max rel err {rel:.3e}, max abs err {diff:.3e}, "
              f"lse max abs err {lse_err:.3e}", flush=True)
        require(rel <= FLASH_REL_TOL, f"flash L={L}: rel err {rel} > {FLASH_REL_TOL}")
        require(lse_err <= 5e-2, f"flash L={L}: lse err {lse_err}")
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, diff)
        worst_lse = max(worst_lse, lse_err)

    # timed at the serving path's largest shape: a batch of 32 at bucket 1024
    B, L = cases[-1][:2]
    q, k, v, bias, cos, sin, _, _ = attention_inputs(B, L, H, D, gen)
    kernel = time_ms(lambda: flash_mha.mha_attention(
        q, k, v, H, bias=bias, rope_cos=cos, rope_sin=sin))
    plain = time_ms(lambda: flash_mha.mha_attention_plain(
        q, k, v, H, bias=bias, rope_cos=cos, rope_sin=sin), iters=5)
    heads = lambda x: x.view(B, L, H, D).transpose(1, 2)
    qr = flash_mha.apply_rotary(heads(q).float(), cos, sin).to(torch.bfloat16)
    kr = flash_mha.apply_rotary(heads(k).float(), cos, sin).to(torch.bfloat16)
    vh, mask = heads(v).contiguous(), bias.to(torch.bfloat16)
    library = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qr, kr, vh, attn_mask=mask))
    nbytes = 4 * B * L * H * D * 2 + B * L * 4 + B * H * L * 4 + 2 * L * D * 4
    b_ms, b_by = bound_ms(nbytes, 4.0 * B * H * L * L * D, BF16_FLOPS)
    print(f"  flash-MHA timed at B={B} L={L}: kernel {kernel:.4f} ms, plain "
          f"{plain:.4f} ms, SDPA {library:.4f} ms, bound {b_ms:.4f} ms ({b_by})",
          flush=True)
    return {"name": "flash_mha_fwd", "route": "cuda",
            "source": "oneprot_tpu_torch/kernels/csrc/flash_mha_fwd.cu",
            "replaces": "oneprot_tpu/kernels/flash_mha.py:157",
            "max_abs_err": worst_abs, "max_rel_err": worst_rel,
            "lse_max_abs_err": worst_lse, "ms": kernel, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library,
            "shape": f"B={B} L={L} H={H} D={D} bf16", "cases": [],
            "note": "cases: the forward timed at each flash-MHA backward "
                    "case (packed shapes: tiles visited, needed-work and "
                    "dense bounds, SDPA's forward with the dense mask)"}


def check_gelu_quant(gen) -> dict:
    """The GELU->int8 kernel against its plain version at the 650M hub's
    int8 MLP shape (a batch of 32 x 512 tokens, fc1 width 5120) and at the
    ESM2-15B width's (20480: rows read once); each timed beside the plain
    version and its byte bound. The first is the row, the second a case."""
    cases = []
    for M, N in ((32 * 512, 5120), (32 * 512, 20480)):
        y = (torch.randn(M, N, device="cuda", generator=gen) * 2.0).to(torch.bfloat16)
        q, s = gelu_quant.fused_gelu_quant(y)
        q_ref, s_ref = gelu_quant.gelu_quant_reference(y)
        torch.cuda.synchronize()
        code_diff = (q.int() - q_ref.int()).abs()
        max_diff = code_diff.max().item()
        flips = code_diff.ne(0).float().mean().item()
        scale_rel = ((s - s_ref).abs() / s_ref).max().item()
        deq_err = (q.float() * s - q_ref.float() * s_ref).abs().max().item()
        print(f"  gelu->int8 M={M} N={N}: max code diff {max_diff}, "
              f"share off by one {flips:.2e}, scale max rel err {scale_rel:.2e}, "
              f"dequantized max abs err {deq_err:.3e}", flush=True)
        require(max_diff <= 1, f"gelu->int8 N={N}: codes differ by > 1")
        require(flips <= CODE_FLIP_SHARE, f"gelu->int8 N={N}: {flips} of codes flipped")
        require(scale_rel <= SCALE_REL_TOL, f"gelu->int8 N={N}: scale rel err {scale_rel}")
        del q, s, q_ref, s_ref, code_diff
        kernel = time_ms(lambda: gelu_quant.fused_gelu_quant(y))
        plain = time_ms(lambda: gelu_quant.gelu_quant_reference(y), iters=5)
        b_ms, b_by = bound_ms(M * N * 2 + M * N + M * 4, 10.0 * M * N, F32_FLOPS)
        print(f"  gelu->int8 timed at M={M} N={N}: kernel {kernel:.4f} ms, plain "
              f"{plain:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
        cases.append({"shape": f"M={M} N={N} bf16", "max_abs_err": deq_err,
                      "max_code_diff": max_diff,
                      "code_flip_share": flips, "ms": kernel, "plain_ms": plain,
                      "bound_ms": b_ms, "bound_by": b_by})
        del y
        torch.cuda.empty_cache()
    row, wide = cases
    return {"name": "gelu_quant", "route": "cuda",
            "source": "oneprot_tpu_torch/kernels/csrc/gelu_quant.cu",
            "replaces": "oneprot_tpu/kernels/gelu_quant.py:60",
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "max_code_diff": max(c["max_code_diff"] for c in cases),
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None, "shape": row["shape"],
            "cases": [wide]}


def check_tied_row(gen) -> dict:
    """The tied-row kernel against its plain version at embed_msas's shape
    (B=4 R=16 L=1024 H=12) and at the MSA data config's depth (R=50), at
    the buckets 1024 and 512, off the tile grid (L=300, 3 heads, the last
    17 columns masked) and on a batch padded as embed_msas pads one (four
    MSAs of 1000, 302, 517 and 190 columns in the bucket 1024: the kernel
    skips the key tiles of padding). All but L=300 are timed beside
    scaled_dot_product_attention over the same function (heads of R*64 in
    [B, H, L, R*64], with the scale and the column mask) and the bound (on
    the padded batch, over the keys that carry weight). The first case is
    the row, the others its cases."""
    worst_rel, worst_abs, cases = 0.0, 0.0, []
    padded = (1000, 302, 517, 190)
    for B, R, L, nh, valid in ((4, MSA_DEPTH, 1024, 12, None), (4, 50, 1024, 12, None),
                               (4, MSA_DEPTH, 512, 12, None), (4, 50, 512, 12, None),
                               (4, MSA_DEPTH, 300, 3, (283,) * 4),
                               (4, MSA_DEPTH, 1024, 12, padded)):
        q, k, v = (torch.randn(B, R, L, nh * 64, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(3))
        lens = valid or (L,) * B
        bias = torch.zeros(B, 1, 1, L, device="cuda")
        for b, n in enumerate(lens):
            bias[b, ..., n:] = -1e9
        out = tra.tied_row_attention_cuda(q, k, v, nh, col_bias=bias)
        ref = tra.tied_row_attention_plain(q, k, v, nh, col_bias=bias)
        torch.cuda.synchronize()
        require(torch.isfinite(out.float()).all().item(),
                f"tied-row R={R} L={L}: non-finite")
        diff = (out.float() - ref.float()).abs().max().item()
        rel = diff / max(ref.float().abs().max().item(), 1e-6)
        shape = (f"B={B} R={R} L={L} H={nh} D=64 bf16"
                 + (f", columns {'/'.join(map(str, lens))}" if valid else ""))
        print(f"  tied-row {shape}: max rel err {rel:.3e}, max abs err {diff:.3e}",
              flush=True)
        require(rel <= FLASH_REL_TOL,
                f"tied-row {shape}: rel err {rel} > {FLASH_REL_TOL}")
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, diff)
        del out, ref
        if L == 300:
            continue
        scale = tra.tied_scale(64, R)
        kernel = time_ms(lambda: tra.tied_row_attention_cuda(q, k, v, nh,
                                                             col_bias=bias))
        plain = time_ms(lambda: tra.tied_row_attention_plain(
            q, k, v, nh, col_bias=bias), iters=3)
        tied = lambda x: x.view(B, R, L, nh, 64).permute(0, 3, 2, 1, 4).reshape(
            B, nh, L, R * 64)
        qt, kt, vt, mask = tied(q), tied(k), tied(v), bias.to(torch.bfloat16)
        library = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=scale))
        del qt, kt, vt
        # the keys that carry weight: every query column reads them
        keys = sum(lens)
        row_bytes = R * nh * 64 * 2
        b_ms, b_by = bound_ms(2 * B * L * row_bytes + 2 * keys * row_bytes + B * L * 4,
                              4.0 * nh * L * keys * R * 64, BF16_FLOPS)
        tiles = sum(-(-n // 128) for n in lens) / (B * -(-L // 128))
        print(f"  tied-row timed at {shape}: kernel {kernel:.4f} ms, plain "
              f"{plain:.4f} ms, SDPA {library:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}), key tiles visited {tiles:.1%}", flush=True)
        cases.append({"shape": shape, "ms": kernel, "plain_ms": plain,
                      "library_ms": library, "bound_ms": b_ms, "bound_by": b_by,
                      "key_tiles_visited": tiles})
        del q, k, v
        torch.cuda.empty_cache()
    row = cases[0]
    return {"name": "tied_row_attention", "route": "cuda",
            "source": "oneprot_tpu_torch/kernels/csrc/tied_row_attention.cu",
            "replaces": "oneprot_tpu/kernels/tied_row_attention.py:56",
            "max_abs_err": worst_abs, "max_rel_err": worst_rel, "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "cases": cases[1:],
            "note": "library_ms: scaled_dot_product_attention on [B, H, L, "
                    "R*64] (heads of R*64), scale and column mask"}


def fa_inputs(B, H, L, D, gen):
    """q, k, v [B, H, L, D] bf16 as the ESM2 layer hands them over (heads
    viewed out of [B, L, H*D] projections), a key-padding bias [B, 1, 1, L]
    (each row keeps a random prefix of at least L/2 keys) and the valid
    positions [B, L]."""
    q, k, v = (torch.randn(B, L, H * D, device="cuda", generator=gen)
               .to(torch.bfloat16).view(B, L, H, D).transpose(1, 2)
               for _ in range(3))
    lens = torch.randint(L // 2, L + 1, (B,), device="cuda", generator=gen)
    valid = torch.arange(L, device="cuda")[None, :] < lens[:, None]
    return q, k, v, ((1.0 - valid.float()) * -1e9)[:, None, None, :], valid


def check_flash_attention(gen) -> dict:
    """The FlashAttention-2 forward against flash_attention_plain: at the
    ESM2-15B width's serving shape (a batch of 32 at bucket 1024, 40 heads
    of 128), at heads of 64 and 256, at a ragged L = 300, and on heads of 24
    through dot_product_attention's padding (the 35M tower's width), each
    with a key-padding bias. The first three are timed beside
    scaled_dot_product_attention on the same inputs and the bound."""
    worst_rel, worst_abs, worst_lse = 0.0, 0.0, 0.0
    timed = []
    cases = [(32, 40, 1024, 128, True), (8, 16, 1024, 64, True),
             (8, 16, 1024, 256, True), (4, 40, 300, 128, False),
             (16, 20, 1024, 24, False)]
    for B, H, L, D, time_it in cases:
        q, k, v, bias, valid = fa_inputs(B, H, L, D, gen)
        if D < fa.MIN_HEAD_DIM:  # padded to 64 on the way into the kernel
            out, lse = fa.dot_product_attention(q, k, v, bias), None
        else:
            out, lse = fa.flash_attention_fwd_cuda(q, k, v, bias)
        ref, ref_lse_full = fa.flash_attention_plain(q, k, v, bias)
        torch.cuda.synchronize()
        require(torch.isfinite(out.float()).all().item(),
                f"flash-attention D={D} L={L}: non-finite")
        diff = (out.float() - ref.float()).abs().max().item()
        rel = diff / max(ref.float().abs().max().item(), 1e-6)
        line = (f"  flash-attention B={B} H={H} L={L} D={D}"
                f"{' (padded to 64 by dot_product_attention)' if lse is None else ''}"
                f": max rel err {rel:.3e}, max abs err {diff:.3e}")
        require(rel <= FLASH_REL_TOL,
                f"flash-attention D={D} L={L}: rel err {rel} > {FLASH_REL_TOL}")
        if lse is not None:
            rows = valid[:, None, :].expand_as(lse)
            lse_err = (lse - ref_lse_full).abs()[rows].max().item()
            line += f", lse max abs err {lse_err:.3e} (real rows)"
            require(lse_err <= 5e-2, f"flash-attention D={D} L={L}: lse err "
                    f"{lse_err}")
            worst_lse = max(worst_lse, lse_err)
        print(line, flush=True)
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, diff)
        del out, ref, ref_lse_full, lse
        if time_it:
            kernel = time_ms(lambda: fa.flash_attention_fwd_cuda(q, k, v, bias))
            plain = time_ms(lambda: fa.flash_attention_plain(q, k, v, bias),
                            iters=3)
            mask = bias.to(torch.bfloat16)
            library = time_ms(lambda: torch.nn.functional.
                              scaled_dot_product_attention(q, k, v,
                                                           attn_mask=mask))
            # q, k, v read and out written in bf16, the bias and lse in f32
            nbytes = 4 * B * H * L * D * 2 + B * L * 4 + B * H * L * 4
            b_ms, b_by = bound_ms(nbytes, 4.0 * B * H * L * L * D, BF16_FLOPS)
            print(f"  flash-attention timed at B={B} H={H} L={L} D={D}: kernel "
                  f"{kernel:.4f} ms, plain {plain:.4f} ms, SDPA {library:.4f} "
                  f"ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
            timed.append({"shape": f"B={B} H={H} L={L} D={D} bf16",
                          "ms": kernel, "plain_ms": plain,
                          "library_ms": library, "bound_ms": b_ms,
                          "bound_by": b_by})
        del q, k, v, bias
        torch.cuda.empty_cache()
    main = timed[0]
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "oneprot_tpu_torch/kernels/csrc/flash_attention_fwd.cu",
            "replaces": "oneprot_tpu/kernels/flash_attention.py:79",
            "max_abs_err": worst_abs, "max_rel_err": worst_rel,
            "lse_max_abs_err": worst_lse, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": main["shape"], "timed": timed,
            "note": "library_ms: scaled_dot_product_attention with the "
                    "[B, 1, 1, L] bias as a bf16 mask"}


def check_flash_attention_bwd(gen) -> list:
    """The FlashAttention-2 dq kernel (#6, its prologue included: q_s and
    delta) and dk/dv kernel (#7, on #6's q_s and delta) against
    flash_attention_bwd_plain on the same q, k, v, out, lse and upstream
    gradient (zero on padding rows, as the pooled loss gives it), q, k, v
    and the gradient as views of [B, L, H*D] tensors, and #6's q_s and delta
    against flash_attention_bwd_dq_plain's: at the LoRA-15B step's largest
    shape (a batch of 16 at bucket 1024, 40 heads of 128), at heads of 64
    and 256 and at a ragged L = 300, each with a key-padding bias. Timed at
    the first: each kernel beside its own plain version and the bound, and
    the whole card backward (flash_attention_bwd_cuda: #6, then #7) beside
    scaled_dot_product_attention's backward (forward + backward minus
    forward) and the bound of the backward's five products."""
    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0, "delta": 0.0}
    worst_abs = dict(worst)
    cases = [(LORA_BATCH, 40, 1024, 128), (8, 16, 1024, 64),
             (8, 16, 1024, 256), (4, 40, 300, 128)]
    for B, H, L, D in cases:
        q, k, v, bias, valid = fa_inputs(B, H, L, D, gen)
        dout = (torch.randn(B, L, H, D, device="cuda", generator=gen)
                * valid[:, :, None, None]).to(torch.bfloat16).transpose(1, 2)
        out, lse = fa.flash_attention_fwd_cuda(q, k, v, bias)
        dq, qs, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, bias, out, lse,
                                                       dout)
        dk, dv = fa.flash_attention_bwd_dkv_cuda(qs, k, v, bias, dout, lse,
                                                 delta)
        ref = fa.flash_attention_bwd_plain(q, k, v, bias, out, lse, dout)
        _, ref_qs, ref_delta = fa.flash_attention_bwd_dq_plain(
            q, k, v, bias, out, lse, dout)
        torch.cuda.synchronize()
        require(torch.equal(qs, ref_qs), f"flash-attention bwd q_s D={D} "
                f"L={L}: not q * bf16(1/sqrt(D))")
        diff = (delta - ref_delta).abs().max().item()
        rel = diff / max(ref_delta.abs().max().item(), 1e-6)
        require(rel <= FLASH_REL_TOL, f"flash-attention bwd delta D={D} "
                f"L={L}: rel err {rel} > {FLASH_REL_TOL}")
        worst["delta"] = max(worst["delta"], rel)
        worst_abs["delta"] = max(worst_abs["delta"], diff)
        errs = [f"delta {rel:.3e}"]
        for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
            require(torch.isfinite(got.float()).all().item(),
                    f"flash-attention bwd {name} D={D} L={L}: non-finite")
            diff = (got.float() - want.float()).abs().max().item()
            rel = diff / max(want.float().abs().max().item(), 1e-6)
            require(rel <= FLASH_REL_TOL, f"flash-attention bwd {name} D={D} "
                    f"L={L}: rel err {rel} > {FLASH_REL_TOL}")
            worst[name] = max(worst[name], rel)
            worst_abs[name] = max(worst_abs[name], diff)
            errs.append(f"{name} {rel:.3e}")
        print(f"  flash-attention backward B={B} H={H} L={L} D={D}: max rel err "
              + ", ".join(errs), flush=True)
        del dq, dk, dv, ref, ref_qs, ref_delta
        if (B, H, L, D) == cases[0]:
            timed = (q, k, v, bias, dout, out, lse, qs, delta)
        del q, k, v, bias, dout, out, lse, qs, delta
        torch.cuda.empty_cache()

    q, k, v, bias, dout, out, lse, qs, delta = timed
    B, H, L, D = cases[0]
    dq_ms = time_ms(lambda: fa.flash_attention_bwd_dq_cuda(
        q, k, v, bias, out, lse, dout))
    dkv_ms = time_ms(lambda: fa.flash_attention_bwd_dkv_cuda(
        qs, k, v, bias, dout, lse, delta))
    whole_ms = time_ms(lambda: fa.flash_attention_bwd_cuda(
        q, k, v, bias, out, lse, dout))
    plain_dq = time_ms(lambda: fa.flash_attention_bwd_dq_plain(
        q, k, v, bias, out, lse, dout), iters=3)
    plain_dkv = time_ms(lambda: fa.flash_attention_bwd_dkv_plain(
        qs, k, v, bias, dout, lse, delta), iters=3)
    leaves = [x.detach().contiguous().requires_grad_() for x in (q, k, v)]
    mask, do_c = bias.to(torch.bfloat16), dout.contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd = time_ms(lambda: sdpa(*leaves, attn_mask=mask))
    fwd_bwd = time_ms(lambda: torch.autograd.grad(
        sdpa(*leaves, attn_mask=mask), leaves, do_c))
    library = fwd_bwd - fwd
    per_pair = B * H * L * L * D  # one [L, L] x D product, per head
    qkvo = B * H * L * D * 2      # one bf16 [B, H, L, D] tensor, in bytes
    row = B * H * L * 4           # one f32 [B, H, L] tensor (lse, delta)
    bias_bytes = B * L * 4
    # #6 reads q, k, v, out, dout, lse, bias and writes dq, q_s, delta; #7
    # reads q_s, k, v, dout, lse, delta, bias and writes dk, dv; the whole
    # backward reads what #6 reads and writes dq, dk, dv, and its least work
    # is five products (q k^T, dO v^T, dS k, dS^T q, p^T dO)
    whole_bound, whole_by = bound_ms(8 * qkvo + row + bias_bytes,
                                     10.0 * per_pair, BF16_FLOPS)
    rows = []
    for name, ms, plain, gemms, nbytes, line in (
            ("flash_attention_bwd_dq", dq_ms, plain_dq, 3,
             7 * qkvo + 2 * row + bias_bytes, 163),
            ("flash_attention_bwd_dkv", dkv_ms, plain_dkv, 4,
             6 * qkvo + 2 * row + bias_bytes, 192)):
        b_ms, b_by = bound_ms(nbytes, 2.0 * gemms * per_pair, BF16_FLOPS)
        grads = ("dq", "delta") if gemms == 3 else ("dk", "dv")
        print(f"  {name} timed at B={B} H={H} L={L} D={D}: kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"oneprot_tpu_torch/kernels/csrc/{name}.cu",
            "replaces": f"oneprot_tpu/kernels/flash_attention.py:{line}",
            "max_abs_err": max(worst_abs[g] for g in grads),
            "max_rel_err": {g: worst[g] for g in grads},
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library, "shape": f"B={B} H={H} L={L} D={D} bf16",
            "whole_backward_ms": whole_ms, "whole_backward_bound_ms": whole_bound,
            "note": "plain_ms: this kernel's plain version (flash_attention_"
                    "bwd_dq_plain with the prologue, or flash_attention_bwd_"
                    "dkv_plain); library_ms: scaled_dot_product_attention "
                    "forward+backward minus its forward with the [B, 1, 1, "
                    "L] bias as a bf16 mask, one figure for the whole "
                    "backward; whole_backward_ms: flash_attention_bwd_cuda "
                    "(#6 with its prologue, then #7)"})
    print(f"  flash-attention backward: whole card backward {whole_ms:.4f} ms "
          f"(#6 + #7, prologue in #6; bound {whole_bound:.4f} ms, {whole_by}) "
          f"against SDPA backward {library:.4f} ms (fwd+bwd {fwd_bwd:.4f} - fwd "
          f"{fwd:.4f}): {whole_ms / library:.3f}x", flush=True)
    return rows


def check_flash_packed(out, lse, q, k, v, H, side, valid, fwd_row, what):
    """The forward kernel's out and lse at a training shape against
    mha_attention_plain on the same inputs; folds the errors into the
    forward kernel's row."""
    ref, ref_lse = flash_mha.mha_attention_plain(q, k, v, H, **side)
    torch.cuda.synchronize()
    require(torch.isfinite(out.float()).all().item(), f"flash {what}: non-finite")
    diff = (out.float() - ref.float()).abs().max().item()
    rel = diff / max(ref.float().abs().max().item(), 1e-6)
    lse_err = (lse - ref_lse).abs()[valid[:, None, :].expand_as(lse)].max().item()
    print(f"  flash-MHA {what}: max rel err {rel:.3e}, max abs err {diff:.3e}, "
          f"lse max abs err {lse_err:.3e} (real rows)", flush=True)
    require(rel <= FLASH_REL_TOL, f"flash {what}: rel err {rel} > {FLASH_REL_TOL}")
    require(lse_err <= 5e-2, f"flash {what}: lse err {lse_err}")
    fwd_row["max_rel_err"] = max(fwd_row["max_rel_err"], rel)
    fwd_row["max_abs_err"] = max(fwd_row["max_abs_err"], diff)
    fwd_row["lse_max_abs_err"] = max(fwd_row["lse_max_abs_err"], lse_err)


def packed_struct_segments(seed: int = PACKED_SEG_SEED):
    """Struct-token segment ids [ROWS, ROW_LEN] (-1 on padding) of a packed
    batch as `make_packed_batch` draws it, from its own numpy seed."""
    return make_packed_batch(np.random.RandomState(seed))["mod"]["segment_ids"]


def sdpa_backward_ms(q, k, v, cos, sin, mask, dout, H):
    """scaled_dot_product_attention's backward (forward + backward minus
    forward) on pre-rotated [B, H, L, D] inputs with a dense bf16 mask:
    (backward ms, forward + backward ms, forward ms)."""
    B, L, hd = q.shape
    D = hd // H
    heads = lambda x: x.view(B, L, H, D).transpose(1, 2)
    qr = flash_mha.apply_rotary(heads(q).float(), cos, sin).to(torch.bfloat16)
    kr = flash_mha.apply_rotary(heads(k).float(), cos, sin).to(torch.bfloat16)
    leaves = [x.detach().contiguous().requires_grad_() for x in (qr, kr, heads(v))]
    do_h = heads(dout).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd = time_ms(lambda: sdpa(*leaves, attn_mask=mask))
    fwd_bwd = time_ms(lambda: torch.autograd.grad(
        sdpa(*leaves, attn_mask=mask), leaves, do_h))
    return fwd_bwd - fwd, fwd_bwd, fwd


def needed_pairs(seg, B: int, L: int) -> int:
    """(query, key) pairs of one head that the backward must compute: the
    pairs of equal segment ids (same protein, or padding with padding), or
    all L^2 without segment ids."""
    if seg is None:
        return B * L * L
    s = seg.long()
    return int(sum((row[:, None] == row[None, :]).sum().item() for row in s))


def check_flash_bwd(gen, fwd_row: dict) -> list:
    """The dq kernel (#2, its prologue included: q_r and delta) and the
    dk/dv kernel (#3, on #2's q_r and delta) against the plain backward on
    the same q, k, v, out, lse and upstream gradient (zero on padding rows,
    as a loss over pooled segments gives it), and each against its own
    plain version (flash_mha_bwd_dq_plain: q_r equal, delta;
    flash_mha_bwd_dkv_plain on the kernel's q_r and delta): at the 35M
    tower's packed shape (16 rows of 1024, 20 heads of 24, rotary, padding
    bias, 16 proteins a row), at the hub's packed shape (heads of 64), at
    L=512 with 4 proteins a row, at the tower's unpacked shape in the LoRA
    step (16 rows of 1024, key padding bias, no segment ids), and on the
    struct-token segment ids of a real packed batch (`make_packed_batch`).
    The forward kernel's out and lse at each of these shapes are first held
    against the plain forward (`check_flash_packed`). Each case is timed:
    #2, #3 and the whole card backward (`flash_mha_bwd_cuda`) beside SDPA's
    backward, with the share of 64 x 64 tiles the kernels visit and the
    bound over the logit pairs these inputs need (same segment, or padding
    with padding) beside the dense one, and the exp2 floor at the card's
    special-function rate. The kernels' row carries the first case."""
    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0, "delta": 0.0}
    worst_abs = dict(worst)
    H = 20
    cases = [(ROWS, ROW_LEN, 24, SLOTS), (ROWS, ROW_LEN, 64, SLOTS),
             (16, 512, 64, 4), (LORA_BATCH, ROW_LEN, 24, 0),
             (ROWS, ROW_LEN, 24, "real")]
    timings = []
    for B, L, D, n_seg in cases:
        q, k, v, bias, cos, sin, seg, valid = attention_inputs(
            B, L, H, D, gen, segments=n_seg not in (0, "real"),
            n_seg=n_seg if isinstance(n_seg, int) else 0)
        if n_seg == "real":  # padding and segments of the real packing
            seg = torch.from_numpy(packed_struct_segments()).cuda()
            valid = seg >= 0
            bias = ((1.0 - valid.float()) * -1e9)[:, None, None, :]
            layout = "real packed batch"
        else:
            layout = f"{n_seg} segments a row" if n_seg else "unpacked"
        side = dict(bias=bias, rope_cos=cos, rope_sin=sin, segment_ids=seg)
        dout = (torch.randn(B, L, H * D, device="cuda", generator=gen)
                * valid[..., None]).to(torch.bfloat16)
        out, lse = flash_mha.flash_mha_cuda(q, k, v, H, **side)
        what = f"B={B} L={L} H={H} D={D} {layout}"
        check_flash_packed(out, lse, q, k, v, H, side, valid, fwd_row, what)
        fwd_row["cases"].append(time_flash_fwd(what, q, k, v, H, side))
        dq, q_r, delta = flash_mha.flash_mha_bwd_dq_cuda(q, k, v, out, lse, dout,
                                                        H, **side)
        dk, dv = flash_mha.flash_mha_bwd_dkv_cuda(q_r, k, v, dout, lse, delta, H,
                                                  **side)
        ref = flash_mha.mha_attention_bwd_plain(q, k, v, out, lse, dout, H, **side)
        own_dq, own_qr, own_delta = flash_mha.flash_mha_bwd_dq_plain(
            q, k, v, out, lse, dout, H, **side)
        own_dkv = flash_mha.flash_mha_bwd_dkv_plain(q_r, k, v, dout, lse, delta,
                                                    H, **side)
        torch.cuda.synchronize()
        require(torch.equal(q_r, own_qr), f"flash bwd q_r {what}: not "
                "bf16(rot(q) * q_pre)")
        diff = (delta - own_delta).abs().max().item()
        rel = diff / max(own_delta.abs().max().item(), 1e-6)
        require(rel <= FLASH_REL_TOL, f"flash bwd delta {what}: rel err {rel}")
        worst["delta"], worst_abs["delta"] = (max(worst["delta"], rel),
                                              max(worst_abs["delta"], diff))
        errs = [f"delta {rel:.3e}"]
        for name, got, want, own in zip(("dq", "dk", "dv"), (dq, dk, dv), ref,
                                        (own_dq, *own_dkv)):
            require(torch.isfinite(got.float()).all().item(),
                    f"flash bwd {name} {what}: non-finite")
            for r in (want, own):
                diff = (got.float() - r.float()).abs().max().item()
                rel = diff / max(r.float().abs().max().item(), 1e-6)
                require(rel <= FLASH_REL_TOL,
                        f"flash bwd {name} {what}: rel err {rel} > {FLASH_REL_TOL}")
                worst[name] = max(worst[name], rel)
                worst_abs[name] = max(worst_abs[name], diff)
            errs.append(f"{name} {rel:.3e}")
        print(f"  flash-MHA backward {what}: max rel err " + ", ".join(errs),
              flush=True)
        del ref, own_dq, own_qr, own_delta, own_dkv, dq, dk, dv
        timings.append(time_flash_bwd(what, q, k, v, out, lse, dout, H, side,
                                      q_r, delta))
        del q, k, v, out, lse, dout, q_r, delta, side
        torch.cuda.empty_cache()

    t = timings[0]
    rows = []
    for name, ms, gemms, line in (
            ("flash_mha_bwd_dq", t["dq_ms"], 3, 512),
            ("flash_mha_bwd_dkv", t["dkv_ms"], 4, 619)):
        grads = ("dq", "delta") if gemms == 3 else ("dk", "dv")
        part = name.split("_")[-1]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"oneprot_tpu_torch/kernels/csrc/{name}.cu",
            "replaces": f"oneprot_tpu/kernels/flash_mha.py:{line}",
            "max_abs_err": max(worst_abs[g] for g in grads),
            "max_rel_err": {g: worst[g] for g in grads},
            "ms": ms, "plain_ms": t[f"{part}_plain_ms"],
            "bound_ms": t[f"{part}_bound_ms"], "bound_by": t[f"{part}_bound_by"],
            "dense_bound_ms": t[f"{part}_dense_bound_ms"],
            "exp2_floor_ms": t["exp2_floor_ms"],
            "library_ms": t["sdpa_backward_ms"],
            "shape": f"B={ROWS} L={ROW_LEN} H={H} D=24 bf16, {SLOTS} segments a row",
            "cases": timings,
            "note": "bound_ms: operations over the logit pairs these inputs "
                    "need (equal segment ids), dense_bound_ms over all L^2; "
                    "plain_ms: this kernel's own plain version; library_ms: "
                    "scaled_dot_product_attention forward+backward minus "
                    "its forward with the dense mask, one figure for both "
                    "passes; cases: every timed case, the whole card "
                    "backward (flash_mha_bwd_cuda) beside SDPA's"})
    return rows


def time_flash_fwd(what, q, k, v, H, side) -> dict:
    """#1 and SDPA's forward on one case (pre-rotated heads, the bias or
    the dense segment mask as a bf16 mask), with the share of the kernel's
    query-block x key-tile pairs it visits and the needed-work and dense
    bounds; prints one line and returns the numbers."""
    B, L, hd = q.shape
    D = hd // H
    seg = side["segment_ids"]
    ms = time_ms(lambda: flash_mha.flash_mha_cuda(q, k, v, H, **side))
    mask = side["bias"]
    if seg is not None:
        mask = flash_mha.packed_segment_bias(seg, mask, mask_value=-1e30)
    heads = lambda x: x.view(B, L, H, D).transpose(1, 2)
    qr = flash_mha.apply_rotary(heads(q).float(), side["rope_cos"],
                                side["rope_sin"]).to(torch.bfloat16)
    kr = flash_mha.apply_rotary(heads(k).float(), side["rope_cos"],
                                side["rope_sin"]).to(torch.bfloat16)
    vh, m16 = heads(v).contiguous(), mask.to(torch.bfloat16)
    sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qr, kr, vh, attn_mask=m16))
    del qr, kr, vh, m16
    tiles = (1.0 if seg is None else flash_mha.segment_tile_hits(
        seg, flash_mha.fwd_key_tile(D), flash_mha.FWD_Q_TILE).float().mean().item())
    pairs = needed_pairs(seg, B, L) * H
    dense = B * L * L * H
    # q, k, v read and out written in bf16; lse out, bias and ids in f32 /
    # int32, both rotary tables in bf16
    nbytes = (4 * B * L * H * D * 2 + B * H * L * 4
              + B * L * 4 * (2 if seg is not None else 1) + 2 * L * D * 2)
    b_ms, b_by = bound_ms(nbytes, 4.0 * pairs * D, BF16_FLOPS)
    dense_ms = bound_ms(nbytes, 4.0 * dense * D, BF16_FLOPS)[0]
    print(f"  flash-MHA forward timed, {what}: #1 {ms:.4f} ms against SDPA "
          f"forward {sdpa:.4f} ms: {ms / sdpa:.3f}x; tiles visited {tiles:.3f}, "
          f"pairs needed {pairs / dense:.3f}; bound (needed / dense) "
          f"{b_ms:.4f} / {dense_ms:.4f} ms ({b_by})", flush=True)
    return {"case": what, "ms": ms, "sdpa_forward_ms": sdpa,
            "tiles_visited": tiles, "pairs_needed": pairs / dense,
            "bound_ms": b_ms, "bound_by": b_by, "dense_bound_ms": dense_ms}


def time_flash_bwd(what, q, k, v, out, lse, dout, H, side, q_r, delta) -> dict:
    """#2, #3, the whole card backward and SDPA's backward on one case, with
    the needed-work and dense bounds, the exp2 floor and the share of tiles
    the kernels visit; prints one line and returns the numbers."""
    B, L, hd = q.shape
    D = hd // H
    seg = side["segment_ids"]
    dq_ms = time_ms(lambda: flash_mha.flash_mha_bwd_dq_cuda(
        q, k, v, out, lse, dout, H, **side))
    dkv_ms = time_ms(lambda: flash_mha.flash_mha_bwd_dkv_cuda(
        q_r, k, v, dout, lse, delta, H, **side))
    whole_ms = time_ms(lambda: flash_mha.flash_mha_bwd_cuda(
        q, k, v, out, lse, dout, H, **side))
    dq_plain = time_ms(lambda: flash_mha.flash_mha_bwd_dq_plain(
        q, k, v, out, lse, dout, H, **side), iters=3)
    dkv_plain = time_ms(lambda: flash_mha.flash_mha_bwd_dkv_plain(
        q_r, k, v, dout, lse, delta, H, **side), iters=3)
    mask = side["bias"]
    if seg is not None:
        mask = flash_mha.packed_segment_bias(seg, mask, mask_value=-1e30)
    sdpa_ms, sdpa_fwd_bwd, sdpa_fwd = sdpa_backward_ms(
        q, k, v, side["rope_cos"], side["rope_sin"], mask.to(torch.bfloat16),
        dout, H)
    pairs = needed_pairs(seg, B, L) * H  # over every head
    dense = B * L * L * H
    tiles = 1.0 if seg is None else flash_mha.segment_tile_hits(seg).float().mean().item()
    qkvo = B * L * H * D * 2  # one bf16 [B, L, H*D] tensor, in bytes
    row = B * H * L * 4       # one f32 [B, H, L] tensor (lse, delta)
    side_bytes = B * L * 4 * (2 if seg is not None else 1) + 2 * L * D * 2
    # #2 reads q, k, v, out, dout, lse and writes dq, q_r, delta; #3 reads
    # q_r, k, v, dout, lse, delta and writes dk, dv; the whole backward
    # reads what #2 reads and writes dq, dk, dv, its least work five
    # products (q k^T, dO v^T, dS k, dS^T q, p^T dO) and one exp2 a pair
    res = {"case": what, "dq_ms": dq_ms, "dkv_ms": dkv_ms, "whole_ms": whole_ms,
           "dq_plain_ms": dq_plain, "dkv_plain_ms": dkv_plain,
           "sdpa_backward_ms": sdpa_ms, "tiles_visited": tiles,
           "pairs_needed": pairs / dense,
           "exp2_floor_ms": pairs / SFU_EXP2_S * 1e3}
    for name, gemms, nbytes in (("dq", 3, 7 * qkvo + 2 * row + side_bytes),
                                ("dkv", 4, 6 * qkvo + 2 * row + side_bytes),
                                ("whole", 5, 8 * qkvo + row + side_bytes)):
        b_ms, b_by = bound_ms(nbytes, 2.0 * gemms * pairs * D, BF16_FLOPS)
        res[f"{name}_bound_ms"], res[f"{name}_bound_by"] = b_ms, b_by
        res[f"{name}_dense_bound_ms"] = bound_ms(
            nbytes, 2.0 * gemms * dense * D, BF16_FLOPS)[0]
    print(f"  flash-MHA backward timed, {what}: #2 {dq_ms:.4f} ms (plain "
          f"{dq_plain:.4f}), #3 {dkv_ms:.4f} ms (plain {dkv_plain:.4f}), whole "
          f"{whole_ms:.4f} ms against SDPA backward {sdpa_ms:.4f} ms (fwd+bwd "
          f"{sdpa_fwd_bwd:.4f} - fwd {sdpa_fwd:.4f}): {whole_ms / sdpa_ms:.3f}x; "
          f"tiles visited {tiles:.3f}, pairs needed {pairs / dense:.3f}; bounds "
          f"(needed / dense) #2 {res['dq_bound_ms']:.4f} / "
          f"{res['dq_dense_bound_ms']:.4f} ms ({res['dq_bound_by']}), #3 "
          f"{res['dkv_bound_ms']:.4f} / {res['dkv_dense_bound_ms']:.4f} ms "
          f"({res['dkv_bound_by']}), whole {res['whole_bound_ms']:.4f} / "
          f"{res['whole_dense_bound_ms']:.4f} ms ({res['whole_bound_by']}); "
          f"exp2 floor {res['exp2_floor_ms']:.4f} ms a kernel", flush=True)
    return res


def make_packed_batch(rng):
    """ROWS rows of ROW_LEN tokens, SLOTS slots a row, as bench.py packs
    them: log-normal lengths around 290 residues clipped to [30, 1024],
    proteins added while they fit (a protein that does not is skipped; 20
    misses in a row end the batch). Hub tokens 4..23 and struct tokens
    20..52 between <cls> and <eos>, the same proteins in the same slots."""
    lengths, misses = [], 0
    while misses < 20:
        n = int(np.clip(rng.lognormal(np.log(290.0), 0.65), 30, ROW_LEN))
        if len(packing.pack_lengths(lengths + [n], ROW_LEN, SLOTS)) > ROWS:
            misses += 1
            continue
        lengths.append(n)
        misses = 0
    seq_tok, st_tok = [], []
    for n in lengths:
        t = rng.randint(4, 24, size=n).astype(np.int32)
        t2 = rng.randint(20, 53, size=n).astype(np.int32)
        t[0] = t2[0] = 0
        t[-1] = t2[-1] = 2
        seq_tok.append(t)
        st_tok.append(t2)
    ids, seg, valid, rows = packing.pack_token_rows(seq_tok, ROW_LEN, SLOTS)
    st_ids = np.full_like(ids, 1)
    st_seg = np.full_like(seg, -1)
    for r, members in enumerate(rows):
        off = 0
        for slot, idx in enumerate(members):
            n = len(st_tok[idx])
            st_ids[r, off:off + n] = st_tok[idx]
            st_seg[r, off:off + n] = slot
            off += n
    require(ids.shape == (ROWS, ROW_LEN), f"packed batch {ids.shape}")
    return {"seq": {"ids": ids, "segment_ids": seg},
            "mod": {"ids": st_ids, "segment_ids": st_seg}, "valid": valid}


def build_module(hub: SequenceEncoder, tower: StructTokenEncoder) -> OneProtModule:
    """bench.py's module: CLIP + L1 regularizer, Adam after global norm
    clipping at 1.0 (at SMOKE_LR)."""
    return OneProtModule({"sequence": hub, "struct_token": tower},
                         optimizer=adam(SMOKE_LR), loss_fn="CLIP",
                         use_l1_regularization=True).init()


def run_steps(module: OneProtModule, batch: dict, seq_pooled=None):
    """STEPS train steps on one batch (packed, or cached with the hub's
    pooled features); returns (losses, seconds per step)."""
    losses, secs = [], []
    for _ in range(STEPS):
        t = time.time()
        if seq_pooled is None:
            loss, _ = module.train_step_packed("struct_token", batch["seq"],
                                               batch["mod"], batch["valid"])
        else:
            loss, _ = module.train_step_packed_cached(
                "struct_token", seq_pooled, batch["mod"], batch["valid"])
        losses.append(loss.item())  # waits for the step
        secs.append(time.time() - t)
    require(bool(np.isfinite(losses).all()), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    return losses, secs


def training(hub: SequenceEncoder, rng, launches: dict):
    """The packed and the cached step at full width; fills `launches`.
    Returns (numbers, (the hub's and the tower's first 2 layers as they were
    before the first step, the tower's config), the batch)."""
    tower = create_struct_token_encoder()
    esm2.init_esm2_weights_(tower, torch.Generator(device="cuda").manual_seed(1))
    module = build_module(hub, tower)
    initial = (first_layers(hub.state_dict(), 2),
               first_layers(tower.state_dict(), 2), tower.config)
    batch = make_packed_batch(rng)
    pairs = int(batch["valid"].sum())
    fill = float((batch["seq"]["segment_ids"] >= 0).mean())
    print(f"  packed batch: {ROWS} rows x {ROW_LEN} tokens, {pairs} proteins, "
          f"{100 * fill:.1f}% of tokens real", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    result = {"pairs_per_step": pairs, "token_fill": fill}
    tower_bwd = {**{name: 0 for name in LAUNCHERS},
                 "flash_mha_bwd_dq": TOWER_LAYERS,
                 "flash_mha_bwd_dkv": TOWER_LAYERS}
    per_step = {"packed step": {**tower_bwd,
                                "flash_mha_fwd": N_LAYERS + TOWER_LAYERS},
                "cached step": {**tower_bwd, "flash_mha_fwd": TOWER_LAYERS}}
    seq_pooled = None
    for path in ("packed step", "cached step"):
        if path == "cached step":
            seq_pooled = module.encode_packed_pooled(
                "sequence", batch["seq"]["ids"], batch["seq"]["segment_ids"],
                SLOTS)
            torch.cuda.synchronize()
        reset_launches()
        losses, secs = run_steps(module, batch, seq_pooled)
        launches[path] = read_launches()
        want = {k: STEPS * n for k, n in per_step[path].items()}
        require(launches[path] == want,
                f"{path} launches {launches[path]}, want {want}")
        require(not any(PLAIN_CALLS.values()),
                f"{path}: plain versions ran on the card: {PLAIN_CALLS}")
        med = float(np.median(secs))
        print(f"  {path}: losses " + ", ".join(f"{x:.4f}" for x in losses)
              + f"; step ms " + ", ".join(f"{x * 1e3:.1f}" for x in secs)
              + f"; median {med * 1e3:.1f} ms = {pairs / med:.1f} pairs/s; "
              f"launches {launches[path]}", flush=True)
        key = path.split()[0]
        result[key] = {"losses": losses, "step_ms": [x * 1e3 for x in secs],
                       "median_step_ms": med * 1e3, "pairs_per_s": pairs / med}
    result["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"  peak device memory over both paths: {result['peak_gib']:.2f} GiB",
          flush=True)
    return result, initial, batch


def first_layers(state: dict, n: int) -> dict:
    """A transformer state cut to its first n layers, on the CPU."""
    return {k: v.detach().cpu().clone() for k, v in state.items()
            if ".layers." not in k or int(k.split(".layers.")[1].split(".")[0]) < n}


def flat(tensors) -> torch.Tensor:
    """One f64 vector on the CPU: cosines over ~4e7 elements need more than
    f32 sums."""
    return torch.cat([t.detach().cpu().double().reshape(-1) for t in tensors])


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.nn.functional.cosine_similarity(a, b, dim=0))


def training_parity(hub_state: dict, tower_state: dict, hub_cfg, tower_cfg,
                    batch: dict) -> dict:
    """One packed step at 2 hub + 2 tower layers from the same weights and
    PARITY_ROWS rows of the batch: card (bf16, kernels) vs CPU (f32, plain
    versions); then cached == uncached on the card."""
    small = {"seq": {k: v[:PARITY_ROWS] for k, v in batch["seq"].items()},
             "mod": {k: v[:PARITY_ROWS] for k, v in batch["mod"].items()},
             "valid": batch["valid"][:PARITY_ROWS]}
    cfg_h = dataclasses.replace(hub_cfg, num_layers=2)
    cfg_t = dataclasses.replace(tower_cfg, num_layers=2)
    state = {**{"encoders.sequence." + k: v for k, v in hub_state.items()},
             **{"encoders.struct_token." + k: v for k, v in tower_state.items()}}

    def module_on(device, dtype):
        m = build_module(
            SequenceEncoder(cfg_h, 1024, proj_type="mlp", device=device,
                            dtype=dtype),
            StructTokenEncoder(cfg_t, 1024, device=device, dtype=dtype))
        m.model.load_state_dict(state)
        return m

    def heads_of(m):
        return {name: flat(p for n, p in m.model.named_parameters()
                           if n.startswith(f"encoders.{name}.head."))
                for name in ("sequence", "struct_token")}

    out = {}
    runs = {}
    for device, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        m = module_on(device, dtype)
        before = heads_of(m)
        loss, _ = m.train_step_packed("struct_token", small["seq"], small["mod"],
                                      small["valid"])
        after = heads_of(m)
        runs[device] = {
            "loss": loss.item(),
            "grad": {n: p.grad for n, p in m.model.named_parameters()
                     if p.grad is not None},
            "update": {k: after[k] - before[k] for k in after}}
    card, cpu = runs["cuda"], runs["cpu"]
    require(card["grad"].keys() == cpu["grad"].keys(), "gradient leaves differ")
    out["loss_card"], out["loss_cpu"] = card["loss"], cpu["loss"]
    out["loss_rel_diff"] = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    out["grad_cosine"] = cosine(flat(card["grad"].values()),
                                flat(cpu["grad"].values()))
    leaf_cos = {n: cosine(flat([card["grad"][n]]), flat([cpu["grad"][n]]))
                for n in card["grad"]}
    # the tower's attention projection weights, leaf by leaf: their
    # gradients pass through the dq and dk/dv kernels, and the heads'
    # larger leaves cannot hide them
    qkv = {n: c for n, c in leaf_cos.items()
           if n.startswith("encoders.struct_token.transformer.layers.")
           and n.split(".")[-2] in ("q", "k", "v") and n.endswith(".weight")}
    require(len(qkv) == 2 * 3, f"tower q/k/v gradient leaves: {sorted(qkv)}")
    out["tower_qkv_grad_cosine"] = qkv
    out["min_leaf_grad_cosine"] = min(leaf_cos.values())
    out["head_update_cosine"] = {k: cosine(card["update"][k], cpu["update"][k])
                                 for k in card["update"]}
    print(f"  one packed step, card vs CPU: loss {card['loss']:.6f} vs "
          f"{cpu['loss']:.6f} (rel diff {out['loss_rel_diff']:.2e}, gate "
          f"<= 2e-2); clipped-gradient cosine {out['grad_cosine']:.5f} (gate "
          f">= 0.99); tower q/k/v weight gradient cosine per leaf, least "
          f"{min(qkv.values()):.5f} (gate >= 0.99); least over all "
          f"{len(leaf_cos)} leaves {out['min_leaf_grad_cosine']:.5f} "
          f"(reported); head update cosine {out['head_update_cosine']} (gate "
          f">= 0.95)", flush=True)
    require(out["loss_rel_diff"] <= 2e-2, f"loss parity {out['loss_rel_diff']}")
    require(out["grad_cosine"] >= 0.99, f"gradient parity {out['grad_cosine']}")
    require(min(qkv.values()) >= 0.99, f"tower q/k/v gradient parity {qkv}")
    require(min(out["head_update_cosine"].values()) >= 0.95,
            f"head update parity {out['head_update_cosine']}")

    a, b = module_on("cuda", torch.bfloat16), module_on("cuda", torch.bfloat16)
    p0 = flat(a.opt.params)
    loss_a, _ = a.train_step_packed("struct_token", small["seq"], small["mod"],
                                    small["valid"])
    pooled = b.encode_packed_pooled("sequence", small["seq"]["ids"],
                                    small["seq"]["segment_ids"], SLOTS)
    loss_b, _ = b.train_step_packed_cached("struct_token", pooled, small["mod"],
                                           small["valid"])
    pa, pb = flat(a.opt.params), flat(b.opt.params)
    out["cached_loss_rel_diff"] = abs(loss_a.item() - loss_b.item()) / abs(
        loss_a.item())
    out["cached_update_cosine"] = cosine(pa - p0, pb - p0)
    out["cached_param_max_abs_diff"] = float((pa - pb).abs().max())
    print(f"  cached vs uncached on the card: loss {loss_b.item():.6f} vs "
          f"{loss_a.item():.6f} (rel diff {out['cached_loss_rel_diff']:.2e}, "
          f"gate <= 1e-3); update cosine {out['cached_update_cosine']:.6f} "
          f"(gate >= 0.99), updated parameters max abs diff "
          f"{out['cached_param_max_abs_diff']:.2e}", flush=True)
    require(out["cached_loss_rel_diff"] <= 1e-3,
            f"cached loss {out['cached_loss_rel_diff']}")
    require(out["cached_update_cosine"] >= 0.99,
            f"cached update {out['cached_update_cosine']}")
    return out


def lora_batch(rng, n: int = LORA_BATCH, max_res: int = 1022):
    """n (sequence, 3Di) pairs for the unpacked step: log-normal lengths
    around 290 residues clipped to [30, max_res], hub tokens 4..23 and
    struct tokens 20..52 between <cls> and <eos>, both sides padded to the
    smallest of BUCKETS that fits the longest."""
    lens = np.clip(rng.lognormal(np.log(290.0), 0.65, n), 30, max_res).astype(int)
    L = min(b for b in BUCKETS if b >= lens.max() + 2)
    ids, st_ids = np.full((n, L), 1, np.int32), np.full((n, L), 1, np.int32)
    for i, m in enumerate(lens):
        ids[i, 1:m + 1] = rng.randint(4, 24, size=m)
        st_ids[i, 1:m + 1] = rng.randint(20, 53, size=m)
        ids[i, [0, m + 1]] = st_ids[i, [0, m + 1]] = (0, 2)
    return ids, st_ids


def lora_module(hub_cfg, tower_cfg, device, dtype, lora_dropout,
                remat) -> OneProtModule:
    """The LoRA step's module on `device`: the hub with LoRA on q, k, v
    (frozen weights, mlp head) and the struct-token tower, CLIP + L1,
    clipped Adam at SMOKE_LR."""
    hub = SequenceEncoder(
        hub_cfg, 1024, proj_type="mlp", frozen=True,
        lora=esm2.LoraConfig(LORA["lora_r"], float(LORA["lora_alpha"]),
                             lora_dropout),
        remat=remat, device=device, dtype=dtype)
    tower = StructTokenEncoder(tower_cfg, 1024, device=device, dtype=dtype)
    return build_module(hub, tower)


def lora_step_split(module: OneProtModule, ids, st_ids) -> dict:
    """One more train_step, taken apart and timed by CUDA events: forward
    (both towers and the loss), backward (the remat recompute with it),
    clip + Adam."""
    seq_ids, mod_ids = (module._tensor(x, torch.long) for x in (ids, st_ids))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    ev[0].record()
    module._begin_step()
    seq_feats = module.model(seq_ids, "sequence")
    loss = module._loss_value(module.model(mod_ids, "struct_token"), seq_feats)
    ev[1].record()
    module.opt.zero_grad()
    loss.backward()
    ev[2].record()
    module.opt.step()
    module.step += 1
    ev[3].record()
    torch.cuda.synchronize()
    split = {"forward_ms": ev[0].elapsed_time(ev[1]),
             "backward_ms": ev[1].elapsed_time(ev[2]),
             "clip_adam_ms": ev[2].elapsed_time(ev[3])}
    split["step_ms"] = sum(split.values())
    return split


# groups of the LoRA step's device time, by kernel name (first match wins)
PROFILE_GROUPS = (("#6 FA-2 dq", ("flash_attention_bwd_dq",)),
                  ("#7 FA-2 dk/dv", ("flash_attention_bwd_dkv",)),
                  ("#5 FA-2 forward", ("flash_attention_fwd",)),
                  ("#1-#3 flash-MHA (tower)", ("flash_mha",)),
                  ("GEMMs", ("gemm", "cutlass", "xmma", "nvjet", "cublas",
                             "splitk")),
                  ("LoRA dropout draws", ("distribution", "philox",
                                          "bernoulli")))


def lora_step_profile(module: OneProtModule, ids, st_ids) -> dict:
    """One more train_step under torch.profiler: device time by kernel,
    summed into PROFILE_GROUPS and the rest, the step's wall time and the
    device's busy share of it. Empty groups if the profiler saw no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time()
        module.train_step("struct_token", ids, st_ids)[0].item()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t) * 1e3
    groups = {name: 0.0 for name, _ in PROFILE_GROUPS}
    groups["rest"] = 0.0
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA or evt.self_device_time_total <= 0:
            continue
        ms = evt.self_device_time_total / 1e3
        kernels[evt.key] = kernels.get(evt.key, 0.0) + ms
        low = evt.key.lower()
        group = next((name for name, keys in PROFILE_GROUPS
                      if any(k in low for k in keys)), "rest")
        groups[group] += ms
    device_ms = sum(groups.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms, "groups_ms": groups,
            "top_kernels_ms": [[name[:120], ms] for name, ms in top]}


def train_lora_hub(smi: str, launches: dict):
    """The LoRA-15B unpacked step at full width (random weights from a
    seed); fills `launches`. Returns (numbers, (the hub's and the tower's
    first 2 layers as they were before the first step, their configs))."""
    # the entry points: the committed config dir, LoRA, frozen bf16, remat
    hub = create_sequence_encoder(model_name_or_path=str(WIDE_HUB),
                                  proj_type="mlp", frozen=True, remat=True,
                                  **LORA)
    cfg = hub.config
    require((cfg.num_layers, cfg.hidden_size, cfg.num_heads) == (WIDE_LAYERS,
                                                               5120, 40),
            f"ESM2-15B widths: {cfg}")
    esm2.init_esm2_weights_(hub, torch.Generator(device="cuda").manual_seed(6))
    tower = create_struct_token_encoder()
    esm2.init_esm2_weights_(tower, torch.Generator(device="cuda").manual_seed(7))
    module = build_module(hub, tower)
    initial = (first_layers(hub.state_dict(), 2),
               first_layers(tower.state_dict(), 2), cfg, tower.config)
    n_train = sum(p.numel() for p in module.opt.params)
    n_hub_train = sum(p.numel() for n, p in hub.transformer.named_parameters()
                      if p.requires_grad)
    rng = np.random.RandomState(8)
    batches = [lora_batch(rng) for _ in range(LORA_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, secs = [], []
    for ids, st_ids in batches[:LORA_STEPS]:
        t = time.time()
        loss, _ = module.train_step("struct_token", ids, st_ids)
        losses.append(loss.item())  # waits for the step
        secs.append(time.time() - t)
    launches["LoRA-15B step"] = read_launches()
    per_step = {**{name: 0 for name in LAUNCHERS},
                "flash_attention_fwd": 2 * WIDE_LAYERS,  # forward + recompute
                "flash_attention_bwd_dq": WIDE_LAYERS,
                "flash_attention_bwd_dkv": WIDE_LAYERS,
                "flash_mha_fwd": TOWER_LAYERS, "flash_mha_bwd_dq": TOWER_LAYERS,
                "flash_mha_bwd_dkv": TOWER_LAYERS}
    want = {k: LORA_STEPS * n for k, n in per_step.items()}
    require(launches["LoRA-15B step"] == want,
            f"LoRA-15B launches {launches['LoRA-15B step']}, want {want}")
    require(not any(PLAIN_CALLS.values()),
            f"LoRA-15B: plain versions ran on the card: {PLAIN_CALLS}")
    require(bool(np.isfinite(losses).all()), f"LoRA-15B losses {losses}")
    require(all(torch.isfinite(p).all().item() for p in module.opt.params),
            "LoRA-15B: non-finite parameters after the steps")
    peak = torch.cuda.max_memory_allocated() / 2**30
    split = lora_step_split(module, *batches[-1])
    prof = lora_step_profile(module, *batches[-1])
    lens = [int((ids != 1).sum(1).max()) for ids, _ in batches]
    pairs_s = [LORA_BATCH / x for x in secs]
    print(f"  LoRA-15B: {n_train / 1e6:.2f} M trainable parameters "
          f"({n_hub_train / 1e6:.2f} M in the hub's transformer); buckets "
          + ", ".join(str(ids.shape[1]) for ids, _ in batches)
          + f" (longest rows {lens}); losses "
          + ", ".join(f"{x:.4f}" for x in losses) + "; step ms "
          + ", ".join(f"{x * 1e3:.1f}" for x in secs) + "; pairs/s "
          + ", ".join(f"{x:.2f}" for x in pairs_s)
          + f"; peak device memory {peak:.2f} GiB; launches per step "
          f"{per_step}; {smi}", flush=True)
    print(f"  LoRA-15B step split (CUDA events, bucket {batches[-1][0].shape[1]}):"
          f" forward {split['forward_ms']:.1f} ms, backward with recompute "
          f"{split['backward_ms']:.1f} ms, clip + Adam "
          f"{split['clip_adam_ms']:.1f} ms", flush=True)
    if prof["device_ms"] > 0:
        print(f"  LoRA-15B step profile (torch.profiler, bucket "
              f"{batches[-1][0].shape[1]}): wall {prof['wall_ms']:.1f} ms, "
              f"device {prof['device_ms']:.1f} ms (busy "
              f"{100 * prof['busy_share']:.1f}%): " + ", ".join(
                  f"{name} {ms:.1f} ms ({100 * ms / prof['device_ms']:.1f}%)"
                  for name, ms in prof["groups_ms"].items()), flush=True)
        print("  top kernels: " + "; ".join(
            f"{name} {ms:.1f} ms" for name, ms in prof["top_kernels_ms"]),
            flush=True)
    else:
        print("  LoRA-15B step profile: torch.profiler showed no device time; "
              "the CUDA-event split above stands", flush=True)
    result = {"losses": losses, "step_ms": [x * 1e3 for x in secs],
              "pairs_per_s": pairs_s, "buckets": [ids.shape[1] for ids, _ in
                                                  batches[:LORA_STEPS]],
              "trainable_params": n_train, "hub_trainable_params": n_hub_train,
              "peak_gib": peak, "launches_per_step": per_step,
              "split": split, "profile": prof}
    return result, initial


def lora_parity(hub_state: dict, tower_state: dict, hub_cfg, tower_cfg) -> dict:
    """Two unpacked steps at 2 hub + 2 tower layers from the LoRA step's
    initial weights (B = 0), LoRA dropout 0, on PARITY_ROWS pairs up to 254
    residues: card (bf16, kernels, remat) vs CPU (f32, plain versions). On
    step 1 B = 0 gives A no gradient: each layer's q, k, v lora_B gradients
    are held. Step 2 starts both from the CPU's weights after step 1 (Adam's
    first update is lr * sign(g) wherever |g| >> eps, so a gradient that
    differs in its last digits flips some of B's entries; the copy keeps
    that out of the comparison): each layer's lora_A gradients are held.
    The hub's bias gradients (all biases of its transformer, as one vector)
    are held at both steps."""
    ids, st_ids = lora_batch(np.random.RandomState(9), PARITY_ROWS, 254)
    cfg_h = dataclasses.replace(hub_cfg, num_layers=2)
    cfg_t = dataclasses.replace(tower_cfg, num_layers=2)
    state = {**{"encoders.sequence." + k: v for k, v in hub_state.items()},
             **{"encoders.struct_token." + k: v for k, v in tower_state.items()}}
    mods = {"cuda": lora_module(cfg_h, cfg_t, "cuda", torch.bfloat16, 0.0, True),
            "cpu": lora_module(cfg_h, cfg_t, "cpu", torch.float32, 0.0, False)}
    for m in mods.values():
        m.model.load_state_dict(state)
    out = {"steps": []}
    for step, factor in ((1, "lora_B"), (2, "lora_A")):
        if step == 2:
            with torch.no_grad():
                for pc, pg in zip(mods["cpu"].opt.params, mods["cuda"].opt.params):
                    pg.copy_(pc)
        runs = {}
        for device, m in mods.items():
            loss, _ = m.train_step("struct_token", ids, st_ids)
            runs[device] = {"loss": loss.item(), "grad": {
                n: p.grad for n, p in m.model.named_parameters()
                if p.grad is not None}}
        card, cpu = runs["cuda"], runs["cpu"]
        require(card["grad"].keys() == cpu["grad"].keys(), "gradient leaves differ")
        hub = "encoders.sequence.transformer."
        factors = {n: cosine(flat([card["grad"][n]]), flat([cpu["grad"][n]]))
                   for n in card["grad"] if n.startswith(hub) and n.endswith(factor)}
        require(len(factors) == 2 * 3, f"{factor} gradient leaves: {sorted(factors)}")
        biases = [n for n in card["grad"] if n.startswith(hub) and n.endswith("bias")]
        row = {"step": step, "loss_card": card["loss"], "loss_cpu": cpu["loss"],
               "loss_rel_diff": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
               f"{factor}_grad_cosine": factors,
               "hub_bias_grad_cosine": cosine(
                   flat(card["grad"][n] for n in biases),
                   flat(cpu["grad"][n] for n in biases)),
               "hub_bias_leaves": len(biases)}
        print(f"  LoRA step {step}, card vs CPU: loss {card['loss']:.6f} vs "
              f"{cpu['loss']:.6f} (rel diff {row['loss_rel_diff']:.2e}, gate <= "
              f"2e-2); {factor} gradient cosine per layer and projection, least "
              f"{min(factors.values()):.5f} (gate >= 0.99); the hub's "
              f"{len(biases)} bias gradients as one vector: cosine "
              f"{row['hub_bias_grad_cosine']:.5f} (gate >= 0.99)", flush=True)
        require(row["loss_rel_diff"] <= 2e-2,
                f"LoRA step {step} loss parity {row['loss_rel_diff']}")
        require(min(factors.values()) >= 0.99,
                f"LoRA step {step} {factor} gradient parity {factors}")
        require(row["hub_bias_grad_cosine"] >= 0.99,
                f"LoRA step {step} hub bias gradient parity "
                f"{row['hub_bias_grad_cosine']}")
        out["steps"].append(row)
    return out


def check_embeddings(feats: np.ndarray, n: int, what: str) -> None:
    require(feats.shape == (n, 1024), f"{what}: shape {feats.shape}")
    require(bool(np.isfinite(feats).all()), f"{what}: non-finite embeddings")
    norms = np.linalg.norm(feats, axis=-1)
    require(bool(np.all(np.abs(norms - 1.0) <= 1e-2)),
            f"{what}: norms {norms.min()}..{norms.max()}")


def serve(embedder, requests, what: str):
    """Answer the requests; returns (embeddings, seconds per request)."""
    feats, secs = [], []
    for req in requests:
        t = time.time()
        feats.append(embedder.embed_sequences(req, batch_size=32))
        secs.append(time.time() - t)
        check_embeddings(feats[-1], len(req), what)
    n = sum(len(r) for r in requests)
    print(f"  {what}: {n} sequences in {sum(secs):.3f} s = "
          f"{n / sum(secs):.1f} seq/s (requests: "
          + ", ".join(f"{s * 1e3:.1f} ms" for s in secs) + ")", flush=True)
    return np.concatenate(feats), secs


def check_retrieval(embedder, feats: np.ndarray, rng, what: str) -> None:
    pool = rng.randn(1024, 1024).astype(np.float32)
    pool[:len(feats)] = feats
    queries = feats[:32]
    n = len(queries)
    scores, idx = embedder.retrieve(queries, pool, k=10)
    require(idx.shape == (n, 10), f"{what} retrieve: shape {idx.shape}")
    require(bool(np.all(idx[:, 0] == np.arange(n))),
            f"{what} retrieve: a query's nearest pool entry is not itself")
    require(bool(np.all(np.abs(scores[:, 0] - 1.0) < 1e-3)),
            f"{what} retrieve: top score {scores[:, 0].min()}")
    print(f"  {what}: retrieve(k=10) over 1024 pool entries: every query "
          f"finds itself first", flush=True)


def write_msas(root: str, rng, n: int, homologs: int = HOMOLOGS) -> list:
    """n synthetic .a3m files: a query of log-normal length around 290
    residues clipped to [20, 1022] (as sample_seqs) and `homologs` point
    mutants of it, each with '-' gaps and lowercase insertions, so that
    read_msa and greedy_select do real work."""
    paths = []
    for i, n_res in enumerate(np.clip(rng.lognormal(np.log(290.0), 0.75, n),
                                      20, 1022).astype(int)):
        query = rng.choice(list(AAS), n_res)
        lines = [">query", "".join(query)]
        for h in range(homologs):
            row = query.copy()
            mutate = rng.rand(n_res) < rng.uniform(0.05, 0.6)
            row[mutate] = rng.choice(list(AAS), int(mutate.sum()))
            row[rng.rand(n_res) < 0.1] = "-"
            inserts = rng.rand(n_res) < 0.03
            lines += [f">homolog_{h}", "".join(
                ch + ("".join(rng.choice(list(AAS.lower()), rng.randint(1, 4)))
                      if ins else "") for ch, ins in zip(row, inserts))]
        paths.append(os.path.join(root, f"msa_{i:03d}.a3m"))
        with open(paths[-1], "w") as f:
            f.write("\n".join(lines) + "\n")
    return paths


def serve_msas(root: str, gen, rng, smi: str, launches: dict):
    """The MSA-1b serving path at full width, on .a3m files it writes under
    `root`; fills `launches`. Returns (numbers, the tower's state, the
    requests' files)."""
    paths = write_msas(root, rng, MSA_REQUESTS * MSAS_PER_REQUEST)
    requests = [paths[i:i + MSAS_PER_REQUEST]
                for i in range(0, len(paths), MSAS_PER_REQUEST)]
    # the entry point's defaults: esm_msa1b, 1024 wide mlp head, bf16, card
    enc = create_msa_encoder()
    require(enc.config.num_layers == MSA_LAYERS
            and enc.config.hidden_size == 768 and enc.config.num_heads == 12
            and enc.config.intermediate_size == 3072,
            f"MSA-1b widths: {enc.config}")
    msa_transformer.init_msa_weights_(enc, gen)
    embedder = OneProtEmbedder(OneProtModel({"msa": enc}))
    reset_launches()
    feats, secs = [], []
    for req in requests:
        t = time.time()
        feats.append(embedder.embed_msas(req))  # depth 16, batch 4, 1024
        secs.append(time.time() - t)
    launches["MSA-1b serving"] = read_launches()
    batches = sum(-(-len(r) // 4) for r in requests)
    want = {name: 0 for name in LAUNCHERS}
    want["tied_row_attention"] = MSA_LAYERS * batches
    require(launches["MSA-1b serving"] == want,
            f"MSA-1b launches {launches['MSA-1b serving']}, want {want}")
    require(not any(PLAIN_CALLS.values()),
            f"MSA serving: plain versions ran on the card: {PLAIN_CALLS}")
    feats = np.concatenate(feats)
    n = len(paths)
    require(feats.shape == (n, 1024), f"MSA-1b: shape {feats.shape}")
    require(bool(np.isfinite(feats).all()), "MSA-1b: non-finite embeddings")
    norms = np.linalg.norm(feats, axis=-1)
    require(bool(np.all(np.abs(norms * 0.07 - 1.0) <= 1e-3)),
            f"MSA-1b: norms {norms.min()}..{norms.max()}, want 1/0.07")
    check_retrieval(embedder, feats, rng, "MSA-1b")
    print(f"  MSA-1b: {n} MSAs (depth {MSA_DEPTH}, {HOMOLOGS} homologs each) "
          f"in {sum(secs):.3f} s = {n / sum(secs):.2f} MSAs/s (requests: "
          + ", ".join(f"{x * 1e3:.1f} ms" for x in secs)
          + f"); launches {launches['MSA-1b serving']}; {smi}", flush=True)
    result = {"msas": n, "requests": len(requests),
              "msas_per_s": n / sum(secs),
              "request_ms": [x * 1e3 for x in secs]}
    return result, enc.state_dict(), requests


def msa_parity(state: dict, paths: list) -> dict:
    """The tower's first 2 layers and its head, card (bf16, kernel) against
    CPU (f32, plain version), on the same MSAs through embed_msas: the
    tower's [B, R, L, H] output token by token (min cosine over every
    unpadded token of every row) and the embeddings (mean cosine)."""
    state2 = first_layers(state, 2)
    outs, towers = [], []
    for device, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        enc = create_msa_encoder(num_layers=2, device=device, dtype=dtype)
        enc.load_state_dict(state2)
        hook = enc.transformer.register_forward_hook(
            lambda _, args, out: towers.append((args[0].cpu(),
                                                out.float().cpu())))
        outs.append(OneProtEmbedder(OneProtModel({"msa": enc})).embed_msas(paths))
        hook.remove()
    require(len(towers) == 2, f"MSA parity: {len(towers)} tower runs, want 2 "
            f"(one batch on each device)")
    (tok_card, card), (tok_cpu, cpu) = towers
    require(torch.equal(tok_card, tok_cpu), "MSA parity: tokens differ")
    keep = tok_cpu != msa_transformer.MsaTransformerConfig().pad_token_id
    token_cos = torch.nn.functional.cosine_similarity(card[keep], cpu[keep],
                                                      dim=-1)
    rel = float((card[keep] - cpu[keep]).abs().max() / cpu[keep].abs().max())
    result = {"tower_min_token_cosine": float(token_cos.min()),
              "tower_mean_token_cosine": float(token_cos.mean()),
              "tower_max_rel_err": rel, "tokens": int(keep.sum()),
              "embedding_mean_cosine": mean_cosine(*outs)}
    print(f"  MSA-1b at 2 layers, card vs CPU: tower output over "
          f"{result['tokens']} tokens: min cosine "
          f"{result['tower_min_token_cosine']:.6f} (gate >= "
          f"{MSA_TOKEN_COS}), mean {result['tower_mean_token_cosine']:.6f}, "
          f"max rel err {rel:.3e}; embeddings mean cosine "
          f"{result['embedding_mean_cosine']:.6f} (gate >= 0.999)", flush=True)
    require(result["tower_min_token_cosine"] >= MSA_TOKEN_COS,
            f"MSA tower parity: a token's cosine "
            f"{result['tower_min_token_cosine']} < {MSA_TOKEN_COS}")
    require(result["embedding_mean_cosine"] >= 0.999,
            f"MSA parity {result['embedding_mean_cosine']} < 0.999")
    return result


def serve_wide_hub(smi: str, launches: dict):
    """The hub at the ESM2-15B width (random weights from a seed, bf16,
    ~30 GB on the card) answers 3 requests of 32 sequences drawn from its
    own numpy stream; fills `launches`. Returns (numbers, its first 2
    layers' state on the CPU, its config); the caller frees the hub."""
    # the entry point on the config directory: 1024 wide mlp head, bf16, card
    enc = create_sequence_encoder(model_name_or_path=str(WIDE_HUB),
                                  proj_type="mlp")
    cfg = enc.config
    require((cfg.num_layers, cfg.hidden_size, cfg.num_heads,
             cfg.intermediate_size) == (WIDE_LAYERS, 5120, 40, 20480),
            f"ESM2-15B widths: {cfg}")
    esm2.init_esm2_weights_(enc, torch.Generator(device="cuda").manual_seed(5))
    n_params = sum(p.numel() for p in enc.parameters())
    rng = np.random.RandomState(3)
    requests = [sample_seqs(32, rng) for _ in range(3)]
    embedder = OneProtEmbedder(OneProtModel({"sequence": enc}), buckets=BUCKETS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    feats, secs = serve(embedder, requests, "ESM2-15B-width hub")
    launches["15B hub"] = read_launches()
    batches = len(requests)  # 32 sequences a request, batch_size 32
    want = {name: 0 for name in LAUNCHERS}
    want["flash_attention_fwd"] = WIDE_LAYERS * batches
    require(launches["15B hub"] == want,
            f"15B hub launches {launches['15B hub']}, want {want}")
    require(not any(PLAIN_CALLS.values()),
            f"15B hub: plain versions ran on the card: {PLAIN_CALLS}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_retrieval(embedder, feats, rng, "15B hub")
    state2 = first_layers(enc.state_dict(), 2)
    del embedder, enc
    n = sum(len(r) for r in requests)
    print(f"  15B hub: {n_params / 1e9:.3f} B parameters; launches "
          f"{launches['15B hub']}; peak device memory {peak:.2f} GiB (both "
          f"hubs' weights included); {smi}", flush=True)
    result = {"sequences": n, "requests": len(requests),
              "seq_per_s": n / sum(secs), "request_ms": [x * 1e3 for x in secs],
              "params": n_params, "peak_gib": peak}
    return result, state2, cfg


def wide_hub_parity(state: dict, cfg) -> dict:
    """The 15B-width hub's first 2 layers and its head, card (bf16, kernels)
    against CPU (f32, plain versions), on PARITY_ROWS sequences through
    embed_sequences, as it is and through `quantize_esm2_int8_tree` (the
    int8 hub: its fc1 rows, 20480 wide, go through the GELU->int8 kernel):
    mean embedding cosine of each."""
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    seqs = sample_seqs(PARITY_ROWS, np.random.RandomState(4))
    parity = {}
    for name, quant, tol in (("bf16", False, 0.999), ("int8", True, 0.99)):
        weights = esm2.quantize_esm2_int8_tree(state) if quant else state
        outs = []
        for device, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
            model = SequenceEncoder(cfg2, 1024, proj_type="mlp", quant_int8=quant,
                                    device=device, dtype=dtype)
            model.load_state_dict(weights)
            outs.append(OneProtEmbedder(OneProtModel({"sequence": model}),
                                        buckets=BUCKETS).embed_sequences(seqs))
            del model
        parity[name] = mean_cosine(*outs)
        print(f"  15B-width {name} hub at 2 layers, card vs CPU, {PARITY_ROWS} "
              f"sequences: mean cosine {parity[name]:.6f} (gate >= {tol})",
              flush=True)
        require(parity[name] >= tol, f"15B-width {name} parity {parity[name]} < {tol}")
    return parity


def mean_cosine(a: np.ndarray, b: np.ndarray) -> float:
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    return float(np.mean(np.sum(a * b, axis=-1)))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("device")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"  {kind}; nvidia-smi: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, Python {sys.version.split()[0]}", flush=True)

    phase("build")
    t = time.time()
    _build.build_all()
    print(f"  built in {time.time() - t:.1f} s into {_build.BUILD_DIR}", flush=True)
    for name in _build.SIGNATURES:
        for instance, line in ptxas_report(_build.build_log(name)):
            print(f"  {name}{instance}: {line}", flush=True)

    phase("kernels against their plain versions")
    count_plain_calls()
    gen = torch.Generator(device="cuda").manual_seed(0)
    fwd_row = check_flash(gen)
    rows = [fwd_row, *check_flash_bwd(gen, fwd_row), check_gelu_quant(gen),
            check_tied_row(gen), check_flash_attention(gen),
            *check_flash_attention_bwd(gen)]

    phase("serving: ESM2-650M hub, bf16")
    rng = np.random.RandomState(0)
    requests = [sample_seqs(32, rng) for _ in range(3)]
    batches = len(requests)  # 32 sequences a request, batch_size 32
    # the entry point's defaults: ESM2-650M, 1024 wide, bf16, on the card
    enc = create_sequence_encoder(proj_type="mlp")
    esm2.init_esm2_weights_(enc, torch.Generator(device="cuda").manual_seed(0))
    embedder = OneProtEmbedder(OneProtModel({"sequence": enc}), buckets=BUCKETS)
    launches = {}  # path -> {kernel: launches in that path's run}
    reset_launches()
    feats_bf16, secs_bf16 = serve(embedder, requests, "bf16 hub")
    launches["bf16 hub"] = read_launches()
    none = {name: 0 for name in LAUNCHERS}
    require(launches["bf16 hub"] == {**none, "flash_mha_fwd": N_LAYERS * batches},
            f"bf16 hub launches: {launches['bf16 hub']}")
    check_retrieval(embedder, feats_bf16, rng, "bf16 hub")

    phase("serving: ESM2-650M hub, int8")
    enc8 = create_sequence_encoder(proj_type="mlp", quantize="int8")
    enc8.load_state_dict(esm2.quantize_esm2_int8_tree(enc.state_dict()))
    embedder8 = OneProtEmbedder(OneProtModel({"sequence": enc8}), buckets=BUCKETS)
    reset_launches()
    feats_int8, secs_int8 = serve(embedder8, requests, "int8 hub")
    launches["int8 hub"] = read_launches()
    require(launches["int8 hub"] == {**none, "flash_mha_fwd": N_LAYERS * batches,
                                     "gelu_quant": N_LAYERS * batches},
            f"int8 hub launches: {launches['int8 hub']}")
    require(not any(PLAIN_CALLS.values()),
            f"serving: plain versions ran on the card: {PLAIN_CALLS}")
    print(f"  launches on each serving path ({batches} batches each): "
          f"{launches}", flush=True)
    check_retrieval(embedder8, feats_int8, rng, "int8 hub")
    cos_hubs = mean_cosine(feats_bf16, feats_int8)
    print(f"  bf16 vs int8 hub: mean cosine {cos_hubs:.5f} (reported, not gated)",
          flush=True)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    del embedder8, enc8

    phase("parity: 2 layers at full width, card (bf16, kernels) vs CPU (f32, plain)")
    cfg2 = dataclasses.replace(esm2.ESM2_SIZES["esm2_t33_650M"], num_layers=2)
    state2 = {k: v for k, v in enc.state_dict().items()
              if not k.startswith("transformer.layers.")
              or int(k.split(".")[2]) < 2}
    seqs = sample_seqs(8, np.random.RandomState(1))
    torch.set_num_threads(os.cpu_count() or 1)
    parity = {}
    for name, quant, tol in (("bf16", False, 0.999), ("int8", True, 0.99)):
        state = esm2.quantize_esm2_int8_tree(state2) if quant else state2
        outs = []
        for device, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
            model = SequenceEncoder(cfg2, 1024, proj_type="mlp", quant_int8=quant,
                                    device=device, dtype=dtype)
            model.load_state_dict(state)
            outs.append(OneProtEmbedder(OneProtModel({"sequence": model}),
                                        buckets=BUCKETS).embed_sequences(seqs))
        parity[name] = mean_cosine(*outs)
        print(f"  {name} hub: card vs CPU mean cosine {parity[name]:.6f} "
              f"(gate >= {tol})", flush=True)
        require(parity[name] >= tol, f"{name} parity {parity[name]} < {tol}")

    phase("serving: ESM2-15B width (48 x 5120, 40 heads of 128), bf16")
    torch.cuda.empty_cache()
    wide, wide_state, wide_cfg = serve_wide_hub(smi, launches)
    torch.cuda.empty_cache()  # the hub's 30 GB go back before what follows

    phase("15B-width parity: 2 layers at full width, bf16 and int8, card "
          "(bf16, kernels) vs CPU (f32, plain)")
    wide["parity_mean_cosine"] = wide_hub_parity(wide_state, wide_cfg)
    del wide_state

    with tempfile.TemporaryDirectory(prefix="chip_smoke_msa_") as msa_dir:
        phase("serving: MSA-1b (esm_msa1b, 12 x 768), depth 16, batch 4, up "
              "to 1024 columns")
        # its own numpy stream, so that the training batch below stays the
        # one drawn from `rng` before this path was added
        msa, msa_state, msa_requests = serve_msas(
            msa_dir, torch.Generator(device="cuda").manual_seed(2),
            np.random.RandomState(2), smi, launches)

        phase("MSA parity: 2 layers at full width, card (bf16, kernel) vs CPU "
              "(f32, plain)")
        msa["parity"] = msa_parity(msa_state, msa_requests[0])
    del msa_state

    phase("training: ESM2-650M hub + ESM2-35M struct-token tower, packed "
          "and cached steps")
    train, (hub_state, tower_state, tower_cfg), batch = training(enc, rng,
                                                                launches)

    phase("training parity: 2 + 2 layers at full width, card (bf16, kernels) "
          "vs CPU (f32, plain); cached vs uncached")
    train_parity = training_parity(hub_state, tower_state, enc.config,
                                   tower_cfg, batch)
    del embedder, enc, hub_state, tower_state
    torch.cuda.empty_cache()

    phase("training: LoRA-15B (48 x 5120 frozen bf16, LoRA r 16 on q/k/v, "
          "remat) + ESM2-35M struct-token tower, unpacked steps")
    lora, lora_initial = train_lora_hub(smi, launches)
    torch.cuda.empty_cache()

    phase("LoRA training parity: 2 + 2 layers at full width, two steps, card "
          "(bf16, kernels) vs CPU (f32, plain)")
    lora["parity"] = lora_parity(*lora_initial)
    del lora_initial

    for row in rows:
        # each path's count read from its own run; `launches` is their sum
        row["launches_by_path"] = {path: counts[row["name"]]
                                   for path, counts in launches.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    n_seq = sum(len(r) for r in requests)
    print(json.dumps({
        "serving": {"sequences": n_seq, "requests": len(requests),
                    "bf16_seq_per_s": n_seq / sum(secs_bf16),
                    "int8_seq_per_s": n_seq / sum(secs_int8),
                    "bf16_request_ms": [s * 1e3 for s in secs_bf16],
                    "int8_request_ms": [s * 1e3 for s in secs_int8],
                    "bf16_vs_int8_mean_cosine": cos_hubs,
                    "parity_mean_cosine": parity,
                    "peak_gib": peak_gb},
        "wide_hub_serving": wide,
        "msa_serving": msa,
        "training": {**train, "parity": train_parity},
        "lora_training": lora,
        "wall_s": time.time() - T0}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
