#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/H100 port (oneprot_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the checkout; imports torch, numpy, the
standard library and oneprot_tpu_torch only. Phases, each announced with
the elapsed seconds:

1. device: card name, power limit, torch and CUDA versions;
2. build: every CUDA kernel of the serving path, from the checkout's sources;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the hub's shapes, with its time, the plain version's, a library call's
   where one computes the same function, and the card's lower bound;
4. serving: the full-width ESM2-650M hub (random weights from a seed) with
   the 1024-wide mlp head answers 3 requests of 32 sequences and one top-10
   retrieval, bf16 hub then int8 hub, each built by `create_sequence_encoder`
   with its defaults (bf16, on the card); the launch counters, set to 0
   before each hub and read after it, show its kernels ran;
5. parity: the same weights at 2 layers on the card (bf16, kernels) against
   the CPU (f32, plain versions).

Every check raises on failure, so the exit code is non-zero. The last line
is {"ok": true, "device": {...}}; the line before it lists the kernels.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from oneprot_tpu_torch.kernels import _build, flash_mha, gelu_quant
from oneprot_tpu_torch.models import esm2
from oneprot_tpu_torch.models.encoders import (
    OneProtModel,
    SequenceEncoder,
    create_sequence_encoder,
)
from oneprot_tpu_torch.serving import OneProtEmbedder

T0 = time.time()

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor-core
# flop/s, f32 flop/s outside the tensor cores
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
FLASH_REL_TOL = 1.5e-2     # max |kernel - plain| / max |plain|, bf16
SCALE_REL_TOL = 1e-5       # GELU->int8 row scales
CODE_FLIP_SHARE = 1e-3     # GELU->int8 codes off by one, at most this share
N_LAYERS = 33
AAS = "ACDEFGHIKLMNPQRSTVWY"
BUCKETS = (256, 384, 512, 768, 1024)


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


def reset_launches() -> None:
    flash_mha.flash_mha_cuda.launches = 0
    gelu_quant.gelu_quant_cuda.launches = 0


def read_launches() -> dict:
    return {"flash_mha_fwd": flash_mha.flash_mha_cuda.launches,
            "gelu_quant": gelu_quant.gelu_quant_cuda.launches}


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def attention_inputs(B, L, H, D, gen, segments=False):
    dev = "cuda"
    q, k, v = (torch.randn(B, L, H * D, device=dev, generator=gen,
                           dtype=torch.float32).to(torch.bfloat16)
               for _ in range(3))
    lens = torch.randint(L // 2, L + 1, (B,), device=dev, generator=gen)
    valid = torch.arange(L, device=dev)[None, :] < lens[:, None]
    bias = ((1.0 - valid.float()) * -1e9)[:, None, None, :]
    cos, sin = esm2.rotary_cos_sin(L, D, device=dev)
    seg = None
    if segments:  # 4 contiguous proteins per row, padding as its own id
        seg = (torch.arange(L, device=dev)[None, :] * 4 // L).repeat(B, 1)
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
            "shape": f"B={B} L={L} H={H} D={D} bf16"}


def check_gelu_quant(gen) -> dict:
    M, N = 32 * 512, 5120
    y = (torch.randn(M, N, device="cuda", generator=gen) * 2.0).to(torch.bfloat16)
    q, s = gelu_quant.fused_gelu_quant(y)
    q_ref, s_ref = gelu_quant.gelu_quant_reference(y)
    torch.cuda.synchronize()
    code_diff = (q.int() - q_ref.int()).abs()
    flips = code_diff.ne(0).float().mean().item()
    scale_rel = ((s - s_ref).abs() / s_ref).max().item()
    deq_err = (q.float() * s - q_ref.float() * s_ref).abs().max().item()
    print(f"  gelu->int8 M={M} N={N}: max code diff {code_diff.max().item()}, "
          f"share off by one {flips:.2e}, scale max rel err {scale_rel:.2e}, "
          f"dequantized max abs err {deq_err:.3e}", flush=True)
    require(code_diff.max().item() <= 1, "gelu->int8: codes differ by > 1")
    require(flips <= CODE_FLIP_SHARE, f"gelu->int8: {flips} of codes flipped")
    require(scale_rel <= SCALE_REL_TOL, f"gelu->int8: scale rel err {scale_rel}")
    kernel = time_ms(lambda: gelu_quant.fused_gelu_quant(y))
    plain = time_ms(lambda: gelu_quant.gelu_quant_reference(y), iters=5)
    b_ms, b_by = bound_ms(M * N * 2 + M * N + M * 4, 10.0 * M * N, F32_FLOPS)
    print(f"  gelu->int8 timed: kernel {kernel:.4f} ms, plain {plain:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by})", flush=True)
    return {"name": "gelu_quant", "route": "cuda",
            "source": "oneprot_tpu_torch/kernels/csrc/gelu_quant.cu",
            "replaces": "oneprot_tpu/kernels/gelu_quant.py:60",
            "max_abs_err": deq_err, "max_code_diff": code_diff.max().item(),
            "ms": kernel, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "shape": f"M={M} N={N} bf16"}


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
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    phase("kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [check_flash(gen), check_gelu_quant(gen)]

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
    require(launches["bf16 hub"] == {"flash_mha_fwd": N_LAYERS * batches,
                                     "gelu_quant": 0},
            f"bf16 hub launches: {launches['bf16 hub']}")
    check_retrieval(embedder, feats_bf16, rng, "bf16 hub")

    phase("serving: ESM2-650M hub, int8")
    enc8 = create_sequence_encoder(proj_type="mlp", quantize="int8")
    enc8.load_state_dict(esm2.quantize_esm2_int8_tree(enc.state_dict()))
    embedder8 = OneProtEmbedder(OneProtModel({"sequence": enc8}), buckets=BUCKETS)
    reset_launches()
    feats_int8, secs_int8 = serve(embedder8, requests, "int8 hub")
    launches["int8 hub"] = read_launches()
    require(launches["int8 hub"] == {"flash_mha_fwd": N_LAYERS * batches,
                                     "gelu_quant": N_LAYERS * batches},
            f"int8 hub launches: {launches['int8 hub']}")
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
        "wall_s": time.time() - T0}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
