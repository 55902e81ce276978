#!/usr/bin/env python3
"""Where the serving path's device time goes, on the card.

    python3 scripts/profile_torch_serving.py
    python3 scripts/profile_torch_serving.py --hub oneprot_tpu_torch/hub_configs/esm2_t48_15B_UR50D

Without `--hub`, builds the full-width ESM2-650M hub of the PyTorch port (random weights from
a seed, bf16 and int8) and the full-width MSA-1b tower, answers one warm-up
request and then one profiled request per model under torch.profiler (32
sequences for a hub, 4 synthetic MSAs through `embed_msas`'s defaults for
the MSA tower), and prints each model's device kernels by total time, their
share of the device time, and the device's busy share of the request's wall
time. Needs one CUDA card; the requests are chip_smoke.py's. Last, it
times the host's part of an MSA request, `read_msa` + `greedy_select` to
depth 16, on synthetic MSAs of 64, 1024 and 4096 homologs.

With `--hub` (an ESM2 name or a directory holding an HF config.json), it
profiles that bf16 hub alone at full width (random weights from seed 5) on
the first request of chip_smoke.py's ESM2-15B-width phase (32 sequences
from numpy seed 3), splits the request's device time into GEMMs, the
attention kernel and the rest, and times one layer's rotary of q and k
(outside the kernel for heads wider than 64) with CUDA events.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import BUCKETS, sample_seqs, time_ms, write_msas  # noqa: E402
from oneprot_tpu_torch.data.common import pick_bucket  # noqa: E402
from oneprot_tpu_torch.data.msa_io import greedy_select, read_msa  # noqa: E402
from oneprot_tpu_torch.models import esm2, msa_transformer  # noqa: E402
from oneprot_tpu_torch.models.encoders import (  # noqa: E402
    OneProtModel,
    create_msa_encoder,
    create_sequence_encoder,
)
from oneprot_tpu_torch.serving import OneProtEmbedder  # noqa: E402

TOP = 12


def kernel_times(prof) -> dict:
    """Device time (ms) summed by kernel name, device events only."""
    out = defaultdict(float)
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            out[evt.name] += evt.time_range.elapsed_us() / 1e3
    return out


def profile_request(name: str, embed, request) -> dict:
    """embed(request) once as a warm-up (cuBLAS handles, lazy loads), then
    once under the profiler. Returns the device ms by kernel name."""
    embed(request)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.time()
        embed(request)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t) * 1e3
    times = kernel_times(prof)
    busy = sum(times.values())
    print(f"{name}: request wall {wall_ms:.1f} ms (under the profiler), device "
          f"busy {busy:.1f} ms = {100 * busy / wall_ms:.1f}% of wall", flush=True)
    for kname, ms in sorted(times.items(), key=lambda kv: -kv[1])[:TOP]:
        print(f"  {ms:9.3f} ms {100 * ms / busy:5.1f}%  {kname[:110]}", flush=True)
    return times


def profile_hub(hub: str) -> None:
    """One bf16 request of 32 through the named or configured hub, with its
    device time split into GEMMs (cuBLAS's nvjet and gemm kernels), the
    port's attention kernels and the rest; then one layer's rotary of q and
    k at the request's shape."""
    enc = create_sequence_encoder(hub, output_dim=1024, proj_type="mlp",
                                  dtype="bfloat16", device="cuda")
    esm2.init_esm2_weights_(enc, torch.Generator(device="cuda").manual_seed(5))
    cfg = enc.config
    request = sample_seqs(32, np.random.RandomState(3))
    times = profile_request(
        f"{hub} ({cfg.num_layers} x {cfg.hidden_size}, heads of "
        f"{cfg.hidden_size // cfg.num_heads}), bf16",
        OneProtEmbedder(OneProtModel({"sequence": enc}),
                        buckets=BUCKETS).embed_sequences, request)
    busy = sum(times.values())
    groups = defaultdict(float)
    for kname, ms in times.items():
        if "flash_attention_fwd" in kname or "flash_mha_fwd" in kname:
            groups["attention kernel"] += ms
        elif any(w in kname.lower() for w in ("nvjet", "gemm", "cutlass")):
            groups["GEMMs"] += ms
        else:
            groups["other"] += ms
    print("  by group: " + ", ".join(
        f"{g} {ms:.1f} ms ({100 * ms / busy:.1f}%)"
        for g, ms in sorted(groups.items(), key=lambda kv: -kv[1])),
        flush=True)
    B, D = len(request), cfg.hidden_size // cfg.num_heads
    L = pick_bucket(max(len(x) + 2 for x in request), BUCKETS, 1024)
    q2d, k2d = (torch.randn(B, L, cfg.hidden_size, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
    cos, sin = (t.to(torch.bfloat16) for t in esm2.rotary_cos_sin(
        L, D, device="cuda"))

    def rotary():
        for x in (q2d, k2d):
            esm2.apply_rotary(x.view(B, L, cfg.num_heads, D).transpose(1, 2),
                              cos, sin)

    if D > 64:
        ms = time_ms(rotary)
        print(f"  rotary of q and k in bf16 at B={B} L={L}: {ms:.3f} ms a "
              f"layer, {ms * cfg.num_layers:.1f} ms over {cfg.num_layers} "
              f"layers", flush=True)


def time_msa_selection(root: str) -> None:
    """Host ms per MSA of `embed_msas`'s reading and subsampling (depth 16),
    by the number of homologs in the .a3m file."""
    for homologs in (64, 1024, 4096):
        sub = os.path.join(root, f"h{homologs}")
        os.makedirs(sub)
        paths = write_msas(sub, np.random.RandomState(3), 4, homologs)
        t = time.time()
        for p in paths:
            greedy_select(read_msa(p), num_seqs=16)
        print(f"host read_msa + greedy_select(16), {homologs} homologs: "
              f"{(time.time() - t) * 1e3 / len(paths):.1f} ms per MSA",
              flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--hub", help="profile only this ESM2 hub (a name or "
                        "a directory holding an HF config.json)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serving: no CUDA device", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0), subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    if args.hub:
        profile_hub(args.hub)
        return 0
    request = sample_seqs(32, np.random.RandomState(0))
    kw = dict(output_dim=1024, proj_type="mlp", dtype="bfloat16", device="cuda")
    enc = create_sequence_encoder("facebook/esm2_t33_650M_UR50D", **kw)
    esm2.init_esm2_weights_(enc, torch.Generator(device="cuda").manual_seed(0))
    profile_request("bf16 hub", OneProtEmbedder(OneProtModel(
        {"sequence": enc}), buckets=BUCKETS).embed_sequences, request)
    enc8 = create_sequence_encoder("facebook/esm2_t33_650M_UR50D",
                                   quantize="int8", **kw)
    enc8.load_state_dict(esm2.quantize_esm2_int8_tree(enc.state_dict()))
    profile_request("int8 hub", OneProtEmbedder(OneProtModel(
        {"sequence": enc8}), buckets=BUCKETS).embed_sequences, request)
    del enc, enc8
    msa = create_msa_encoder()
    msa_transformer.init_msa_weights_(
        msa, torch.Generator(device="cuda").manual_seed(2))
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_msas(tmp, np.random.RandomState(2), 4)
        profile_request("MSA-1b (depth 16, batch 4)", OneProtEmbedder(
            OneProtModel({"msa": msa})).embed_msas, paths)
        time_msa_selection(tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
