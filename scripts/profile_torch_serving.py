#!/usr/bin/env python3
"""Where the serving path's device time goes, on the card.

    python3 scripts/profile_torch_serving.py

Builds the full-width ESM2-650M hub of the PyTorch port (random weights from
a seed, bf16 and int8) and the full-width MSA-1b tower, answers one warm-up
request and then one profiled request per model under torch.profiler (32
sequences for a hub, 4 synthetic MSAs through `embed_msas`'s defaults for
the MSA tower), and prints each model's device kernels by total time, their
share of the device time, and the device's busy share of the request's wall
time. Needs one CUDA card; the requests are chip_smoke.py's. Last, it
times the host's part of an MSA request, `read_msa` + `greedy_select` to
depth 16, on synthetic MSAs of 64, 1024 and 4096 homologs.
"""

from __future__ import annotations

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

from chip_smoke import BUCKETS, sample_seqs, write_msas  # noqa: E402
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


def profile_request(name: str, embed, request) -> None:
    """embed(request) once as a warm-up (cuBLAS handles, lazy loads), then
    once under the profiler."""
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
    if not torch.cuda.is_available():
        print("profile_torch_serving: no CUDA device", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0), subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
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
