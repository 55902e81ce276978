#!/usr/bin/env python3
"""Where the serving path's device time goes, on the card.

    python3 scripts/profile_torch_serving.py

Builds the full-width ESM2-650M hub of the PyTorch port (random weights from
a seed, bf16 and int8), answers one warm-up request of 32 sequences and then
one profiled request per hub under torch.profiler, and prints each hub's
device kernels by total time, their share of the device time, and the
device's busy share of the request's wall time. Needs one CUDA card; the
request is the same log-normal length mix as chip_smoke.py.
"""

from __future__ import annotations

import os
import sys
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import BUCKETS, sample_seqs  # noqa: E402
from oneprot_tpu_torch.models import esm2  # noqa: E402
from oneprot_tpu_torch.models.encoders import (  # noqa: E402
    OneProtModel,
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


def profile_hub(name: str, embedder: OneProtEmbedder, request) -> None:
    embedder.embed_sequences(request)  # warm-up: cuBLAS handles, lazy loads
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.time()
        embedder.embed_sequences(request)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t) * 1e3
    times = kernel_times(prof)
    busy = sum(times.values())
    print(f"{name}: request wall {wall_ms:.1f} ms (under the profiler), device "
          f"busy {busy:.1f} ms = {100 * busy / wall_ms:.1f}% of wall", flush=True)
    for kname, ms in sorted(times.items(), key=lambda kv: -kv[1])[:TOP]:
        print(f"  {ms:9.3f} ms {100 * ms / busy:5.1f}%  {kname[:110]}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_serving: no CUDA device", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0), flush=True)
    request = sample_seqs(32, np.random.RandomState(0))
    kw = dict(output_dim=1024, proj_type="mlp", dtype="bfloat16", device="cuda")
    enc = create_sequence_encoder("facebook/esm2_t33_650M_UR50D", **kw)
    esm2.init_esm2_weights_(enc, torch.Generator(device="cuda").manual_seed(0))
    profile_hub("bf16 hub", OneProtEmbedder(OneProtModel({"sequence": enc}),
                                            buckets=BUCKETS), request)
    enc8 = create_sequence_encoder("facebook/esm2_t33_650M_UR50D",
                                   quantize="int8", **kw)
    enc8.load_state_dict(esm2.quantize_esm2_int8_tree(enc.state_dict()))
    profile_hub("int8 hub", OneProtEmbedder(OneProtModel({"sequence": enc8}),
                                            buckets=BUCKETS), request)
    return 0


if __name__ == "__main__":
    sys.exit(main())
