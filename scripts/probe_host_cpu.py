#!/usr/bin/env python3
"""The host CPU beside the card, for the CPU halves of `chip_smoke.py`'s
parities: an f32 [2048, 1280] x [1280, 1943] product's GFLOP/s at 1-16
torch threads, then one epoch of the MLP probe at SaProt width (GO-BP,
`chip_smoke.probe_teacher`'s data: 16384 rows of 1280, hidden 512,
dropout 0) on the CPU, the card and the CPU again in this fresh process,
and one probe step's forward, backward and AdamW on the CPU.

    python3 scripts/probe_host_cpu.py

Needs one CUDA card. Prints the card's name and power limit with the
numbers.
"""

import dataclasses
import os
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from oneprot_tpu_torch.downstream import mlp_probe  # noqa: E402


def matmul_gflops(threads: int) -> float:
    torch.set_num_threads(threads)
    a, b = torch.randn(2048, 1280), torch.randn(1280, 1943)
    a @ b
    t = time.perf_counter()
    for _ in range(5):
        a @ b
    return 5 * 2 * 2048 * 1280 * 1943 / (time.perf_counter() - t) / 1e9


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_host_cpu: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    threads = torch.get_num_threads()
    print(f"{smi}; os.cpu_count {os.cpu_count()}, affinity "
          f"{len(os.sched_getaffinity(0))}, torch threads {threads}, python "
          f"threads {threading.active_count()}", flush=True)
    for n in (1, 2, 4, 8, 16):
        print(f"  f32 product at {n} threads: {matmul_gflops(n):.0f} GFLOP/s",
              flush=True)
    torch.set_num_threads(threads)

    rng = np.random.RandomState(chip_smoke.PROBE_SEED)
    x = {s: rng.randn(n, chip_smoke.PROBE_DIM).astype(np.float32)
         for s, n in chip_smoke.PROBE_ROWS.items()}
    task = "GO-BP"
    teacher = chip_smoke.probe_teacher(np.random.RandomState(
        [chip_smoke.PROBE_SEED, chip_smoke.PROBE_TASKS.index(task)]), task, x)
    splits = {s: (x[s], teacher[s][0]) for s in x}
    one = dataclasses.replace(mlp_probe.MLPProbeConfig(), dropout=0.0,
                              max_epochs=1)
    for device in ("cpu", "cuda", "cpu"):
        stats = {}
        mlp_probe.fit_mlp_probe(splits["train"], splits["valid"],
                                splits["test"], task, one, device=device,
                                stats=stats)
        print(f"  GO-BP probe epoch on {device}: {stats['train_s'] * 1e3:.1f} "
              f"ms ({stats['steps']} steps), metrics "
              f"{stats['metrics_s'] * 1e3:.1f} ms", flush=True)

    model = mlp_probe.MLPProbe([chip_smoke.PROBE_DIM, 512, 1943])
    model.reset_parameters(0)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.0)
    xb = torch.from_numpy(x["train"][:128])
    yb = torch.from_numpy(splits["train"][1][:128]).float()
    parts = (("forward", lambda: model(xb)),
             ("forward + backward", lambda: torch.nn.functional
              .binary_cross_entropy_with_logits(model(xb), yb).backward()),
             ("AdamW", opt.step))
    for name, fn in parts:
        fn()
        t = time.perf_counter()
        for _ in range(10):
            fn()
        print(f"  a probe step's {name} on the CPU: "
              f"{(time.perf_counter() - t) * 1e2:.2f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
