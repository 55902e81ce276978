#!/usr/bin/env python3
"""Which torch.distributed operations take CUDA tensors over gloo.

    python3 scripts/probe_gloo_cuda.py

Starts two processes on card 0 (a gloo world of 2: NCCL refuses two ranks
on one card) and tries each operation the port's collectives use on CPU
tensors, then on CUDA tensors (send/recv staged through host memory, as
`collectives.ring_shift` does on gloo), printing each operation's
outcome; an NCCL world of 1 runs the same operations on the card; last, a
gloo world of 2 sends CUDA tensors as they are, alone (gloo may abort the
process there: its exit codes are printed, and do not fail the probe).
Needs one CUDA card; imports torch only.
"""

from __future__ import annotations

import datetime
import json
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist


def ops(device: str) -> dict:
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {}

    def attempt(name, fn):
        try:
            ok = bool(fn())
            out[name] = "ok" if ok else "wrong result"
        except Exception as e:  # the probe reports what each op does
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"

    def all_reduce():
        x = torch.full((1000,), float(rank + 1), device=device)
        dist.all_reduce(x)
        return torch.all(x == sum(range(1, world + 1))).item()

    def broadcast():
        x = torch.full((1000,), float(rank + 7), device=device)
        dist.broadcast(x, 0)
        return torch.all(x == 7).item()

    def all_gather():
        x = torch.full((3, 4), float(rank), device=device)
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        return all(torch.all(p == r).item() for r, p in enumerate(parts))

    def all_gather_into_tensor():
        x = torch.full((3, 4), float(rank), device=device)
        y = torch.empty((3 * world, 4), device=device)
        dist.all_gather_into_tensor(y, x)
        return torch.equal(y.reshape(world, 3, 4)[:, 0, 0].cpu(),
                           torch.arange(world, dtype=torch.float32))

    def batch_isend_irecv(staged=False):
        x = torch.full((5, 6), float(rank), device="cpu" if device == "cpu"
                       else "cuda")
        if staged:  # through host memory, as collectives.ring_shift does
            x = x.cpu()
        y = torch.empty_like(x)
        nxt, prv = (rank + 1) % world, (rank - 1) % world
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, nxt),
                                       dist.P2POp(dist.irecv, y, prv)])
        for r in reqs:
            r.wait()
        return torch.all(y == prv).item()

    def broadcast_object_list():
        obj = [f"stamp-{rank}"]
        dist.broadcast_object_list(obj, 0)
        return obj[0] == "stamp-0"

    def barrier():
        dist.barrier()
        return True

    if device == "p2p":  # the card's tensors sent as they are, alone:
        attempt("batch_isend_irecv", batch_isend_irecv)  # may abort
        return out
    for name, fn in (("all_reduce", all_reduce), ("broadcast", broadcast),
                     ("all_gather", all_gather),
                     ("all_gather_into_tensor", all_gather_into_tensor),
                     ("broadcast_object_list", broadcast_object_list),
                     ("barrier", barrier),
                     ("batch_isend_irecv_staged",
                      lambda: batch_isend_irecv(staged=True))):
        attempt(name, fn)
        if device == "cuda":
            torch.cuda.synchronize()
    return out


def child(rank: int, world: int, init: str, backend: str, mode: str) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=60))
    result = {}
    if backend == "gloo" and world > 1 and mode == "p2p":
        result["cuda p2p"] = ops("p2p")
    else:
        if backend == "gloo":
            result["cpu"] = ops("cpu")
        result["cuda"] = ops("cuda")
    dist.destroy_process_group()
    if rank == 0:
        print(json.dumps({"backend": backend, "world": world, **result}),
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_gloo_cuda: no CUDA device", file=sys.stderr)
        return 1
    if len(sys.argv) == 6:
        child(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
              sys.argv[5])
        return 0
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for backend, world, mode in (("gloo", 2, "ops"), ("nccl", 1, "ops"),
                                     ("gloo", 2, "p2p")):
            init = f"file://{tmp}/rendezvous_{backend}_{mode}"
            procs = [subprocess.Popen([sys.executable, __file__, str(r),
                                       str(world), init, backend, mode])
                     for r in range(world)]
            codes = []
            for p in procs:
                try:
                    p.wait(timeout=180)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
                codes.append(p.returncode)
            if mode == "p2p":  # gloo may abort the process here
                print(json.dumps({"backend": backend, "world": world,
                                  "cuda p2p exit codes": codes}), flush=True)
            else:
                ok = ok and all(c == 0 for c in codes)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
