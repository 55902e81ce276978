#!/usr/bin/env python3
"""The host-side collate work that the port's host library takes, timed
through the public entry points of a checkout.

    python3 scripts/time_host_library.py [--root CHECKOUT] [--label NAME]

Times, in the checkout at CHECKOUT (default: the one holding this script),
on this host's CPU: `EsmTokenizer.__call__` on 32 sequences of 1000
residues (bucket 1024), `graphs.knn_neighbors` on a 1024-residue chain
(K=24, 10 A), `msa_io.greedy_select` of 50 of 1024 MSA rows of 1024
columns, and the graph phase's host build of one batch, 16 synthetic
backbones of 1024 residues through `protein_to_padded_graph` (K=24), one
after another and in a pool of 4 threads. Median wall ms of 5 calls after
a warm-up. `--root` lets one call time a parent checkout and this one in
turns. Prints one line a case and the CPU's name; needs no card.
"""

from __future__ import annotations

import argparse
import os
import platform
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPS = 5
AAS = "ACDEFGHIKLMNPQRSTVWY"


def median_ms(fn) -> float:
    fn()
    walls = []
    for _ in range(REPS):
        t = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t) * 1e3)
    return float(np.median(walls))


def cpu_name() -> str:
    """/proc/cpuinfo's model name (or vendor and model numbers), the
    machine type and the logical core count."""
    fields = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            fields.setdefault(key.strip(), value.strip())
    name = next((fields[k] for k in ("model name", "cpu model", "Model",
                                     "Hardware") if fields.get(k)), None)
    if name is None:
        name = ", ".join(f"{k} {fields[k]}" for k in (
            "vendor_id", "cpu family", "model", "stepping", "CPU implementer",
            "CPU part") if fields.get(k)) or "no name in /proc/cpuinfo"
    return f"{name} ({platform.machine()}), {os.cpu_count()} logical cores"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from oneprot_tpu_torch.data import graphs, msa_io, structure_io, synthetic
    from oneprot_tpu_torch.data.tokenizers import esm2_tokenizer

    label = args.label or args.root
    rng = np.random.RandomState(0)
    tok = esm2_tokenizer()
    seqs = ["".join(rng.choice(list(AAS), 1000)) for _ in range(32)]
    coords = np.cumsum(rng.randn(1024, 3) * 2.2, axis=0).astype(np.float32)
    letters = np.array(list(AAS + "-"))
    msa = [(f"row{i}", "".join(rng.choice(letters, 1024))) for i in range(1024)]
    chains = []
    for _ in range(16):
        seq = "".join(rng.choice(list(AAS), 1024))
        chain = structure_io.chains_from_atoms(structure_io.parse_pdb_atoms(
            synthetic.backbone_pdb(seq, rng)))["A"]
        chains.append((chain.seq1, chain.atom_names, chain.atom_amino_id,
                       chain.xyz.astype(np.float64)))

    def build(chain):
        return graphs.protein_to_padded_graph(*chain, max_residues=1024,
                                              max_neighbors=24)

    pool = ThreadPoolExecutor(4)
    cases = (
        ("EsmTokenizer.__call__ 32 x 1000 residues, bucket 1024",
         lambda: tok(seqs, max_length=1024, padding=1024)),
        ("knn_neighbors 1024 residues, K=24",
         lambda: graphs.knn_neighbors(coords, 24, 10.0)),
        ("greedy_select 50 of 1024 rows x 1024 columns",
         lambda: msa_io.greedy_select(msa, 50)),
        ("protein_to_padded_graph 16 x 1024 residues, one thread",
         lambda: [build(c) for c in chains]),
        ("protein_to_padded_graph 16 x 1024 residues, 4 threads",
         lambda: list(pool.map(build, chains))),
    )
    cpu = cpu_name()
    for what, fn in cases:
        print(f"{label}: {what}: {median_ms(fn):.3f} ms ({cpu})", flush=True)
    pool.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
