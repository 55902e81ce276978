"""Synthetic dataset fixtures with the reference's on-disk schemas
(counterpart of oneprot_tpu/data/synthetic.py: the same files, byte for
byte, and the same HDF5 datasets for the same seed).

    ids = generate_fixtures(data_dir, n_train=8, n_eval=4, seed=0)

Tiny but schema-faithful fixtures for all six modalities:

  - seqstruc.h5 with `[id]/structure/0/A/residues/seq1` and
    `polypeptide/{type, atom_amino_id, xyz}`
  - pockets_100_residues.h5 (same layout, truncated)
  - train/val/test_saprot.txt + train_saprot.h5 with interleaved `strucseq`
  - {split}_text.csv, {split}_seqstruc.csv, {split}_pocket.csv
  - {split}_msa.csv + .a3m files
  - {split}_seqsim.txt, {split}_msa_seqsim.csv, clinvar_*.json
  - downstream task CSVs (id, sequence, label)

`backbone_pdb` writes one synthetic chain as PDB text.

The HDF5 files need h5py, which is imported only when fixtures are
written: the card's host has none, and there `ensure_fixtures` raises
ImportError naming it unless the fixtures are already there.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from oneprot_tpu_torch.data.structure_io import THREE_TO_ONE

AAS = "ACDEFGHIKLMNPQRSTVWY"
FOLDSEEK = "pynwrqhgdlvtmfsaeikc"
_BACKBONE = [b"N", b"CA", b"C", b"O", b"CB"]

WORDS = ["protein", "binding", "enzyme", "structure", "catalytic",
         "membrane", "site", "domain", "activity", "the", "a"]


def _random_seq(rng: np.random.RandomState, lo: int = 20, hi: int = 60) -> str:
    n = rng.randint(lo, hi)
    return "".join(AAS[i] for i in rng.randint(0, 20, n))


def _write_protein_group(h5, pid: str, seq: str, rng) -> None:
    g = h5.create_group(f"{pid}/structure/0/A")
    g.create_dataset("residues/seq1", data=np.bytes_(seq.encode()))
    n = len(seq)
    names, amino_id, xyz = [], [], []
    # a synthetic folded chain: helix-like CA trace + local atom offsets
    t = np.arange(n) * 100.0 * np.pi / 180.0
    ca = np.stack([2.3 * np.cos(t), 2.3 * np.sin(t), 1.5 * np.arange(n)], 1)
    for i in range(n):
        for atom in _BACKBONE:
            names.append(atom)
            amino_id.append(i + 1)
            xyz.append(ca[i] + rng.normal(0, 0.5, 3))
    g.create_dataset("polypeptide/type", data=np.array(names, dtype="S8"))
    g.create_dataset("polypeptide/atom_amino_id",
                     data=np.array(amino_id, np.int64))
    g.create_dataset("polypeptide/xyz",
                     data=np.array(xyz, np.float32))


def backbone_pdb(sequence: str, rng: np.random.RandomState,
                 chain: str = "A") -> str:
    """PDB text of a synthetic chain for `sequence`: the fixtures'
    helix-like CA trace, and N, CA, C, O and CB of each residue scattered
    around it by N(0, 0.5) Angstrom, as fixed-column ATOM records
    (`structure_io.parse_pdb_atoms` reads them back)."""
    one_to_three = {v: k for k, v in THREE_TO_ONE.items() if k != "MSE"}
    t = np.arange(len(sequence)) * 100.0 * np.pi / 180.0
    ca = np.stack([2.3 * np.cos(t), 2.3 * np.sin(t),
                   1.5 * np.arange(len(sequence))], 1)
    lines, serial = [], 0
    for i, aa in enumerate(sequence):
        for atom in _BACKBONE:
            serial += 1
            x, y, z = ca[i] + rng.normal(0, 0.5, 3)
            lines.append(f"ATOM  {serial:5d} {atom.decode():<4s} "
                         f"{one_to_three[aa]:>3s} {chain}{i + 1:4d}    "
                         f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00")
    return "\n".join(lines) + "\nEND\n"


def generate_fixtures(
    data_dir: str,
    n_train: int = 32,
    n_eval: int = 8,
    seed: int = 0,
    modalities: Optional[List[str]] = None,
    seq_len_range: tuple = (20, 60),
) -> Dict[str, List[str]]:
    """Create the full fixture tree under data_dir. Idempotent."""
    os.makedirs(data_dir, exist_ok=True)
    marker = os.path.join(data_dir, ".fixtures_ok")
    if os.path.exists(marker):
        with open(marker) as f:
            return json.load(f)
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"writing the synthetic fixtures to {data_dir} needs h5py, which "
            "is not installed: write them where h5py is, or point "
            "paths.data_dir at existing data") from e

    rng = np.random.RandomState(seed)
    counts = {"train": n_train, "val": n_eval, "test": n_eval}
    ids = {s: [f"{s}_prot_{i:04d}" for i in range(c)]
           for s, c in counts.items()}
    seqs = {pid: _random_seq(rng, *seq_len_range)
            for split in ids for pid in ids[split]}

    # ---- seqstruc.h5 (all proteins) + pockets h5 -------------------------
    with h5py.File(os.path.join(data_dir, "seqstruc.h5"), "w") as h5:
        for split in ids:
            for pid in ids[split]:
                _write_protein_group(h5, pid, seqs[pid], rng)
    with h5py.File(os.path.join(data_dir, "pockets_100_residues.h5"), "w") as h5:
        for split in ids:
            for pid in ids[split]:
                seq = seqs[pid][:16]  # pockets are small cut-outs
                _write_protein_group(h5, pid, seq, rng)

    # ---- struct_token: saprot txt + h5 -----------------------------------
    with h5py.File(os.path.join(data_dir, "train_saprot.h5"), "w") as h5:
        for split in ids:
            for pid in ids[split]:
                seq = seqs[pid]
                tdi = "".join(FOLDSEEK[i]
                              for i in rng.randint(0, 20, len(seq)))
                interleaved = "".join(a + b for a, b in zip(seq, tdi))
                h5.create_dataset(
                    f"{pid}/strucseq", data=np.bytes_(interleaved.encode()))
    for split in ids:
        with open(os.path.join(data_dir, f"{split}_saprot.txt"), "w") as f:
            f.write("\n".join(ids[split]) + "\n")
        if split == "train":
            with open(os.path.join(data_dir, "train_saprot_full.txt"), "w") as f:
                f.write("\n".join(ids[split]) + "\n")

    # ---- text csv ----------------------------------------------------------
    for split in ids:
        with open(os.path.join(data_dir, f"{split}_text.csv"), "w") as f:
            for pid in ids[split]:
                words = [WORDS[i] for i in rng.randint(0, len(WORDS), 8)]
                f.write(f"{pid},{' '.join(words)}\n")

    # ---- struct_graph / pocket csvs ---------------------------------------
    for split in ids:
        for kind in ("seqstruc", "pocket"):
            with open(os.path.join(data_dir, f"{split}_{kind}.csv"), "w") as f:
                for pid in ids[split]:
                    f.write(f"{pid},0\n")

    # ---- msa: a3m files + csv ----------------------------------------------
    msa_dir = os.path.join(data_dir, "msas")
    os.makedirs(msa_dir, exist_ok=True)
    for split in ids:
        with open(os.path.join(data_dir, f"{split}_msa.csv"), "w") as f:
            for pid in ids[split]:
                path = os.path.join(msa_dir, f"{pid}.a3m")
                seq = seqs[pid]
                with open(path, "w") as a3m:
                    a3m.write(f">{pid}\n{seq}\n")
                    for j in range(6):  # homologs with mutations + insertions
                        s = list(seq)
                        for k in rng.randint(0, len(s), 3):
                            s[k] = AAS[rng.randint(0, 20)]
                        hom = "".join(s)
                        if j % 2:
                            pos = rng.randint(0, len(hom))
                            hom = hom[:pos] + "ax" + hom[pos:]  # insertion
                        a3m.write(f">hom{j}\n{hom}\n")
                f.write(f"{pid},{path}\n")

    # ---- seqsim: txt + clinvar jsons + msa csv ------------------------------
    benign, pathogenic = {}, {}
    for split in ids:
        with open(os.path.join(data_dir, f"{split}_seqsim.txt"), "w") as f:
            for pid in ids[split]:
                seq = seqs[pid]
                # mutations keyed BY SEQUENCE (reference applies them to the
                # seq_id string itself, seqsim_dataset.py:96-120)
                muts = []
                for _ in range(3):
                    pos = rng.randint(0, len(seq))
                    muts.append(f"{seq[pos]}{pos + 1}{AAS[rng.randint(0, 20)]}")
                benign[seq] = muts
                pathogenic[seq] = muts[::-1]
                f.write(seq + "\n")
        with open(os.path.join(data_dir, f"{split}_msa_seqsim.csv"), "w") as f:
            f.write("req_seq,aligned_seq\n")
            for pid in ids[split]:
                f.write(f"{seqs[pid]},{seqs[pid]}\n")
    with open(os.path.join(data_dir, "clinvar_full_benign_mutations.json"), "w") as f:
        json.dump(benign, f)
    with open(os.path.join(data_dir, "clinvar_full_pathogenic_mutations.json"), "w") as f:
        json.dump(pathogenic, f)

    # ---- combined eval csv (reference eval.py:30-35 column layout:
    # ids, msa_files, text, struct_token, struct_graph, sequence, pocket) ----
    with open(os.path.join(data_dir, "test_all_modalities.csv"), "w") as f:
        f.write("ids,msa_files,text,struct_token,struct_graph,sequence,pocket\n")
        for pid in ids["test"]:
            words = " ".join(WORDS[i] for i in rng.randint(0, len(WORDS), 6))
            tdi = "".join(FOLDSEEK[i]
                          for i in rng.randint(0, 20, len(seqs[pid])))
            msa_path = os.path.join(msa_dir, f"{pid}.a3m")
            f.write(f"{pid},{msa_path},{words},{tdi},{pid},{pid},{pid}\n")

    # ---- downstream probe csvs ----------------------------------------------
    ds_dir = os.path.join(data_dir, "downstream")
    os.makedirs(ds_dir, exist_ok=True)
    for task, n_classes in (("ToyCls", 3), ("ToyReg", 0)):
        for split in ("train", "valid", "test"):
            with open(os.path.join(ds_dir, f"{task}_{split}.csv"), "w") as f:
                f.write("id,sequence,label\n")
                for i in range(16 if split == "train" else 8):
                    seq = _random_seq(rng, 10, 30)
                    label = (rng.randint(0, n_classes) if n_classes
                             else round(float(rng.randn()), 4))
                    f.write(f"{task}_{split}_{i},{seq},{label}\n")

    with open(marker, "w") as f:
        json.dump(ids, f)
    return ids


def ensure_fixtures(data_dir: str, **kwargs) -> str:
    """Generate fixtures if absent; returns data_dir."""
    generate_fixtures(data_dir, **kwargs)
    return data_dir
