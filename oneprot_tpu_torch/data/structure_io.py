"""PDB and mmCIF structures -> the `seqstruc.h5` layout (counterpart of
oneprot_tpu/data/utils/structure_io.py), numpy and the standard library
only; `h5py` is imported only inside `write_seqstruc_h5`.

The layout every structure dataset reads:

    {id}/structure/0/{chain}/residues/seq1             scalar bytes, 1-letter
    {id}/structure/0/{chain}/polypeptide/type          [n_atom] atom names
    {id}/structure/0/{chain}/polypeptide/atom_amino_id [n_atom] residue index
    {id}/structure/0/{chain}/polypeptide/xyz           [n_atom, 3] coordinates

The PDB parser reads fixed-column ATOM records (wwPDB v3.3), the mmCIF
parser the `_atom_site` loop; both emit the same `Atom` rows, so a PDB and
a CIF of one entry give the same chains. HETATM records are kept only for
MSE, alternate locations only for altLoc '' or 'A', and only the first
model of an ensemble.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# 3-letter -> 1-letter, standard 20 residues (reference tutorial res_map
# order) plus MSE (selenomethionine, conventionally mapped to MET).
THREE_TO_ONE = {
    "ALA": "A", "ARG": "R", "ASN": "N", "ASP": "D", "CYS": "C",
    "GLN": "Q", "GLU": "E", "GLY": "G", "HIS": "H", "ILE": "I",
    "LEU": "L", "LYS": "K", "MET": "M", "PHE": "F", "PRO": "P",
    "SER": "S", "THR": "T", "TRP": "W", "TYR": "Y", "VAL": "V",
    "MSE": "M",
}


@dataclass
class Atom:
    chain: str
    res_key: Tuple[int, str]  # (resSeq, insertion code)
    res_name: str
    atom_name: str
    xyz: Tuple[float, float, float]


@dataclass
class Chain:
    """One chain's residue sequence + flat atom arrays (the h5 payload)."""

    seq1: str
    atom_names: np.ndarray      # [n_atom] bytes ('S4')
    atom_amino_id: np.ndarray   # [n_atom] int64, 1-based residue index
    xyz: np.ndarray             # [n_atom, 3] float32


def parse_pdb_atoms(text: str) -> List[Atom]:
    """Parse ATOM records from PDB text (fixed columns, wwPDB v3.3).

    HETATM is skipped except MSE (commonly deposited as HETATM but part of
    the polypeptide). Alternate locations keep only altLoc in ('', 'A').
    Parsing stops at the first ENDMDL so NMR ensembles contribute model 1
    only (matching the tutorial's "structure can contain multiple models"
    note -- the reference h5 layout stores model '0' alone).
    """
    atoms: List[Atom] = []
    for line in text.splitlines():
        rec = line[:6]
        if rec.strip() == "ENDMDL":
            break
        is_atom = rec == "ATOM  "
        res_name = line[17:20].strip() if len(line) >= 54 else ""
        if not is_atom and not (rec == "HETATM" and res_name == "MSE"):
            continue
        if len(line) < 54:
            continue
        alt = line[16].strip()
        if alt not in ("", "A"):
            continue
        try:
            x = float(line[30:38])
            y = float(line[38:46])
            z = float(line[46:54])
            res_seq = int(line[22:26])
        except ValueError:
            continue
        atoms.append(Atom(
            chain=line[21].strip() or "A",
            res_key=(res_seq, line[26].strip()),
            res_name=res_name,
            atom_name=line[12:16].strip(),
            xyz=(x, y, z),
        ))
    return atoms


def _cif_tokenize(line: str) -> List[str]:
    """Split one mmCIF data line into tokens (quoted strings supported)."""
    out: List[str] = []
    i, n = 0, len(line)
    while i < n:
        c = line[i]
        if c in " \t":
            i += 1
            continue
        if c in "'\"":
            j = line.find(c, i + 1)
            # per spec the closing quote must be followed by whitespace/EOL
            while j != -1 and j + 1 < n and line[j + 1] not in " \t":
                j = line.find(c, j + 1)
            if j == -1:
                out.append(line[i + 1:])
                break
            out.append(line[i + 1:j])
            i = j + 1
        else:
            j = i
            while j < n and line[j] not in " \t":
                j += 1
            out.append(line[i:j])
            i = j
    return out


def parse_mmcif_atoms(text: str) -> List[Atom]:
    """Parse the `_atom_site` loop of an mmCIF file.

    Uses auth_asym_id / auth_seq_id (the PDB-facing identifiers, what the
    tutorial's Bio.PDB MMCIFParser reports) with label_* fallbacks. Only
    the first model (pdbx_PDB_model_num) is kept.
    """
    lines = text.splitlines()
    atoms: List[Atom] = []
    i, n = 0, len(lines)
    while i < n:
        if lines[i].strip() != "loop_":
            i += 1
            continue
        # collect this loop's field names
        fields: List[str] = []
        i += 1
        while i < n and lines[i].strip().startswith("_"):
            fields.append(lines[i].strip().split()[0])
            i += 1
        if not fields or not fields[0].startswith("_atom_site."):
            continue
        idx = {f.split(".", 1)[1]: k for k, f in enumerate(fields)}

        def col(row: List[str], *names: str, default: str = "") -> str:
            for nm in names:
                k = idx.get(nm)
                if k is not None and k < len(row):
                    v = row[k]
                    if v not in (".", "?"):
                        return v
            return default

        first_model: Optional[str] = None
        while i < n:
            s = lines[i].strip()
            if not s or s.startswith(("_", "loop_", "#", "data_")):
                break
            row = _cif_tokenize(lines[i])
            i += 1
            if len(row) < len(fields):
                continue
            group = col(row, "group_PDB", default="ATOM")
            res_name = col(row, "auth_comp_id", "label_comp_id")
            if group != "ATOM" and not (group == "HETATM"
                                        and res_name == "MSE"):
                continue
            model = col(row, "pdbx_PDB_model_num", default="1")
            if first_model is None:
                first_model = model
            if model != first_model:
                continue
            alt = col(row, "label_alt_id")
            if alt not in ("", "A"):
                continue
            try:
                xyz = (float(col(row, "Cartn_x")),
                       float(col(row, "Cartn_y")),
                       float(col(row, "Cartn_z")))
                res_seq = int(col(row, "auth_seq_id", "label_seq_id",
                                  default="0"))
            except ValueError:
                continue
            atoms.append(Atom(
                chain=col(row, "auth_asym_id", "label_asym_id",
                          default="A"),
                res_key=(res_seq, col(row, "pdbx_PDB_ins_code")),
                res_name=res_name,
                atom_name=col(row, "auth_atom_id", "label_atom_id"),
                xyz=xyz,
            ))
        # one _atom_site loop per file is the norm; keep scanning anyway
    return atoms


def chains_from_atoms(atoms: Iterable[Atom]) -> Dict[str, Chain]:
    """Group parsed atoms into per-chain residue sequences + atom arrays.

    Residues whose 3-letter name is unknown are dropped entirely (sequence
    AND atoms), mirroring the reference tutorial's skip-and-log policy for
    residues missing from its chemical_weights.csv. atom_amino_id is
    1-based in occurrence order; the reference graph builder re-indexes it
    with np.unique(return_inverse) so any monotone id works
    (reference src/data/utils/struct_graph_utils.py:43).
    """
    by_chain: Dict[str, List[Atom]] = {}
    for a in atoms:
        by_chain.setdefault(a.chain, []).append(a)
    chains: Dict[str, Chain] = {}
    for cid, rows in by_chain.items():
        seq: List[str] = []
        names: List[bytes] = []
        amino_id: List[int] = []
        xyz: List[Tuple[float, float, float]] = []
        cur_key: Optional[Tuple[int, str]] = None
        keep = False
        for a in rows:
            if a.res_key != cur_key:
                cur_key = a.res_key
                one = THREE_TO_ONE.get(a.res_name)
                keep = one is not None
                if keep:
                    seq.append(one)
            if not keep:
                continue
            names.append(a.atom_name.encode())
            amino_id.append(len(seq))  # 1-based
            xyz.append(a.xyz)
        if not seq:
            continue
        chains[cid] = Chain(
            seq1="".join(seq),
            atom_names=np.array(names, dtype="S6"),
            atom_amino_id=np.array(amino_id, dtype=np.int64),
            xyz=np.array(xyz, dtype=np.float32).reshape(-1, 3),
        )
    return chains


def parse_structure_file(path: str) -> Dict[str, Chain]:
    """Dispatch on extension: .pdb/.ent -> PDB parser, .cif -> mmCIF."""
    with open(path) as f:
        text = f.read()
    ext = os.path.splitext(path)[1].lower()
    if ext in (".cif", ".mmcif"):
        atoms = parse_mmcif_atoms(text)
    elif ext in (".pdb", ".ent"):
        atoms = parse_pdb_atoms(text)
    else:  # sniff: mmCIF files start with data_ / # blocks
        head = text.lstrip()[:5]
        atoms = (parse_mmcif_atoms(text) if head.startswith("data_")
                 else parse_pdb_atoms(text))
    return chains_from_atoms(atoms)


def write_seqstruc_h5(
    h5_path: str,
    entries: Dict[str, Dict[str, Chain]],
    overwrite_entries: bool = True,
) -> List[str]:
    """Create/extend a seqstruc.h5 with `{id}/structure/0/{chain}/...` groups.

    Returns the list of ids written. Existing ids are replaced when
    overwrite_entries (so re-running ingestion is idempotent).
    """
    import h5py

    written: List[str] = []
    with h5py.File(h5_path, "a") as h5:
        for pid, chains in entries.items():
            if not chains:
                continue
            if pid in h5:
                if not overwrite_entries:
                    continue
                del h5[pid]
            for cid, ch in chains.items():
                g = h5.create_group(f"{pid}/structure/0/{cid}")
                g.create_dataset("residues/seq1", data=ch.seq1.encode())
                poly = g.create_group("polypeptide")
                poly.create_dataset("type", data=ch.atom_names)
                poly.create_dataset("atom_amino_id", data=ch.atom_amino_id)
                poly.create_dataset("xyz", data=ch.xyz)
            written.append(pid)
    return written


def ingest_files(
    paths: Sequence[str],
    h5_path: str,
    chain: str = "first",
    id_from: str = "stem",
) -> List[str]:
    """Ingest raw PDB/mmCIF files into a seqstruc.h5.

    chain='first' stores the file's first chain under group 'A' (the group
    every dataset reads -- reference datasets hardcode chain A for the
    non-PDB/AlphaFold layout); chain='all' stores every chain under its own
    id; any other value selects that chain id and stores it as 'A'.
    """
    entries: Dict[str, Dict[str, Chain]] = {}
    for p in paths:
        chains = parse_structure_file(p)
        if not chains:
            continue
        pid = (os.path.splitext(os.path.basename(p))[0]
               if id_from == "stem" else id_from)
        if chain == "all":
            entries[pid] = chains
        elif chain == "first":
            first = next(iter(chains))
            entries[pid] = {"A": chains[first]}
        else:
            if chain not in chains:
                continue
            entries[pid] = {"A": chains[chain]}
    return write_seqstruc_h5(h5_path, entries)
