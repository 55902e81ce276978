"""MSA file reading and diversity subsampling (counterpart of
oneprot_tpu/data/utils/msa_io.py: `remove_insertions`, `read_fasta`,
`read_msa`, `greedy_select`, `filter_and_create_msa_file_list`), numpy
and the port's host library.

a3m/FASTA records are read without BioPython; lowercase insertion states
and '.'/'*' are dropped, so every row of an aligned MSA has the query's
length. `greedy_select` keeps the query row and picks rows of greatest
(or least) mean Hamming distance to those already picked, one at a time,
in the port's host library (`native.greedy_select_indices`);
`greedy_select_indices_plain` is the same choice in numpy. The rows come
back in file order, query first, as the JAX package returns them.
"""

from __future__ import annotations

import string
from typing import List, Tuple

import numpy as np

from oneprot_tpu_torch import native

Msa = List[Tuple[str, str]]  # (description, aligned sequence) per row

_DELETE_TABLE = str.maketrans("", "", string.ascii_lowercase + ".*")


def remove_insertions(sequence: str) -> str:
    """Drop lowercase insertion states and '.'/'*'."""
    return sequence.translate(_DELETE_TABLE)


def read_fasta(path: str) -> Msa:
    """(description, sequence) pairs of a FASTA or a3m file."""
    records: Msa = []
    desc = None
    chunks: List[str] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if desc is not None:
                    records.append((desc, "".join(chunks)))
                desc = line[1:].strip()
                chunks = []
            elif line:
                chunks.append(line.strip())
    if desc is not None:
        records.append((desc, "".join(chunks)))
    return records


def read_msa(path: str) -> Msa:
    """An MSA with its insertions removed; `path` may omit '.a3m'."""
    try:
        records = read_fasta(path)
    except FileNotFoundError:
        records = read_fasta(path + ".a3m")
    return [(d, remove_insertions(s)) for d, s in records]


def greedy_select(msa: Msa, num_seqs: int, mode: str = "max") -> Msa:
    """`num_seqs` rows by greedy Hamming diversity: row 0 first, then at
    each step the row whose mean distance to the picked rows is largest
    (`mode` "max": the most diverse set) or smallest ("min": the closest
    homologs), the first such row on a tie. Returns the picked rows sorted
    by index; an MSA of at most `num_seqs` rows as it is. Raises
    ValueError for num_seqs < 1."""
    if mode not in ("max", "min"):
        raise ValueError(f"mode={mode!r}: 'max' or 'min'")
    if num_seqs < 1:
        raise ValueError(f"num_seqs={num_seqs}: the query row is always kept")
    if len(msa) <= num_seqs:
        return msa
    arr = np.array([list(seq) for _, seq in msa], dtype="S1").view(np.uint8)
    return [msa[int(i)]
            for i in native.greedy_select_indices(arr, num_seqs, mode)]


def greedy_select_indices_plain(arr: np.ndarray, num_seqs: int,
                                mode: str = "max") -> np.ndarray:
    """`native.greedy_select_indices` in numpy: the picked rows of `arr`
    [rows, cols] uint8, ascending."""
    n = arr.shape[0]
    if num_seqs >= n:
        return np.arange(n, dtype=np.int32)
    pick, taken = ((np.argmax, -np.inf) if mode == "max"
                   else (np.argmin, np.inf))
    selected = [0]
    # running sum of each row's Hamming distances to the picked rows
    dist_sum = np.zeros(n, dtype=np.float64)
    for _ in range(num_seqs - 1):
        dist_sum += (arr != arr[selected[-1]][None, :]).mean(axis=1)
        mean_dist = dist_sum / len(selected)
        mean_dist[selected] = taken
        selected.append(int(pick(mean_dist)))
    return np.array(sorted(selected), np.int32)


def filter_and_create_msa_file_list(filename: str) -> List[str]:
    """The second CSV column of every line that mentions '.a3m' (the MSA
    paths of `{split}_msa.csv`)."""
    out: List[str] = []
    with open(filename) as f:
        for line in f:
            line = line.strip()
            if ".a3m" in line:
                out.append(line.split(",")[1])
    return out
