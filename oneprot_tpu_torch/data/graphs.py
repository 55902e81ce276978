"""Host-side residue graphs: structure arrays -> padded dense graph dicts
(counterpart of oneprot_tpu/data/utils/graphs.py), numpy and the port's
host library.

Per residue: the backbone and side-chain atom positions, four side-chain
torsions as [8] sin/cos, phi/psi/omega as [6] cos/sin, and the 21-way
residue vocabulary. The output is a fixed-shape dict: [N_max] node arrays
and [N_max, K] kNN-within-radius neighbour lists with masks, so a batch
is a plain stack and ProNet sees a few shapes only.

`knn_neighbors` runs in the port's host library (`native.knn_neighbors`,
as the JAX package takes its own when that loads): neighbours nearest
first, equal distances to the lower index. `knn_neighbors_plain` is the
JAX package's numpy path, which orders equal distances as argpartition
leaves them; the two agree wherever no two neighbours of a residue lie at
the same distance.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from oneprot_tpu_torch import native

# 21-way residue vocabulary (reference struct_graph_utils.py:29)
RES1INT = {
    "A": 0, "R": 1, "N": 2, "D": 3, "C": 4, "Q": 5, "E": 6, "G": 7, "H": 8,
    "I": 9, "L": 10, "K": 11, "M": 12, "F": 13, "P": 14, "S": 15, "T": 16,
    "W": 17, "Y": 18, "V": 19, "X": 20,
}

# atom-name groups for the four side-chain torsions (struct_graph_utils.py:33-41)
_ATOM_GROUPS = {
    "n": {b"N"},
    "ca": {b"CA"},
    "c": {b"C"},
    "cb": {b"CB"},
    "g": {b"CG", b"SG", b"OG", b"CG1", b"OG1"},
    "d": {b"CD", b"SD", b"CD1", b"OD1", b"ND1"},
    "e": {b"CE", b"NE", b"OE1"},
    "z": {b"CZ", b"NZ"},
    "h": {b"NH1"},
}


def compute_dihedrals(v1: np.ndarray, v2: np.ndarray, v3: np.ndarray) -> np.ndarray:
    """Torsion angle from three consecutive difference vectors
    (struct_graph_utils.py:138-144 formula)."""
    n1 = np.cross(v1, v2)
    n2 = np.cross(v2, v3)
    a = (n1 * n2).sum(-1)
    v2n = np.linalg.norm(v2, axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        b = (np.cross(n1, n2) * v2).sum(-1) / v2n
    b = np.nan_to_num(b)
    return np.nan_to_num(np.arctan2(b, a))


def atom_positions(
    n_res: int,
    atom_names: np.ndarray,
    atom_amino_id: np.ndarray,
    atom_pos: np.ndarray,
) -> Dict[str, np.ndarray]:
    """Per-residue positions for each torsion-relevant atom group; NaN where
    absent. N/C fall back to CA when missing (struct_graph_utils.py:57-59)."""
    names = np.asarray(atom_names, dtype="S")
    _, amino_idx = np.unique(np.asarray(atom_amino_id), return_inverse=True)
    pos = {}
    for key, group in _ATOM_GROUPS.items():
        p = np.full((n_res, 3), np.nan, dtype=np.float64)
        mask = np.isin(names, list(group))
        p[amino_idx[mask]] = atom_pos[mask]
        pos[key] = p
    ca = pos["ca"]
    for key in ("n", "c"):
        missing = np.isnan(pos[key])
        pos[key][missing] = ca[missing]
    return pos


def side_chain_embeddings(pos: Dict[str, np.ndarray]) -> np.ndarray:
    """Four side-chain torsions -> [N, 8] sin/cos (struct_graph_utils.py:88-105)."""
    v1 = pos["ca"] - pos["n"]
    v2 = pos["cb"] - pos["ca"]
    v3 = pos["g"] - pos["cb"]
    v4 = pos["d"] - pos["g"]
    v5 = pos["e"] - pos["d"]
    v6 = pos["z"] - pos["e"]
    angles = np.stack([
        compute_dihedrals(v1, v2, v3),
        compute_dihedrals(v2, v3, v4),
        compute_dihedrals(v3, v4, v5),
        compute_dihedrals(v4, v5, v6),
    ], axis=1)
    emb = np.concatenate([np.sin(angles), np.cos(angles)], axis=1)
    return np.nan_to_num(emb).astype(np.float32)


def backbone_embeddings(pos_n: np.ndarray, pos_ca: np.ndarray,
                        pos_c: np.ndarray) -> np.ndarray:
    """phi/psi/omega -> [N, 6] cos/sin (struct_graph_utils.py:114-135;
    Ingraham et al. NeurIPS'19 featurization)."""
    n_res = pos_ca.shape[0]
    X = np.stack([pos_n, pos_ca, pos_c], axis=1).reshape(3 * n_res, 3)
    dX = X[1:] - X[:-1]
    norms = np.linalg.norm(dX, axis=-1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        U = np.nan_to_num(dX / norms)
    u0, u1, u2 = U[:-2], U[1:-1], U[2:]
    angle = compute_dihedrals(u0, u1, u2)
    angle = np.pad(angle, (1, 2))  # phi[0], psi[-1], omega[-1] := 0
    angle = angle.reshape(-1, 3)
    emb = np.concatenate([np.cos(angle), np.sin(angle)], axis=1)
    return np.nan_to_num(emb).astype(np.float32)


def knn_neighbors(
    coords: np.ndarray,          # [N, 3]
    k: int,
    cutoff: float = 10.0,
) -> tuple:
    """k nearest neighbors within `cutoff` Angstrom (self excluded).

    Returns (idx [N, k], mask [N, k]). The reference's ProNet uses a radius
    graph with unbounded degree; capping at k with a distance sort keeps the
    TPU shapes static while retaining the closest (most informative) edges.
    Runs in the host library; a chain of 0 or 1 residues has no neighbour
    (an empty chain: e.g. an HDF5 entry with an empty seq1).
    """
    n = coords.shape[0]
    if n < 2:
        return np.zeros((n, k), np.int32), np.zeros((n, k), bool)
    return native.knn_neighbors(coords, k, cutoff)


def knn_neighbors_plain(coords: np.ndarray, k: int,
                        cutoff: float = 10.0) -> tuple:
    """`knn_neighbors` in numpy (the JAX package's numpy path): equal
    distances in argpartition's order, not by index."""
    n = coords.shape[0]
    if n == 0:
        return (np.zeros((0, k), np.int32), np.zeros((0, k), bool))
    d2 = ((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    k_eff = min(k, max(n - 1, 1))
    idx = np.argpartition(d2, kth=k_eff - 1, axis=1)[:, :k_eff]
    rows = np.arange(n)[:, None]
    order = np.argsort(d2[rows, idx], axis=1)
    idx = idx[rows, order]
    mask = d2[rows, idx] <= cutoff * cutoff
    if k_eff < k:
        pad = k - k_eff
        idx = np.concatenate([idx, np.zeros((n, pad), idx.dtype)], axis=1)
        mask = np.concatenate([mask, np.zeros((n, pad), bool)], axis=1)
    return idx.astype(np.int32), mask


def protein_to_padded_graph(
    sequence: str,
    atom_names: np.ndarray,
    atom_amino_id: np.ndarray,
    atom_pos: np.ndarray,
    max_residues: int,
    max_neighbors: int = 24,
    cutoff: float = 10.0,
) -> Dict[str, np.ndarray]:
    """Build one padded graph dict (the ProNet input contract, padded)."""
    aa = np.array([RES1INT.get(c, 20) for c in sequence], np.int32)
    n_res = len(aa)
    pos = atom_positions(n_res, atom_names, atom_amino_id, atom_pos)
    sc = side_chain_embeddings(pos)
    bb = backbone_embeddings(pos["n"], pos["ca"], pos["c"])
    coords_ca = np.nan_to_num(pos["ca"]).astype(np.float32)
    coords_n = np.nan_to_num(pos["n"]).astype(np.float32)
    coords_c = np.nan_to_num(pos["c"]).astype(np.float32)

    n_keep = min(n_res, max_residues)
    idx, nmask = knn_neighbors(coords_ca[:n_keep], max_neighbors, cutoff)

    def pad2(x, fill=0.0):
        out = np.full((max_residues,) + x.shape[1:], fill, x.dtype)
        out[:n_keep] = x[:n_keep]
        return out

    graph = {
        "aa": pad2(aa),
        "coords_ca": pad2(coords_ca),
        "coords_n": pad2(coords_n),
        "coords_c": pad2(coords_c),
        "bb_embs": pad2(bb),
        "side_chain_embs": pad2(sc),
        "node_mask": pad2(np.ones(n_keep, np.float32)),
        "neighbor_idx": pad2(idx),
        "neighbor_mask": pad2(nmask.astype(np.float32)),
    }
    return graph


def stack_graphs(graphs: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Batch padded graphs: the TPU equivalent of Batch.from_data_list
    (reference struct_graph_dataset.py:57) — a plain leading-dim stack."""
    return {k: np.stack([g[k] for g in graphs], axis=0) for k in graphs[0]}


def augment_graph_batch(
    batch: Dict[str, np.ndarray],
    rng: np.random.RandomState,
    use_mask: bool = True,
    use_coord_noise: bool = True,
    use_deform: bool = True,
) -> Dict[str, np.ndarray]:
    """Reference train-time augmentations (struct_graph_dataset.py:59-77):
    random residue-type masking to token 20, clipped N(0, 0.1) coordinate
    noise in [-0.3, 0.3], anisotropic deform scale clipped to [0.9, 1.1]."""
    out = dict(batch)
    node_mask = batch["node_mask"].astype(bool)
    B = batch["aa"].shape[0]
    if use_mask:
        # per-SAMPLE mask ratio (the reference draws one per protein in
        # __getitem__; one per batch correlated the augmentation strength
        # across all proteins in the batch)
        mask_ratio = rng.uniform(0, 1, (B, 1))
        flip = (rng.uniform(size=batch["aa"].shape) < mask_ratio) & node_mask
        aa = batch["aa"].copy()
        aa[flip] = 20
        out["aa"] = aa
    # ONE deform per protein, shared by CA/N/C: independent draws per
    # coordinate array distorted the N-CA / C-CA vectors inconsistently,
    # corrupting the backbone frames far beyond the intended single
    # anisotropic deformation (review finding, round 5)
    deform = np.clip(rng.normal(1.0, 0.1, (B, 1, 3)), 0.9, 1.1)
    for key in ("coords_ca", "coords_n", "coords_c"):
        coords = out[key]
        if use_coord_noise:
            noise = np.clip(rng.normal(0.0, 0.1, coords.shape), -0.3, 0.3)
            coords = coords + noise.astype(coords.dtype)
        if use_deform:
            coords = coords * deform.astype(coords.dtype)
        out[key] = coords
    return out
