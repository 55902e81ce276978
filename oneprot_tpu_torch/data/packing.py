"""Sequence packing: several proteins back to back in one fixed-length row
(counterpart of oneprot_tpu/data/packing.py: `pack_lengths`,
`pack_token_rows`, `pack_stream`; numpy only).

Attention stays per protein through segment ids (padding takes -1), pooling
is per segment (`models.heads.segment_mean_pool`) and the contrastive loss
runs over the per-protein features with empty slots masked
(`losses.clip.clip_loss_masked`).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def pack_lengths(lengths: Sequence[int], row_len: int,
                 max_per_row: int) -> List[List[int]]:
    """First-fit-decreasing bin packing of protein indices into rows.

    Returns a list of rows, each a list of indices into `lengths`, such
    that each row's total length <= row_len and holds <= max_per_row items.
    Deterministic for a fixed input order.
    """
    order = np.argsort(np.asarray(lengths))[::-1]  # longest first
    rows: List[List[int]] = []
    room: List[int] = []
    for idx in order:
        li = int(lengths[idx])
        if li > row_len:
            raise ValueError(f"length {li} exceeds row_len {row_len}")
        placed = False
        for r, rem in enumerate(room):
            if rem >= li and len(rows[r]) < max_per_row:
                rows[r].append(int(idx))
                room[r] -= li
                placed = True
                break
        if not placed:
            rows.append([int(idx)])
            room.append(row_len - li)
    return rows


def pack_token_rows(
    token_lists: Sequence[np.ndarray], row_len: int, max_per_row: int,
    pad_id: int = 1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[List[int]]]:
    """Pack tokenized proteins (already incl. their cls/eos specials) into
    [R, row_len] rows.

    Returns (ids [R, L], segment_ids [R, L] int32 with -1 on padding,
    valid [R, max_per_row] 1 where a slot holds a protein, rows
    [R][slot] -> original protein index). Slot s of row r corresponds to
    flattened feature row r * max_per_row + s after packed encoding.
    """
    lengths = [len(t) for t in token_lists]
    rows = pack_lengths(lengths, row_len, max_per_row)
    R = len(rows)
    ids = np.full((R, row_len), pad_id, np.int32)
    seg = np.full((R, row_len), -1, np.int32)
    valid = np.zeros((R, max_per_row), np.float32)
    for r, members in enumerate(rows):
        off = 0
        for s, idx in enumerate(members):
            t = np.asarray(token_lists[idx], np.int32)
            ids[r, off:off + len(t)] = t
            seg[r, off:off + len(t)] = s
            valid[r, s] = 1.0
            off += len(t)
    return ids, seg, valid, rows


def pack_stream(items, row_len: int, rows: int, max_per_row: int,
                pad_id: int = 1):
    """Pack a STREAM of token pairs into batches with a FIXED row count.

    `items` yields (tokens_a, tokens_b), each protein's two tokenized sides.
    Rows fill first-fit by the longer side, so both sides share (row, slot)
    assignments; when an item fits nowhere the batch is finished and a
    fresh one starts with it. Yields dicts: ids_a, seg_a, ids_b, seg_b
    [rows, row_len] int32 (segment -1 on padding), valid [rows,
    max_per_row] f32, n_pairs.
    """

    def new_state():
        return [[] for _ in range(rows)], [row_len] * rows

    def finalize(members):
        ids_a = np.full((rows, row_len), pad_id, np.int32)
        ids_b = np.full((rows, row_len), pad_id, np.int32)
        seg_a = np.full((rows, row_len), -1, np.int32)
        seg_b = np.full((rows, row_len), -1, np.int32)
        valid = np.zeros((rows, max_per_row), np.float32)
        n = 0
        for r, row_items in enumerate(members):
            off_a = off_b = 0
            for s, (ta, tb) in enumerate(row_items):
                ids_a[r, off_a:off_a + len(ta)] = ta
                seg_a[r, off_a:off_a + len(ta)] = s
                ids_b[r, off_b:off_b + len(tb)] = tb
                seg_b[r, off_b:off_b + len(tb)] = s
                valid[r, s] = 1.0
                off_a += len(ta)
                off_b += len(tb)
                n += 1
        return {"ids_a": ids_a, "seg_a": seg_a, "ids_b": ids_b,
                "seg_b": seg_b, "valid": valid, "n_pairs": n}

    members, room = new_state()
    for ta, tb in items:
        need = max(len(ta), len(tb))
        if need > row_len:
            raise ValueError(f"item length {need} exceeds row_len {row_len}")
        for r in range(rows):
            if room[r] >= need and len(members[r]) < max_per_row:
                members[r].append((ta, tb))
                room[r] -= need
                break
        else:
            yield finalize(members)
            members, room = new_state()
            members[0].append((ta, tb))
            room[0] -= need
    if any(members):
        yield finalize(members)
