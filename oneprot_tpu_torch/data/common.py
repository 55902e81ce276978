"""Length bucketing (counterpart of oneprot_tpu/data/common.py:pick_bucket).

Batches are padded up to one of a few bucket lengths, so a server sees a
small fixed set of shapes.
"""

from __future__ import annotations

from typing import Optional, Sequence


def pick_bucket(length: int, buckets: Optional[Sequence[int]],
                max_length: int) -> int:
    """Smallest bucket >= length, else max bucket (inputs then truncate)."""
    cap = max_length
    if not buckets:
        return min(length, cap)
    for b in sorted(buckets):
        if length <= b:
            return min(b, cap)
    return min(sorted(buckets)[-1], cap)
