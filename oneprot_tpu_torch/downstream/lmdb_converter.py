"""SaProt LMDB -> CSV converter (counterpart of
oneprot_tpu/downstream/lmdb_converter.py).

Walks a folder tree of LMDB downstream datasets (`data.mdb`), flattens the
directory names and writes the classification, regression or ppi CSV
schema. `lmdb` is imported when a dataset is converted (a host tool; the
card's host does not have it).
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, List, Optional

from oneprot_tpu_torch.utils.loggers import get_pylogger

log = get_pylogger(__name__)

SCHEMAS = {
    "classification": ["id", "sequence", "label/fitness"],
    "regression": ["id", "sequence", "label/fitness"],
    "ppi": ["id", "sequence_1", "sequence_2", "label/fitness"],
}


def convert_lmdb_to_csv(lmdb_dir: str, output_csv: str,
                        schema: str = "classification") -> int:
    """Convert one LMDB dataset directory to a CSV; returns the rows."""
    try:
        import lmdb
    except ImportError as e:
        raise ImportError(
            "lmdb is not installed; the converter is a host-side tool — "
            "run it in an environment with `pip install lmdb`") from e

    columns = SCHEMAS[schema]
    env = lmdb.open(lmdb_dir, readonly=True, lock=False)
    rows = 0
    with env.begin() as txn, open(output_csv, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(columns)
        length = txn.get(b"length")
        n = int(length.decode()) if length else None
        for key, value in txn.cursor():
            if key == b"length":
                continue
            try:
                entry = json.loads(value.decode())
            except (UnicodeDecodeError, json.JSONDecodeError):
                continue
            label = entry.get("label", entry.get("fitness", ""))
            if schema == "ppi":
                writer.writerow([key.decode(), entry.get("seq_1", ""),
                                 entry.get("seq_2", ""), label])
            else:
                writer.writerow([key.decode(),
                                 entry.get("seq", entry.get("sequence", "")),
                                 label])
            rows += 1
            if n is not None and rows >= n:
                break
    log.info(f"{lmdb_dir} -> {output_csv} ({rows} rows)")
    return rows


def convert_tree(root_dir: str, output_dir: str,
                 schema_map: Optional[Dict[str, str]] = None) -> List[str]:
    """Convert every directory under `root_dir` that holds a data.mdb to
    `<path components joined by _>.csv` in `output_dir`; the schema is the
    last of `schema_map`'s patterns the name contains, else
    classification."""
    os.makedirs(output_dir, exist_ok=True)
    outputs = []
    for dirpath, _, filenames in os.walk(root_dir):
        if "data.mdb" not in filenames:
            continue
        flat = os.path.relpath(dirpath, root_dir).replace(os.sep, "_")
        schema = "classification"
        for pattern, s in (schema_map or {}).items():
            if pattern in flat:
                schema = s
        out_csv = os.path.join(output_dir, f"{flat}.csv")
        convert_lmdb_to_csv(dirpath, out_csv, schema)
        outputs.append(out_csv)
    return outputs
