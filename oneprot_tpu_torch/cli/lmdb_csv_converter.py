"""LMDB -> CSV converter entry point of the port (counterpart of the root
lmdb_csv_converter.py); needs the `lmdb` package.

    python -m oneprot_tpu_torch.cli.lmdb_csv_converter --root-dir <lmdb tree> \\
        --output-dir <csv dir>
"""

from __future__ import annotations

import argparse

from oneprot_tpu_torch.downstream.lmdb_converter import convert_tree


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--ppi-pattern", default="HumanPPI",
                   help="dirs containing this pattern use the ppi schema")
    p.add_argument("--regression-pattern", default="Thermo",
                   help="dirs containing this pattern use the regression schema")
    args = p.parse_args(argv)
    return convert_tree(args.root_dir, args.output_dir, schema_map={
        args.ppi_pattern: "ppi",
        args.regression_pattern: "regression",
    })


if __name__ == "__main__":
    print("\n".join(main()))
