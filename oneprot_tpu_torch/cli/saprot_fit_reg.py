"""Boosted-regressor downstream probe entry point of the port (counterpart
of the root saprot_fit_reg.py): `cli.saprot_fit_cls` on
`configs/saprot_sweep_xgboost_reg.yaml`, or in flag form with a
regressor.

    python -m oneprot_tpu_torch.cli.saprot_fit_reg emb_dir=<dir> \\
        task_name=ThermoStability
"""

from __future__ import annotations

from oneprot_tpu_torch.cli import saprot_fit_cls


def main(argv=None):
    return saprot_fit_cls.main(argv, regression=True,
                               config_name="saprot_sweep_xgboost_reg.yaml")


if __name__ == "__main__":
    main()
