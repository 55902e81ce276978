"""Gradient-boosted probes on the host (counterpart of
oneprot_tpu/downstream/boosters.py).

`make_classifier` and `make_regressor` return xgboost's model where xgboost
is importable, else sklearn's HistGradientBoosting (the same fit / predict
surface); both are imported when called, and where neither is installed
(the card's host has neither) they raise ImportError naming both. Boosters
run on the host in the JAX package too. `fit_booster` fits on the train
split and reports the test metrics through the port's numpy metrics.

It differs from the JAX package in one way: a multi-label task (EC, GO-*)
raises ValueError naming its type before anything is fitted; the JAX
package fails inside sklearn ("y should be a 1d array").
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from oneprot_tpu_torch.downstream.mlp_probe import (
    TASK_REGISTRY,
    compute_metrics,
)
from oneprot_tpu_torch.utils.loggers import get_pylogger

log = get_pylogger(__name__)

_NEITHER = ("the boosted probes need xgboost or scikit-learn, and neither "
            "is installed here (`pip install xgboost` or `pip install "
            "scikit-learn`); the MLP probe needs neither")


def _hist_gradient_boosting(kind: str):
    try:
        from sklearn import ensemble
    except ImportError as e:
        raise ImportError(_NEITHER) from e
    log.warning("xgboost unavailable; using sklearn HistGradientBoosting")
    return getattr(ensemble, f"HistGradientBoosting{kind}")


def make_classifier(n_estimators: int = 500, max_depth: int = 6,
                    learning_rate: float = 0.1, **kwargs: Any):
    try:
        from xgboost import XGBClassifier

        return XGBClassifier(n_estimators=n_estimators, max_depth=max_depth,
                             learning_rate=learning_rate, **kwargs)
    except ImportError:
        return _hist_gradient_boosting("Classifier")(
            max_iter=n_estimators, max_depth=max_depth,
            learning_rate=learning_rate)


def make_regressor(n_estimators: int = 500, max_depth: int = 6,
                   learning_rate: float = 0.1, **kwargs: Any):
    try:
        from xgboost import XGBRegressor

        return XGBRegressor(n_estimators=n_estimators, max_depth=max_depth,
                            learning_rate=learning_rate, **kwargs)
    except ImportError:
        return _hist_gradient_boosting("Regressor")(
            max_iter=n_estimators, max_depth=max_depth,
            learning_rate=learning_rate)


def fit_booster(train, valid, test, task: str, model=None) -> Dict[str, float]:
    """Fit on the train split, report the test metrics. `valid` is taken
    for the MLP probe's signature and not used (the boosters fit on train
    only)."""
    del valid
    info = TASK_REGISTRY.get(task, {"type": "classification", "output_dim": 2})
    task_type = info["type"]
    if task_type == "multi-label":
        raise ValueError(
            f"fit_booster: task {task!r} is {task_type}; the boosted probes "
            "take one label a row (classification, ppi, regression): fit "
            "the MLP probe instead")
    x_tr, y_tr = train
    x_te, y_te = test
    if model is None:
        model = (make_regressor() if task_type == "regression"
                 else make_classifier())
    if task_type == "regression":
        model.fit(np.asarray(x_tr), np.asarray(y_tr))
        pred = np.asarray(model.predict(x_te))[:, None]
        return compute_metrics("regression", pred, np.asarray(y_te))
    # fit on contiguous codes of the train labels and scatter the
    # probabilities back into the full label space, so that a class the
    # train split lacks does not shift the columns
    y_tr = np.asarray(y_tr)
    y_te = np.asarray(y_te)
    classes, y_enc = np.unique(y_tr, return_inverse=True)
    n_cls = int(max(int(classes.max()), int(y_te.max()))) + 1
    model.fit(np.asarray(x_tr), y_enc)
    logits = np.full((len(y_te), n_cls), -30.0)
    if hasattr(model, "predict_proba"):
        probs = np.asarray(model.predict_proba(x_te))
        logits[:, classes.astype(int)] = np.log(np.clip(probs, 1e-9, 1.0))
    else:
        pred = classes[np.asarray(model.predict(x_te)).astype(int)]
        logits[np.arange(len(pred)), pred.astype(int)] = 0.0
    return compute_metrics("classification", logits, y_te)
