"""Hyperparameter search sweepers for multirun: grid, random and TPE
(counterpart of oneprot_tpu/core/sweep.py, which is numpy only; given the
same seed each proposes the same trials).

    sweeper = make_sweeper("optuna", {"model.optimizer.lr":
                                      "tag(log, interval(0.0001, 0.01))"},
                           n_trials=4, seed=0)
    while (trial := sweeper.ask()) is not None:
        sweeper.tell(trial, objective(trial))

The `hydra/sweeper=optuna` + `hydra.sweeper.params.key=<space>` surface of
the reference, without optuna. Spaces:
  - ``interval(a, b)``            float uniform
  - ``tag(log, interval(a, b))``  log-uniform
  - ``int(interval(a, b))``       integer uniform
  - ``range(a, b[, step])``       integer choices
  - ``choice(x, y, z)``           categorical
  - ``x,y,z``                     categorical (plain comma list)

TPE (Bergstra et al. 2011): after a random warmup, observations split into
good and bad by objective quantile; candidates are drawn from a KDE over
the good group and ranked by the good/bad density ratio.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["parse_space", "GridSweeper", "RandomSweeper", "TPESweeper",
           "make_sweeper"]


# ---------------------------------------------------------------------------
# Space parsing
# ---------------------------------------------------------------------------


class Space:
    kind: str  # "float" | "int" | "cat"

    def __init__(self, kind: str, low=None, high=None, log=False,
                 choices: Optional[Sequence[Any]] = None):
        self.kind = kind
        self.low = low
        self.high = high
        self.log = log
        self.choices = list(choices) if choices is not None else None

    def sample(self, rng: np.random.RandomState) -> Any:
        if self.kind == "cat":
            return self.choices[rng.randint(len(self.choices))]
        if self.log:
            return float(np.exp(rng.uniform(np.log(self.low),
                                            np.log(self.high))))
        x = rng.uniform(self.low, self.high)
        return int(round(x)) if self.kind == "int" else float(x)

    def clip(self, x: float) -> Any:
        x = min(max(x, self.low), self.high)
        return int(round(x)) if self.kind == "int" else float(x)


def _parse_number(tok: str) -> Any:
    try:
        return int(tok)
    except ValueError:
        try:
            return float(tok)
        except ValueError:
            return tok.strip().strip("'\"")


def parse_space(spec: str) -> Space:
    s = str(spec).strip()
    m = re.fullmatch(r"tag\(\s*log\s*,\s*interval\(([^)]*)\)\s*\)", s)
    if m:
        lo, hi = (_parse_number(t) for t in m.group(1).split(","))
        return Space("float", float(lo), float(hi), log=True)
    m = re.fullmatch(r"int\(\s*interval\(([^)]*)\)\s*\)", s)
    if m:
        lo, hi = (_parse_number(t) for t in m.group(1).split(","))
        return Space("int", int(lo), int(hi))
    m = re.fullmatch(r"interval\(([^)]*)\)", s)
    if m:
        lo, hi = (_parse_number(t) for t in m.group(1).split(","))
        return Space("float", float(lo), float(hi))
    m = re.fullmatch(r"range\(([^)]*)\)", s)
    if m:
        parts = [int(_parse_number(t)) for t in m.group(1).split(",")]
        lo, hi = parts[0], parts[1]
        step = parts[2] if len(parts) > 2 else 1
        return Space("cat", choices=list(range(lo, hi, step)))
    m = re.fullmatch(r"choice\((.*)\)", s)
    if m:
        return Space("cat",
                     choices=[_parse_number(t) for t in m.group(1).split(",")])
    if "," in s:
        return Space("cat", choices=[_parse_number(t) for t in s.split(",")])
    return Space("cat", choices=[_parse_number(s)])


# ---------------------------------------------------------------------------
# Sweepers (ask/tell)
# ---------------------------------------------------------------------------


class GridSweeper:
    """Cartesian product of categorical spaces (hydra basic sweeper)."""

    def __init__(self, params: Dict[str, str], **_):
        import itertools

        spaces = {k: parse_space(v) for k, v in params.items()}
        for k, sp in spaces.items():
            if sp.kind != "cat":
                raise ValueError(
                    f"grid sweeper needs finite choices for {k}; use the "
                    f"random/tpe sweeper for interval() spaces")
        keys = list(spaces.keys())
        self._trials = [dict(zip(keys, combo)) for combo in
                        itertools.product(*(spaces[k].choices for k in keys))]
        self._i = 0

    @property
    def n_trials(self) -> int:
        return len(self._trials)

    def ask(self) -> Optional[Dict[str, Any]]:
        if self._i >= len(self._trials):
            return None
        t = self._trials[self._i]
        self._i += 1
        return t

    def tell(self, params: Dict[str, Any], value: float) -> None:
        pass


class RandomSweeper:
    def __init__(self, params: Dict[str, str], n_trials: int = 10,
                 seed: int = 0, **_):
        self.spaces = {k: parse_space(v) for k, v in params.items()}
        self.n_trials = int(n_trials)
        self.rng = np.random.RandomState(seed)
        self._asked = 0

    def ask(self) -> Optional[Dict[str, Any]]:
        if self._asked >= self.n_trials:
            return None
        self._asked += 1
        return {k: sp.sample(self.rng) for k, sp in self.spaces.items()}

    def tell(self, params: Dict[str, Any], value: float) -> None:
        pass


class TPESweeper:
    """Tree-structured Parzen Estimator (minimization)."""

    def __init__(self, params: Dict[str, str], n_trials: int = 10,
                 seed: int = 0, n_startup_trials: int = 4, gamma: float = 0.25,
                 n_candidates: int = 24, direction: str = "minimize", **_):
        self.spaces = {k: parse_space(v) for k, v in params.items()}
        self.n_trials = int(n_trials)
        self.n_startup = int(n_startup_trials)
        self.gamma = float(gamma)
        self.n_candidates = int(n_candidates)
        self.sign = 1.0 if direction == "minimize" else -1.0
        self.rng = np.random.RandomState(seed)
        self.history: List[Tuple[Dict[str, Any], float]] = []
        self._asked = 0

    def ask(self) -> Optional[Dict[str, Any]]:
        if self._asked >= self.n_trials:
            return None
        self._asked += 1
        if len(self.history) < self.n_startup:
            return {k: sp.sample(self.rng) for k, sp in self.spaces.items()}
        return self._suggest()

    def tell(self, params: Dict[str, Any], value: float) -> None:
        if value is not None and math.isfinite(value):
            self.history.append((params, self.sign * float(value)))

    # -- TPE internals ----------------------------------------------------

    def _split(self):
        values = np.array([v for _, v in self.history])
        order = np.argsort(values)
        n_good = max(1, int(np.ceil(self.gamma * len(values))))
        good = [self.history[i][0] for i in order[:n_good]]
        bad = [self.history[i][0] for i in order[n_good:]] or good
        return good, bad

    def _kde_logpdf(self, xs: np.ndarray, obs: np.ndarray, lo, hi, log):
        if log:
            xs, obs = np.log(xs), np.log(obs)
            lo, hi = np.log(lo), np.log(hi)
        bw = max((hi - lo) / max(len(obs), 1) * 2.0, 1e-8 * (hi - lo + 1e-12))
        diff = (xs[:, None] - obs[None, :]) / bw
        return np.log(np.mean(np.exp(-0.5 * diff ** 2), axis=1) + 1e-12)

    def _suggest(self) -> Dict[str, Any]:
        good, bad = self._split()
        out: Dict[str, Any] = {}
        for k, sp in self.spaces.items():
            if sp.kind == "cat":
                counts = np.ones(len(sp.choices))
                for g in good:
                    counts[sp.choices.index(g[k])] += 1.0
                out[k] = sp.choices[int(np.argmax(
                    np.log(counts / counts.sum())
                    + self.rng.gumbel(size=len(counts)) * 0.2))]
                continue
            g_obs = np.array([float(g[k]) for g in good])
            b_obs = np.array([float(b[k]) for b in bad])
            if sp.log:
                cands = np.exp(self.rng.uniform(
                    np.log(sp.low), np.log(sp.high), self.n_candidates))
                cands = np.concatenate([cands, g_obs])
            else:
                cands = self.rng.uniform(sp.low, sp.high, self.n_candidates)
                cands = np.concatenate([cands, g_obs])
            lg = self._kde_logpdf(cands, g_obs, sp.low, sp.high, sp.log)
            lb = self._kde_logpdf(cands, b_obs, sp.low, sp.high, sp.log)
            out[k] = sp.clip(cands[int(np.argmax(lg - lb))])
        return out


def make_sweeper(name: str, params: Dict[str, str], **kwargs):
    name = (name or "basic").lower()
    if name in ("basic", "grid"):
        return GridSweeper(params, **kwargs)
    if name in ("random",):
        return RandomSweeper(params, **kwargs)
    if name in ("optuna", "tpe"):
        return TPESweeper(params, **kwargs)
    raise ValueError(f"unknown sweeper {name!r} "
                     f"(expected basic|grid|random|optuna|tpe)")
