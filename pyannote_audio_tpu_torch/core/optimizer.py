"""Hyperparameter optimization: a TPE sampler with a resumable journal.

Counterpart of pyannote_audio_tpu/core/optimizer.py, which stands in for
the reference's ``pyannote.pipeline`` Optimizer (an Optuna TPE study with
journal storage, warm start and resume), as the CLI's ``optimize`` uses
it. The sampler is a univariate Tree-structured Parzen Estimator: past
trials split into a "good" quantile and the rest, each hyperparameter
gets a Parzen-window density for both sets (truncated Gaussians for
numeric parameters, smoothed counts for categorical ones), and the next
value maximizes the density ratio l(x)/g(x) over candidates drawn from
l; startup trials are random. It draws from ``random.Random(seed)`` and
``np.random.default_rng(seed)`` in the JAX package's order, so one seed
and one objective give the same suggestions in both packages, and the
JSONL journal (one ``{"trial", "params", "objective"}`` line per trial)
is the same, so each package resumes the other's. Plain numpy on the
host: the objective (a pipeline pass over a protocol) dominates.
"""

from __future__ import annotations

import json
import math
import random
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from .parameter import (Categorical, Frozen, Integer, LogUniform, ParamDict,
                        Parameter)


def flatten_space(space: Dict[str, Any], prefix: str = ""
                  ) -> Dict[str, Parameter]:
    """Flatten nested ParamDicts to dotted names -> leaf Parameter."""
    flat: Dict[str, Parameter] = {}
    for name, p in space.items():
        full = f"{prefix}{name}"
        if isinstance(p, ParamDict):
            flat.update(flatten_space(p, prefix=f"{full}."))
        elif isinstance(p, Frozen):
            continue
        elif isinstance(p, Parameter):
            flat[full] = p
    return flat


def unflatten_params(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Dotted names -> nested dict (the shape Pipeline.instantiate takes)."""
    nested: Dict[str, Any] = {}
    for name, value in flat.items():
        node = nested
        parts = name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return nested


def flatten_params(nested: Dict[str, Any], prefix: str = ""
                   ) -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for name, value in nested.items():
        full = f"{prefix}{name}"
        if isinstance(value, dict):
            flat.update(flatten_params(value, prefix=f"{full}."))
        else:
            flat[full] = value
    return flat


class RandomSampler:
    """Uniform-at-random baseline sampler."""

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)

    def suggest(self, space: Dict[str, Parameter],
                history: List[Tuple[Dict[str, Any], float]]
                ) -> Dict[str, Any]:
        return {name: p.sample(self.rng) for name, p in space.items()}


class TPESampler:
    """Univariate TPE (Bergstra et al. 2011), Optuna-flavored defaults."""

    def __init__(self, seed: int = 0, n_startup_trials: int = 10,
                 n_candidates: int = 24, gamma_ratio: float = 0.25,
                 max_good: int = 25):
        self.rng = random.Random(seed)
        self.np_rng = np.random.default_rng(seed)
        self.n_startup_trials = n_startup_trials
        self.n_candidates = n_candidates
        self.gamma_ratio = gamma_ratio
        self.max_good = max_good

    # -- parzen machinery ----------------------------------------------------

    @staticmethod
    def _transform(p: Parameter, values: np.ndarray) -> np.ndarray:
        if isinstance(p, LogUniform):
            return np.log(values)
        return values.astype(np.float64)

    @staticmethod
    def _bounds(p: Parameter) -> Tuple[float, float]:
        if isinstance(p, LogUniform):
            return math.log(p.low), math.log(p.high)
        if isinstance(p, Integer):
            return float(p.low) - 0.5, float(p.high) + 0.5
        return float(p.low), float(p.high)

    def _parzen(self, obs: np.ndarray, lo: float, hi: float):
        """(means, sigmas, weights) of a Gaussian mixture + uniform prior.

        Bandwidths follow the neighbor-distance heuristic with a magic
        clip to [(hi-lo)/min(100, n+1), hi-lo].
        """
        n = len(obs)
        order = np.argsort(obs)
        sorted_obs = obs[order]
        padded = np.concatenate([[lo], sorted_obs, [hi]])
        left = padded[1:-1] - padded[:-2]
        right = padded[2:] - padded[1:-1]
        sigma = np.maximum(left, right)
        width = hi - lo
        sigma = np.clip(sigma, width / min(100.0, n + 1.0), width)
        means = np.concatenate([sorted_obs, [0.5 * (lo + hi)]])
        sigmas = np.concatenate([sigma, [width]])  # prior ~ flat gaussian
        weights = np.full(n + 1, 1.0 / (n + 1))
        return means, sigmas, weights

    @staticmethod
    def _log_pdf(x: np.ndarray, means, sigmas, weights) -> np.ndarray:
        z = (x[:, None] - means[None, :]) / sigmas[None, :]
        log_comp = (-0.5 * z * z - np.log(sigmas[None, :])
                    - 0.5 * math.log(2 * math.pi) + np.log(weights[None, :]))
        m = log_comp.max(axis=1, keepdims=True)
        return (m[:, 0] + np.log(np.exp(log_comp - m).sum(axis=1)))

    def _suggest_numeric(self, p: Parameter, good: np.ndarray,
                         bad: np.ndarray) -> float:
        lo, hi = self._bounds(p)
        gm = self._parzen(self._transform(p, good), lo, hi)
        bm = self._parzen(self._transform(p, bad), lo, hi)
        # candidates from the good mixture
        comp = self.np_rng.integers(0, len(gm[0]), size=self.n_candidates)
        cand = gm[0][comp] + gm[1][comp] * self.np_rng.standard_normal(
            self.n_candidates)
        cand = np.clip(cand, lo, hi)
        score = self._log_pdf(cand, *gm) - self._log_pdf(cand, *bm)
        best = float(cand[int(np.argmax(score))])
        if isinstance(p, LogUniform):
            return float(np.clip(math.exp(best), p.low, p.high))
        if isinstance(p, Integer):
            return int(np.clip(round(best), p.low, p.high))
        return float(np.clip(best, p.low, p.high))

    def _suggest_categorical(self, p: Categorical, good: List[Any],
                             bad: List[Any]) -> Any:
        def probs(values):
            counts = np.array([1.0 + sum(v == c for v in values)
                               for c in p.choices])
            return counts / counts.sum()
        pg, pb = probs(good), probs(bad)
        # candidates from a pg/uniform mixture: pure pg collapses onto the
        # incumbent category once rival trials age out of the good set,
        # never exploring again; the uniform floor keeps every category
        # reachable
        mix = 0.75 * pg + 0.25 / len(p.choices)
        idx = self.np_rng.choice(len(p.choices), size=self.n_candidates,
                                 p=mix / mix.sum())
        score = np.log(pg[idx]) - np.log(pb[idx])
        return p.choices[int(idx[int(np.argmax(score))])]

    # -- public --------------------------------------------------------------

    def suggest(self, space: Dict[str, Parameter],
                history: List[Tuple[Dict[str, Any], float]]
                ) -> Dict[str, Any]:
        complete = [(params, obj) for params, obj in history
                    if obj is not None and math.isfinite(obj)]
        if len(complete) < self.n_startup_trials:
            return {name: p.sample(self.rng) for name, p in space.items()}
        complete.sort(key=lambda t: t[1])
        n_good = max(1, min(self.max_good,
                            int(math.ceil(self.gamma_ratio
                                          * len(complete)))))
        good_trials = complete[:n_good]
        bad_trials = complete[n_good:] or complete[-1:]
        out: Dict[str, Any] = {}
        for name, p in space.items():
            good = [t[0][name] for t in good_trials if name in t[0]]
            bad = [t[0][name] for t in bad_trials if name in t[0]]
            if not good or not bad:
                out[name] = p.sample(self.rng)
            elif isinstance(p, Categorical):
                out[name] = self._suggest_categorical(p, good, bad)
            else:
                out[name] = self._suggest_numeric(
                    p, np.asarray(good, np.float64),
                    np.asarray(bad, np.float64))
        return out


class Optimizer:
    """TPE study over a pipeline's declared parameters, with a resumable
    JSONL journal (one line per trial: {"trial", "params", "objective"}).
    """

    def __init__(self, space: Dict[str, Parameter],
                 journal: Optional[Path] = None,
                 sampler: Optional[TPESampler] = None,
                 warm_start: Optional[Dict[str, Any]] = None):
        self.space = flatten_space(space)
        self.journal = Path(journal) if journal is not None else None
        self.sampler = sampler or TPESampler()
        self.warm_start = flatten_params(warm_start) if warm_start else None
        self.history: List[Tuple[Dict[str, Any], float]] = []
        if self.journal is not None and self.journal.exists():
            for line in self.journal.read_text().splitlines():
                trial = json.loads(line)
                self.history.append((flatten_params(trial["params"]),
                                     trial["objective"]))

    @property
    def best(self) -> Tuple[Optional[Dict[str, Any]], float]:
        """(nested best params, best objective)."""
        best_params, best_obj = None, float("inf")
        for params, obj in self.history:
            if obj is not None and obj < best_obj:
                best_params, best_obj = unflatten_params(params), obj
        return best_params, best_obj

    def suggestions(self, n_trials: int) -> Iterator[Dict[str, Any]]:
        """Yield up to ``n_trials`` nested parameter dicts to evaluate.

        The caller must ``tell`` each objective back before requesting the
        next suggestion. Trial 0 of a fresh study replays the warm start
        (the pipeline's current/default parameters), matching the
        reference's warm_start behavior (__main__.py:238-247).
        """
        for _ in range(n_trials):
            if not self.history and self.warm_start is not None:
                flat = {name: self.warm_start[name]
                        for name, p in self.space.items()
                        if name in self.warm_start
                        and self.warm_start[name] in p}
                if len(flat) != len(self.space):
                    flat = self.sampler.suggest(self.space, self.history)
            else:
                flat = self.sampler.suggest(self.space, self.history)
            yield unflatten_params(flat)

    def tell(self, params: Dict[str, Any], objective: float) -> None:
        flat = flatten_params(params)
        self.history.append((flat, objective))
        if self.journal is not None:
            self.journal.parent.mkdir(parents=True, exist_ok=True)
            with open(self.journal, "a") as f:
                f.write(json.dumps({"trial": len(self.history) - 1,
                                    "params": params,
                                    "objective": objective}) + "\n")

    def optimize(self, objective_fn: Callable[[Dict[str, Any]], float],
                 n_trials: int) -> Tuple[Optional[Dict[str, Any]], float]:
        for params in self.suggestions(n_trials):
            self.tell(params, float(objective_fn(params)))
        return self.best
