"""Searcher plugin interface + built-in implementations.

The port of ``ray_tpu/tune/searcher.py``, copied. Role-equivalent to the
reference's Searcher ABC (reference:
python/ray/tune/search/searcher.py — the seam Optuna/HyperOpt/BOHB
plugins implement: ``suggest(trial_id)`` proposes a config,
``on_trial_complete`` feeds the result back). The built-ins cover the
non-plugin reference searchers: BasicVariantSearcher replays
grid/random variant generation through the seam, and HyperOptLikeSearcher
is a dependency-free sequential model-based searcher (TPE-flavored:
sample candidates, prefer the neighborhood of the best observed trials)
demonstrating that sequential-feedback searchers work end to end.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional

from ray_tpu_torch.tune.search import (Categorical, Domain, Float, GridSearch,
                                 Integer, generate_variants)


class Searcher:
    """Plugin ABC. ``set_search_properties`` is called once by the Tuner
    with (metric, mode, param_space); then ``suggest`` / ``on_trial_complete``
    alternate (suggestions may arrive in concurrent batches)."""

    def set_search_properties(self, metric: str, mode: str,
                              param_space: Dict[str, Any]) -> None:
        self.metric = metric
        self.mode = mode
        self.param_space = param_space

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        """Next config to try; None = the searcher is exhausted."""
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]]) -> None:
        """Feedback for a finished trial (None result = errored)."""


class BasicVariantSearcher(Searcher):
    """Grid/random expansion served through the Searcher seam (reference:
    search/basic_variant.py BasicVariantGenerator)."""

    def __init__(self, num_samples: int = 1, seed: Optional[int] = None):
        self._num_samples = num_samples
        self._seed = seed
        self._queue: Optional[List[Dict[str, Any]]] = None

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._queue is None:
            self._queue = list(generate_variants(
                self.param_space, self._num_samples, seed=self._seed))
        return self._queue.pop(0) if self._queue else None


class HyperOptLikeSearcher(Searcher):
    """Sequential model-based search without external deps: after a
    warmup of uniform samples, candidates are drawn and scored by
    proximity to the best-performing observed configs (a TPE-shaped
    heuristic standing in for the reference's Optuna/HyperOpt plugins —
    the seam, feedback loop, and numeric handling are identical)."""

    def set_search_properties(self, metric: str, mode: str,
                              param_space: Dict[str, Any]) -> None:
        super().set_search_properties(metric, mode, param_space)
        grids = [k for k, v in param_space.items()
                 if isinstance(v, GridSearch)
                 or (isinstance(v, dict) and "grid_search" in v)]
        if grids:
            # passing a grid marker through as a live hyperparameter would
            # silently hand the trainable a spec object
            raise ValueError(
                f"HyperOptLikeSearcher does not support grid_search keys "
                f"{grids}; use BasicVariantSearcher or a Domain")

    def __init__(self, num_samples: int = 16, warmup: int = 5,
                 candidates_per_suggest: int = 16,
                 seed: Optional[int] = None):
        self._budget = num_samples
        self._warmup = warmup
        self._n_cand = candidates_per_suggest
        self._rng = random.Random(seed)
        self._suggested = 0
        self._observed: List[tuple] = []  # (score, config)
        self._pending: Dict[str, Dict[str, Any]] = {}

    # -- internals --

    def _sample_config(self) -> Dict[str, Any]:
        out = {}
        for k, v in self.param_space.items():
            out[k] = v.sample(self._rng) if isinstance(v, Domain) else v
        return out

    def _numeric_keys(self) -> List[str]:
        return [k for k, v in self.param_space.items()
                if isinstance(v, (Float, Integer))]

    def _distance(self, a: Dict[str, Any], b: Dict[str, Any]) -> float:
        d = 0.0
        for k, dom in self.param_space.items():
            if isinstance(dom, (Float, Integer)):
                span = float(dom.upper - dom.lower) or 1.0
                d += ((float(a[k]) - float(b[k])) / span) ** 2
            elif isinstance(dom, Categorical):
                d += 0.0 if a[k] == b[k] else 1.0
        return d

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._suggested >= self._budget:
            return None
        self._suggested += 1
        if len(self._observed) < self._warmup:
            cfg = self._sample_config()
        else:
            # elite set = best quartile of observations; pick the random
            # candidate closest to an elite (exploit) with an exploration
            # escape hatch
            # key= guards against score ties falling through to dict
            # comparison (TypeError)
            ranked = sorted(self._observed, key=lambda t: t[0])
            elites = [c for _, c in
                      ranked[:max(1, len(ranked) // 4)]]
            cands = [self._sample_config() for _ in range(self._n_cand)]
            if self._rng.random() < 0.25:
                cfg = cands[0]  # explore
            else:
                cfg = min(cands, key=lambda c: min(
                    self._distance(c, e) for e in elites))
        self._pending[trial_id] = cfg
        return cfg

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]]) -> None:
        cfg = self._pending.pop(trial_id, None)
        if cfg is None or result is None or self.metric not in result:
            return
        score = float(result[self.metric])
        if self.mode == "max":
            score = -score  # store as minimization
        self._observed.append((score, cfg))
