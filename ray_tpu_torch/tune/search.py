"""Search spaces + variant generation.

The port of ``ray_tpu/tune/search.py``, copied: Python's ``random``
seeded by the caller, so the same seed gives the same variants.
Role-equivalent to the reference's sample domains and BasicVariantGenerator
(reference: python/ray/tune/search/sample.py, search/basic_variant.py):
``param_space`` dicts mix literals, domain objects, and ``grid_search``
markers; the generator expands the grid cross-product and draws
``num_samples`` random variants of the stochastic domains per grid point.
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Callable, Dict, List, Optional, Sequence


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Float(Domain):
    def __init__(self, lower: float, upper: float, log: bool = False):
        if log and lower <= 0:
            raise ValueError("loguniform needs lower > 0")
        self.lower, self.upper, self.log = lower, upper, log

    def sample(self, rng: random.Random) -> float:
        if self.log:
            import math
            return math.exp(rng.uniform(math.log(self.lower),
                                        math.log(self.upper)))
        return rng.uniform(self.lower, self.upper)


class Integer(Domain):
    def __init__(self, lower: int, upper: int):
        self.lower, self.upper = lower, upper

    def sample(self, rng: random.Random) -> int:
        return rng.randrange(self.lower, self.upper)


class Categorical(Domain):
    def __init__(self, categories: Sequence[Any]):
        self.categories = list(categories)

    def sample(self, rng: random.Random) -> Any:
        return rng.choice(self.categories)


class Function(Domain):
    def __init__(self, fn: Callable[[], Any]):
        self.fn = fn

    def sample(self, rng: random.Random) -> Any:
        return self.fn()


class GridSearch:
    def __init__(self, values: Sequence[Any]):
        self.values = list(values)


# -- public constructors (reference: tune.uniform/loguniform/choice/...) ----

def uniform(lower: float, upper: float) -> Float:
    return Float(lower, upper)


def loguniform(lower: float, upper: float) -> Float:
    return Float(lower, upper, log=True)


def randint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper)


def choice(categories: Sequence[Any]) -> Categorical:
    return Categorical(categories)


def sample_from(fn: Callable[[], Any]) -> Function:
    return Function(fn)


def grid_search(values: Sequence[Any]) -> GridSearch:
    return GridSearch(values)


# ---------------------------------------------------------------------------

def _split_space(space: Dict[str, Any]):
    grid: Dict[str, GridSearch] = {}
    stochastic: Dict[str, Domain] = {}
    const: Dict[str, Any] = {}
    for k, v in space.items():
        if isinstance(v, GridSearch) or (
                isinstance(v, dict) and set(v) == {"grid_search"}):
            grid[k] = v if isinstance(v, GridSearch) \
                else GridSearch(v["grid_search"])
        elif isinstance(v, Domain):
            stochastic[k] = v
        else:
            const[k] = v
    return grid, stochastic, const


def generate_variants(space: Dict[str, Any], num_samples: int,
                      seed: Optional[int] = None) -> List[Dict[str, Any]]:
    """Grid cross-product × num_samples random draws (reference
    basic_variant semantics: num_samples repeats the whole grid)."""
    rng = random.Random(seed)
    grid, stochastic, const = _split_space(space)
    grid_keys = list(grid)
    grid_rows = [dict(zip(grid_keys, combo)) for combo in
                 itertools.product(*(grid[k].values for k in grid_keys))] \
        or [{}]
    variants: List[Dict[str, Any]] = []
    for _ in range(max(1, num_samples)):
        for row in grid_rows:
            cfg = dict(const)
            cfg.update(row)
            for k, dom in stochastic.items():
                cfg[k] = dom.sample(rng)
            variants.append(cfg)
    return variants


def resample_key(space: Dict[str, Any], key: str,
                 rng: random.Random) -> Optional[Any]:
    """Draw a fresh value for one hyperparameter (PBT explore)."""
    v = space.get(key)
    if isinstance(v, Domain):
        return v.sample(rng)
    if isinstance(v, GridSearch):
        return rng.choice(v.values)
    if isinstance(v, (list, tuple)) and v:
        return rng.choice(list(v))
    return None
