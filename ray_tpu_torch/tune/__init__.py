"""ray_tpu_torch.tune — hyperparameter search & trial orchestration.

The port of ``ray_tpu/tune``, which imports no JAX and is copied with its
imports pointed at this package. Capability target: the reference's Ray
Tune core (reference: python/ray/tune — Tuner.fit at tuner.py:312,
TuneController at execution/tune_controller.py:68, ASHA at
schedulers/async_hyperband.py, PBT at schedulers/pbt.py:221). Trials run
as actors of this package's runtime; a trial that trains on the card
asks for it as ``resources_per_trial={"GPU": 1}``. In local mode, the
only runtime this package has, nothing is reserved (the reference's
local mode reserves nothing either): trials share the card, as many at
once as ``max_concurrent_trials`` allows.
"""

from typing import Any, Dict

from ray_tpu_torch.tune.schedulers import (ASHAScheduler, FIFOScheduler,
                                     MedianStoppingRule,
                                     PopulationBasedTraining, TrialScheduler)
from ray_tpu_torch.tune.searcher import (BasicVariantSearcher,
                                   HyperOptLikeSearcher, Searcher)
from ray_tpu_torch.tune.search import (choice, grid_search, loguniform, randint,
                                 sample_from, uniform)
from ray_tpu_torch.tune.trial import Trial, TrialStatus, get_session
from ray_tpu_torch.tune.tuner import ResultGrid, TuneConfig, TuneRunConfig, Tuner

__all__ = [
    "Tuner", "TuneConfig", "TuneRunConfig", "ResultGrid", "Trial",
    "TrialStatus", "TrialScheduler", "FIFOScheduler", "ASHAScheduler",
    "MedianStoppingRule",
    "PopulationBasedTraining", "uniform", "loguniform", "randint", "choice",
    "sample_from", "grid_search", "report", "get_checkpoint",
    "Searcher", "BasicVariantSearcher", "HyperOptLikeSearcher",
]


def report(metrics: Dict[str, Any], *, checkpoint: Any = None) -> None:
    """Report one iteration's metrics (and optionally a checkpoint object)
    from inside a trial (reference: tune report/session API)."""
    get_session().report(metrics, checkpoint=checkpoint)


def get_checkpoint() -> Any:
    """The checkpoint object this trial should resume from, or None.
    After a PBT exploit this is the *source* trial's checkpoint."""
    return get_session().get_checkpoint()
