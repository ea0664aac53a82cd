"""Result of a training run (reference: python/ray/air/result.py).

The PyTorch port of ``ray_tpu/train/result.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint


@dataclasses.dataclass
class Result:
    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint]
    path: str
    metrics_history: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)
    error: Optional[BaseException] = None
