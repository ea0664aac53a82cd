"""GPipe pipeline parallelism over the ``pp`` mesh axis — the PyTorch port
of ``ray_tpu/parallel/pipeline.py``.

Every ``pp`` rank holds its stage's parameters; activations hop stage to
stage with ``collectives.ppermute_shift`` (differentiable: its backward
is the opposite shift), and one loop of ``n_micro + n_stages - 1`` steps
runs the fill, steady and drain schedule. Autograd through the loop is
the backward pipeline.
"""

from __future__ import annotations

from typing import Callable

import torch

from ray_tpu_torch.parallel.collectives import (allreduce, ppermute_shift,
                                                tie)
from ray_tpu_torch.parallel.mesh import axis_index, axis_size


def pipeline_apply(stage_fn: Callable, stage_params,
                   microbatches: torch.Tensor, mesh,
                   axis_name: str = "pp") -> torch.Tensor:
    """Run microbatches through the pipeline on this rank's stage.

    stage_fn(stage_params, x) -> y: this rank's stage (y has x's shape,
        the inter-stage contract).
    microbatches: [n_micro, ...] stacked microbatch activations. Stage 0
        consumes them; later stages ignore their copy.
    Returns [n_micro, ...]: the LAST stage's outputs, summed over the
    axis (zeros elsewhere), so every stage can compute the same loss.

    At step t stage s works on microbatch t - s. Where that is none (the
    fill and drain steps), the JAX schedule runs the stage on a value
    that never reaches an output; here the stage is skipped and sends 0
    times what it received. Every rank of a stage skips together, so the
    collectives inside ``stage_fn`` stay matched, and every rank shifts on
    every step but the last. Each step's value depends on the value the
    rank received at the step before (the first on a leaf of zeros that
    takes a gradient; where stage 0 reads a microbatch instead, tied in
    with weight 0, ``collectives.tie``) and the last one is tied into the
    output, so the shifts form one chain on every rank: autograd runs
    every shift's backward on every rank, in the same order, as the
    exchanges need.
    """
    n_stages = axis_size(mesh, axis_name)
    stage = axis_index(mesh, axis_name)
    n_micro = microbatches.shape[0]
    state = torch.zeros_like(microbatches[0],
                             requires_grad=torch.is_grad_enabled())
    outputs = [torch.zeros_like(microbatches[0]) for _ in range(n_micro)]
    steps = n_micro + n_stages - 1
    for t in range(steps):
        m = t - stage
        if 0 <= m < n_micro:
            if stage == 0:
                y = tie(stage_fn(stage_params, microbatches[m]), state)
            else:
                y = stage_fn(stage_params, state)
            if stage == n_stages - 1:
                outputs[m] = y
        else:
            y = state * 0
        if t < steps - 1:   # the last step's shift reaches no stage
            state = ppermute_shift(y, mesh, axis_name)
    return allreduce(tie(torch.stack(outputs), y), mesh, axis_name)
