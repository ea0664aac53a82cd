"""Step-time attribution: split a train step into phases — the PyTorch
port of ``ray_tpu/train/step_profiler.py``. With ``emit=True`` the result
sets the ``train_step_time_s`` and ``train_phase_time_s{phase}`` gauges
of the port's metrics plane; the span tree waits for a copy of the
runtime's task-event buffer.

PyTorch runs each phase as its own sequence of kernels, so the phases are
timed as separate runs of the step's pieces:

  forward          loss_fn under no_grad              (loss only)
  forward+backward loss_fn + backward                 (adds the bwd pass)
  optimizer        optimizer.step() on those grads

backward = (fwd+bwd) − fwd. The whole step is then timed; the residual over
fwd+bwd+opt is ``collective_wait`` (on one card: what the step pays that
its pieces do not, e.g. the gradient norm); when the step is faster than
the sum the compute phases are scaled so the breakdown sums exactly to the
step time. On the card every time is CUDA events around the work; on the
CPU ``time.perf_counter``. ``compile_time_s`` is inferred: the first step
minus the steady state (kernel builds and loads, library warm-up).
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Callable, Dict

import torch

from ray_tpu_torch.train.train_step import make_train_step, param_leaves
from ray_tpu_torch.util import metrics as metrics_mod

PHASES = ("forward", "backward", "optimizer", "collective_wait")


@dataclasses.dataclass
class StepBreakdown:
    """One profiled train step. ``phases`` (seconds, keyed by PHASES)
    sums exactly to ``step_time_s``."""
    step_time_s: float
    compile_time_s: float
    phases: Dict[str, float]
    n_steps: int = 1
    compile_source: str = "inferred"

    def phase_ms(self) -> Dict[str, float]:
        return {k: v * 1e3 for k, v in self.phases.items()}


def _seconds(fn: Callable[[], Any], device: torch.device) -> float:
    """Time of one fn() call: CUDA events on the card, else the host
    clock."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _timed(fn: Callable[[], Any], device, *, steps: int, warmup: int,
           before: Callable[[], Any] = lambda: None) -> float:
    """Median steady-state time of fn(); ``before`` runs untimed ahead of
    every call."""
    for _ in range(warmup):
        before()
        fn()
    times = []
    for _ in range(steps):
        before()
        times.append(_seconds(fn, device))
    return sorted(times)[len(times) // 2]


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return {k: _clone(v) for k, v in tree.items()}


def profile_train_step(loss_fn: Callable[[Any, Any], torch.Tensor],
                       optimizer, params, opt_state, batch, *,
                       steps: int = 3, warmup: int = 1,
                       emit: bool = True) -> StepBreakdown:
    """Profile one train step configuration and return its breakdown.

    loss_fn(params, batch) -> scalar; ``optimizer`` builds an optimizer
    over a list of leaves, as for ``make_train_step``; ``opt_state`` is
    the caller's optimizer. The profiler works on copies of the
    parameters and of the optimizer's state, so the caller's training
    state is left untouched. With emit=True the step and phase gauges are
    set from the breakdown.
    """
    device = param_leaves(params)[0].device
    p = _clone(params)
    init_fn, step_fn = make_train_step(loss_fn, optimizer)
    opt = init_fn(p)
    opt.load_state_dict(copy.deepcopy(opt_state.state_dict()))
    p_leaves = param_leaves(p)

    def zero_grads():
        for leaf in p_leaves:
            leaf.grad = None

    def fwd():
        with torch.no_grad():
            loss_fn(p, batch)

    def fwd_bwd():
        loss_fn(p, batch).backward()

    first_s = _seconds(lambda: step_fn(p, opt, batch), device)
    step_s = _timed(lambda: step_fn(p, opt, batch), device, steps=steps,
                    warmup=max(warmup - 1, 0))
    compile_s = max(first_s - step_s, 0.0)
    t_fwd = _timed(fwd, device, steps=steps, warmup=warmup)
    t_fwdbwd = _timed(fwd_bwd, device, steps=steps, warmup=warmup,
                      before=zero_grads)
    t_bwd = max(t_fwdbwd - t_fwd, 0.0)
    zero_grads()
    fwd_bwd()               # grads for the optimizer phase, kept across it
    t_opt = _timed(opt.step, device, steps=steps, warmup=warmup)
    zero_grads()

    compute = t_fwd + t_bwd + t_opt
    if compute <= step_s or compute <= 0:
        phases = {"forward": t_fwd, "backward": t_bwd, "optimizer": t_opt,
                  "collective_wait": step_s - compute}
    else:
        scale = step_s / compute
        phases = {"forward": t_fwd * scale, "backward": t_bwd * scale,
                  "optimizer": t_opt * scale, "collective_wait": 0.0}
    breakdown = StepBreakdown(step_time_s=step_s, compile_time_s=compile_s,
                              phases=phases, n_steps=steps)
    if emit:
        _emit_gauges(breakdown)
    return breakdown


def _emit_gauges(b: StepBreakdown) -> None:
    try:
        metrics_mod.train_step_time_gauge().set(b.step_time_s)
        for phase, secs in b.phases.items():
            metrics_mod.train_phase_time_gauge().set(
                secs, tags={"phase": phase})
    except Exception:  # noqa: BLE001 — telemetry never fails profiling
        pass
