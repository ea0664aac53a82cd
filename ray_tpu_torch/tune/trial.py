"""Trial bookkeeping + the trial-runner actor.

The port of ``ray_tpu/tune/trial.py``. Role-equivalent to the
reference's Trial (reference: tune/experiment/trial.py) and the
function-trainable wrapper (tune/trainable/function_trainable.py): the
user function runs on a thread inside a trial actor, streaming
``tune.report`` results through a queue; the controller pulls one result
at a time (``next_result``), which is what gives schedulers per-iteration
control (stop/pause/exploit between iterations).

A checkpoint is cloudpickled to the trial's directory as the JAX package
writes it. A tensor pickles with its device, so a dict of CUDA tensors
comes back on the card it was saved from: right on one card, where every
trial shares it. ``TrialRunner.stop`` waits for the function's thread to
unwind, unlike the JAX package's: a thread still inside torch code when
the interpreter exits aborts the process, and the runtime's shutdown
joins actor threads, not the threads they start.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import cloudpickle

DONE = "__trial_done__"
#: how long ``TrialRunner.stop`` waits for the function to reach its next
#: ``report`` and unwind
STOP_JOIN_S = 600.0


class TrialStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    PAUSED = "PAUSED"
    TERMINATED = "TERMINATED"
    ERRORED = "ERRORED"


@dataclass
class Trial:
    trial_id: str
    config: Dict[str, Any]
    status: str = TrialStatus.PENDING
    iteration: int = 0
    last_result: Dict[str, Any] = field(default_factory=dict)
    results: List[Dict[str, Any]] = field(default_factory=list)
    checkpoint_path: Optional[str] = None
    error: Optional[str] = None
    actor: Any = None  # live ActorHandle while RUNNING
    pending_ref: Any = None  # outstanding next_result ObjectRef

    def metric_value(self, metric: str) -> Optional[float]:
        v = self.last_result.get(metric)
        return float(v) if v is not None else None


# ---------------------------------------------------------------- actor side

class _TrialSession:
    """tune.report/get_checkpoint binding inside the trial thread."""

    def __init__(self, config: Dict[str, Any], trial_dir: str,
                 restore_path: Optional[str]):
        self.config = config
        self.trial_dir = trial_dir
        self.restore_path = restore_path
        self.queue: "queue.Queue" = queue.Queue(maxsize=4)
        self.step = 0
        self.stop_event = threading.Event()

    def report(self, metrics: Dict[str, Any],
               checkpoint: Any = None) -> None:
        if self.stop_event.is_set():
            raise StopTrial()
        self.step += 1
        entry = dict(metrics)
        entry["training_iteration"] = self.step
        if checkpoint is not None:
            os.makedirs(self.trial_dir, exist_ok=True)
            path = os.path.join(self.trial_dir, f"ckpt_{self.step:08d}.pkl")
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                cloudpickle.dump(checkpoint, f)
            os.replace(tmp, path)
            entry["__checkpoint__"] = path
        self.queue.put(("result", entry))
        if self.stop_event.is_set():
            raise StopTrial()

    def get_checkpoint(self) -> Any:
        if self.restore_path and os.path.exists(self.restore_path):
            with open(self.restore_path, "rb") as f:
                return cloudpickle.load(f)
        return None


class StopTrial(Exception):
    """Raised inside the user fn when the controller stopped the trial."""


_session_local = threading.local()


def get_session() -> _TrialSession:
    s = getattr(_session_local, "s", None)
    if s is None:
        raise RuntimeError("tune.report called outside a tune trial")
    return s


class TrialRunner:
    """Actor body: owns the user-fn thread and the result queue."""

    def __init__(self, fn: Callable[[Dict[str, Any]], Any],
                 config: Dict[str, Any], trial_dir: str,
                 restore_path: Optional[str] = None):
        self._session = _TrialSession(config, trial_dir, restore_path)

        def runner():
            _session_local.s = self._session
            try:
                fn(dict(config))
                self._session.queue.put((DONE, None))
            except StopTrial:
                self._session.queue.put((DONE, None))
            except BaseException as e:  # noqa: BLE001 — trial fault boundary
                self._session.queue.put(("error", e))
        self._thread = threading.Thread(target=runner, daemon=True,
                                        name="tune-trial-fn")
        self._thread.start()

    def next_result(self) -> Dict[str, Any]:
        """Block until the fn reports, finishes, or errors."""
        kind, payload = self._session.queue.get()
        if kind == DONE:
            return {DONE: True}
        if kind == "error":
            raise payload
        return payload

    def stop(self) -> bool:
        """Ask the fn thread to unwind at its next report(), and wait for
        it to; True once it has."""
        self._session.stop_event.set()
        try:
            while True:
                self._session.queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(STOP_JOIN_S)
        return not self._thread.is_alive()
