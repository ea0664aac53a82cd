"""Env-gated fault-injection seam for chaos/lifecycle tests.

Production code sprinkles named ``fire("point")`` calls at the places a
crash matters (autoscaler pre/post provider-create, provider
create/terminate, node daemon boot, instance-store writes). In normal
operation ``fire`` is a no-op costing one dict lookup against an empty
table. Tests arm points through the ``RTPT_FAULT_INJECT`` environment
variable — which subprocess daemons inherit, so a test can make a
*child* autoscaler SIGKILL itself between ``create_node`` and
persistence without monkeypatching anything in the child:

    RTPT_FAULT_INJECT="autoscaler.post_create=kill9"
    RTPT_FAULT_INJECT="provider.create=raise*2,node.boot=exit"
    RTPT_FAULT_INJECT="head.rpc=sleep:0.5"

Spec grammar: comma-separated ``point=action[:param][*count]`` where
``action`` is one of

* ``raise``  — raise ``FaultInjected`` at the point
* ``kill9``  — ``os.kill(os.getpid(), SIGKILL)``: the un-catchable crash
* ``exit``   — ``os._exit(param or 1)``: dirty exit, no atexit/finally
* ``sleep``  — ``time.sleep(param)``: models an RPC timeout/hang

``*count`` limits how many times the point fires (default: unlimited);
after the budget is spent the point is inert, so "fail twice then
succeed" retry tests need no bookkeeping. In-process tests can call
``configure()``/``reset()`` directly instead of going through the env.

Jax-free by construction — it is imported by daemons that must never
pull in the accelerator stack.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Dict, Optional

ENV_VAR = "RTPT_FAULT_INJECT"


class FaultInjected(RuntimeError):
    """The injected failure for ``raise`` actions."""


class _Point:
    __slots__ = ("action", "param", "remaining")

    def __init__(self, action: str, param: Optional[float], count: Optional[int]):
        self.action = action
        self.param = param
        self.remaining = count  # None = unlimited


_lock = threading.Lock()
_points: Dict[str, _Point] = {}
_loaded_env: Optional[str] = None


def _parse(spec: str) -> Dict[str, _Point]:
    points: Dict[str, _Point] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, action = part.split("=", 1)
        count: Optional[int] = None
        if "*" in action:
            action, n = action.rsplit("*", 1)
            count = int(n)
        param: Optional[float] = None
        if ":" in action:
            action, p = action.split(":", 1)
            param = float(p)
        points[name.strip()] = _Point(action.strip(), param, count)
    return points


def configure(spec: str) -> None:
    """Arm points from a spec string (replaces any existing table)."""
    with _lock:
        _points.clear()
        _points.update(_parse(spec))


def reset() -> None:
    """Disarm everything (tests call this in teardown)."""
    global _loaded_env
    with _lock:
        _points.clear()
        _loaded_env = None


def _maybe_load_env() -> None:
    """Lazily (re)load from the env var so a process armed at spawn time
    needs no explicit configure() call."""
    global _loaded_env
    spec = os.environ.get(ENV_VAR, "")
    if spec == (_loaded_env or ""):
        return
    with _lock:
        _loaded_env = spec
        _points.clear()
        _points.update(_parse(spec))


def fire(point: str) -> None:
    """Trigger ``point`` if armed. No-op (one dict lookup) otherwise."""
    _maybe_load_env()
    with _lock:
        p = _points.get(point)
        if p is None:
            return
        if p.remaining is not None:
            if p.remaining <= 0:
                return
            p.remaining -= 1
        action, param = p.action, p.param
    if action == "raise":
        raise FaultInjected(f"fault injected at {point!r}")
    if action == "kill9":
        os.kill(os.getpid(), signal.SIGKILL)
    if action == "exit":
        os._exit(int(param) if param is not None else 1)
    if action == "sleep":
        time.sleep(param if param is not None else 1.0)
