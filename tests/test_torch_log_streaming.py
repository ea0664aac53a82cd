"""The port's worker stdout/stderr streaming to the submitting driver,
held to ``tests/test_log_streaming.py``'s assertions: a task's print, its
stderr and an actor method's print reach the driver, the print with the
worker's ``pid=`` prefix. Arrival depends on timing, so only the port's
program runs here; the JAX package's runs in its own file.
"""

import sys
import time

import pytest

import ray_tpu_torch as rt


@pytest.fixture(scope="module")
def log_rt():
    rt.init(num_cpus=2, _system_config={
        "object_store_memory_bytes": 64 * 1024 * 1024,
    })
    yield rt
    rt.shutdown()


def _wait_for(capsys, needle: str, timeout: float = 10.0) -> str:
    collected = ""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        captured = capsys.readouterr()
        collected += captured.out + captured.err
        if needle in collected:
            return collected
        time.sleep(0.2)
    raise AssertionError(f"{needle!r} never reached the driver; "
                         f"got: {collected[-2000:]!r}")


def test_task_print_reaches_driver(log_rt, capsys):
    @rt.remote
    def chatty():
        print("hello-from-worker-xyzzy")
        return 1

    assert rt.get(chatty.remote(), timeout=60) == 1
    out = _wait_for(capsys, "hello-from-worker-xyzzy")
    # attributed with the worker prefix, like the reference's (pid=...)
    line = next(l for l in out.splitlines()
                if "hello-from-worker-xyzzy" in l)
    assert "pid=" in line


def test_stderr_reaches_driver(log_rt, capsys):
    @rt.remote
    def warns():
        print("warning-grobble", file=sys.stderr)
        return 2

    assert rt.get(warns.remote(), timeout=60) == 2
    _wait_for(capsys, "warning-grobble")


def test_actor_method_print_reaches_driver(log_rt, capsys):
    @rt.remote
    class Talker:
        def speak(self):
            print("actor-says-quux")
            return "ok"

    t = Talker.remote()
    assert rt.get(t.speak.remote(), timeout=60) == "ok"
    _wait_for(capsys, "actor-says-quux")
