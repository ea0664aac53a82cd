"""The port's combined batch frames against ray_tpu's: one request frame
carrying N task payloads, one reply frame carrying N (value, error) pairs
(``cluster_backend._push_batch`` -> ``worker_main.handle_push_task_batch``
-> ``_BatchReplyCollector``).

Each program of ``tests/test_combined_batch.py`` runs through both
packages (their native transports; the port has no Python one) and must
give the replies the JAX test asserts, so both give equal replies: per-item
error isolation, the malformed-reply guard, eager per-slot flushes, and a
burst of tasks on a cluster with one failing task.
"""

import gc
import importlib
import threading

import pytest

PACKAGES = ["ray_tpu", "ray_tpu_torch"]


@pytest.fixture(params=PACKAGES)
def protocol(request):
    return importlib.import_module(f"{request.param}.runtime.protocol")


@pytest.fixture
def echo_server(protocol):
    def handle_echo(payloads, ctx):
        out = []
        for p in payloads:
            if p == "boom":
                out.append((None, ValueError("boom payload")))
            else:
                out.append((("echo", p), None))
        return out

    def handle_bad_combined(payload, ctx):
        return "not-a-list"  # malformed combined reply

    srv = protocol.RpcServer({"echo": handle_echo,
                              "bad": handle_bad_combined},
                             name="combined-test")
    yield srv, protocol
    srv.stop()


def test_call_combined_cb_fans_out(echo_server):
    srv, protocol = echo_server
    client = protocol.RpcClient(srv.address)
    got = {}
    done = threading.Event()

    def cb(i, v, e):
        got[i] = (v, e)
        if len(got) == 4:
            done.set()

    client.call_combined_cb("echo", ["a", "b", "boom", "c"], cb)
    assert done.wait(10), f"only {len(got)} callbacks fired"
    assert got[0] == (("echo", "a"), None)
    assert got[3] == (("echo", "c"), None)
    assert got[2][0] is None and isinstance(got[2][1], ValueError)
    client.close()


def test_combined_malformed_reply_surfaces_error(echo_server):
    srv, protocol = echo_server
    client = protocol.RpcClient(srv.address)
    got = {}
    done = threading.Event()

    def cb(i, v, e):
        got[i] = (v, e)
        if len(got) == 2:
            done.set()

    client.call_combined_cb("bad", ["x", "y"], cb)
    assert done.wait(10)
    for i in (0, 1):
        v, e = got[i]
        assert v is None and e is not None, \
            f"malformed combined reply not surfaced: {got[i]}"
    client.close()


@pytest.fixture
def eager_server(protocol):
    state = {"release": threading.Event(), "slot_ids": None}

    def handle_eager(payloads, ctx):
        state["slot_ids"] = ctx.slot_ids
        if ctx.slot_ids is None:  # old-format client: single reply
            return [((p, "done"), None) for p in payloads]
        ctx.reply_to(ctx.slot_ids[0], (payloads[0], "done"), None)

        def later():
            state["release"].wait(10)
            ctx.reply_to(ctx.slot_ids[1], (payloads[1], "done"), None)
            ctx.reply(protocol._COMBINED_DONE)
        threading.Thread(target=later, daemon=True).start()
        return protocol.DEFERRED

    srv = protocol.RpcServer({"eager": handle_eager}, name="eager-test")
    yield srv, state, protocol
    state["release"].set()
    srv.stop()


def test_combined_replies_flush_eagerly(eager_server):
    srv, state, protocol = eager_server
    client = protocol.RpcClient(srv.address)
    got = {}
    first = threading.Event()
    done = threading.Event()

    def cb(i, v, e):
        got[i] = (v, e)
        if i == 0:
            first.set()
        if len(got) == 2:
            done.set()

    client.call_combined_cb("eager", ["a", "b"], cb)
    assert first.wait(10), "eager slot reply never fired"
    assert got[0] == (("a", "done"), None)
    assert not done.is_set()
    state["release"].set()
    assert done.wait(10), "batch never completed after release"
    assert got[1] == (("b", "done"), None)
    assert state["slot_ids"] is not None and len(state["slot_ids"]) == 2
    client.close()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_batch_error_isolation_end_to_end(pkg):
    """One failing task inside a burst must not poison its batchmates:
    the same (index, value or failure) list from both packages."""
    rt = importlib.import_module(pkg)
    # the JAX package's side runs with the cyclic collector paused
    if pkg == "ray_tpu":
        gc.disable()
    rt.init(num_cpus=2, _system_config={
        "object_store_memory_bytes": 64 * 1024 * 1024})
    try:
        @rt.remote
        def maybe_fail(i):
            if i == 7:
                raise RuntimeError(f"task {i} fails")
            return i * 2

        refs = [maybe_fail.remote(i) for i in range(20)]
        outcome = []
        for i, r in enumerate(refs):
            try:
                outcome.append((i, rt.get(r, timeout=60)))
            except rt.exceptions.TaskError as e:
                outcome.append((i, e.cause_cls_name))
        assert outcome == [(i, "RuntimeError" if i == 7 else i * 2)
                           for i in range(20)]
    finally:
        rt.shutdown()
        gc.enable()
        gc.collect()
