"""The port's RPC transport against ray_tpu's native one: the C++ epoll
transport (``protocol_native`` over ``_native/src/transport.cc``).

Each program of ``tests/test_protocol.py`` runs over both packages' native
server and client and must give the values the JAX test asserts, so both
give equal frames and replies. One deliberate difference, pinned here: the
port carries the native transport only. ``tests/test_protocol.py``'s
``python`` parametrisation (``PyRpcServer``/``PyRpcClient``) has no port
counterpart, so its cross-implementation test becomes one across the two
packages' native transports, which share the wire format.
"""

import importlib
import struct
import threading
import time

import pytest

PACKAGES = ["ray_tpu", "ray_tpu_torch"]


def modules(pkg):
    return (importlib.import_module(f"{pkg}.runtime.protocol"),
            importlib.import_module(f"{pkg}.runtime.protocol_native"))


def _echo_handlers(protocol):
    def echo(payload, ctx):
        return payload

    def boom(payload, ctx):
        raise ValueError("boom")

    def deferred(payload, ctx):
        def later():
            time.sleep(0.05)
            ctx.reply({"deferred": payload})
        threading.Thread(target=later, daemon=True).start()
        return protocol.DEFERRED

    return {"echo": echo, "boom": boom, "deferred": deferred,
            "ping": lambda p, c: "pong"}


@pytest.fixture(params=PACKAGES)
def impl(request):
    protocol, native = modules(request.param)
    server = native.RpcServer(_echo_handlers(protocol), name="t")
    client = native.RpcClient(server.address, name="t-client")
    yield server, client, protocol
    client.close()
    server.stop()


def test_the_port_carries_the_native_transport_only():
    protocol, native = modules("ray_tpu_torch")
    assert not hasattr(protocol, "PyRpcServer")
    assert not hasattr(protocol, "PyRpcClient")
    assert protocol.RpcServer is native.RpcServer
    assert protocol.RpcClient is native.RpcClient


def test_unary_roundtrip(impl):
    server, client, _ = impl
    assert client.call("echo", {"x": 1}) == {"x": 1}
    assert client.call("ping") == "pong"


def test_application_error_propagates(impl):
    server, client, _ = impl
    with pytest.raises(ValueError, match="boom"):
        client.call("boom")


def test_unknown_method(impl):
    server, client, protocol = impl
    with pytest.raises(protocol.RpcError, match="no handler"):
        client.call("nope")


def test_deferred_reply(impl):
    server, client, _ = impl
    assert client.call("deferred", 7) == {"deferred": 7}


def test_pipelined_async_calls(impl):
    server, client, _ = impl
    futs = [client.call_async("echo", i) for i in range(500)]
    assert [f.result(timeout=10) for f in futs] == list(range(500))


def test_batch_call_cb(impl):
    server, client, _ = impl
    results = {}
    done = threading.Event()

    def cb(i, value, error):
        results[i] = (value, error)
        if len(results) == 100:
            done.set()

    client.call_batch_cb("echo", [{"i": i} for i in range(100)], cb)
    assert done.wait(timeout=10)
    for i in range(100):
        value, error = results[i]
        assert error is None and value == {"i": i}


def test_large_frame(impl):
    server, client, _ = impl
    blob = b"z" * (8 * 1024 * 1024)
    assert client.call("echo", blob, timeout=30) == blob


def test_oneway_does_not_crash(impl):
    server, client, _ = impl
    got = []
    server.handlers["note"] = lambda p, c: got.append(p)
    client.oneway("note", 42)
    deadline = time.monotonic() + 5
    while not got and time.monotonic() < deadline:
        time.sleep(0.01)
    assert got == [42]


def test_connect_refused_raises(impl):
    _, client, protocol = impl
    dead = type(client)("127.0.0.1:1", name="dead")
    with pytest.raises(protocol.RpcError):
        dead.call("ping", timeout=3.0)
    dead.close()


def test_server_stop_fails_pending(impl):
    server, client, protocol = impl

    def hang(payload, ctx):
        return protocol.DEFERRED  # never replies

    server.handlers["hang"] = hang
    fut = client.call_async("hang")
    time.sleep(0.1)
    server.stop()
    with pytest.raises(protocol.RpcError):
        fut.result(timeout=10)


def test_on_disconnect_fires(impl):
    server, client, _ = impl
    seen = threading.Event()
    server.on_disconnect = lambda peer: seen.set()
    client.call("ping")
    client.close()
    assert seen.wait(timeout=5)


def test_peer_identity_stable(impl):
    server, client, _ = impl
    peers = []
    server.handlers["who"] = lambda p, ctx: peers.append(ctx.peer) or "ok"
    client.call("who")
    client.call("who")
    assert len(peers) == 2 and peers[0] == peers[1]


def test_inline_methods_preserve_order(impl):
    server, client, _ = impl
    seen = []

    def ordered(payload, ctx):
        seen.append(payload)
        return None

    server.handlers["ordered"] = ordered
    server.inline_methods.add("ordered")
    futs = [client.call_async("ordered", i) for i in range(200)]
    for f in futs:
        f.result(timeout=10)
    assert seen == list(range(200))


def test_chaos_injection(impl, monkeypatch):
    server, client, protocol = impl
    config_mod = importlib.import_module(
        protocol.__name__.replace("runtime.protocol", "core.config"))
    monkeypatch.setattr(config_mod.GlobalConfig, "testing_rpc_failure",
                        "flaky=2")
    protocol.reset_chaos()
    server.handlers["flaky"] = lambda p, c: "ok"
    failures = 0
    for _ in range(4):
        try:
            client.call("flaky", timeout=5)
        except protocol.RpcError:
            failures += 1
    assert failures == 2
    protocol.reset_chaos()


def test_cross_package_wire_compat():
    """The port's client against the JAX package's native server and the
    other way round: one wire format."""
    jproto, jnative = modules("ray_tpu")
    tproto, tnative = modules("ray_tpu_torch")
    jserver = jnative.RpcServer(_echo_handlers(jproto), name="x")
    tclient = tnative.RpcClient(jserver.address, name="x-port")
    try:
        assert tclient.call("echo", [1, 2]) == [1, 2]
    finally:
        tclient.close()
        jserver.stop()
    tserver = tnative.RpcServer(_echo_handlers(tproto), name="y")
    jclient = jnative.RpcClient(tserver.address, name="y-jax")
    try:
        assert jclient.call("echo", {"k": "v"}) == {"k": "v"}
    finally:
        jclient.close()
        tserver.stop()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_kv_fastpath_roundtrip(pkg):
    _, native = modules(pkg)
    server = native.RpcServer({}, name="fkv")
    assert server.enable_kv_fastpath(incarnation=42)
    client = native.RpcClient(server.address, name="fkv-c")
    try:
        status, val = client.call_fast(native.FAST_PING, timeout=10)
        assert status == 1
        assert struct.unpack("<Q", val)[0] == 42
        st, _ = client.call_fast(native.FAST_PUT, b"k1", b"v1",
                                 flags=1, timeout=10)
        assert st == 1
        st, v = client.call_fast(native.FAST_GET, b"k1", timeout=10)
        assert (st, v) == (1, b"v1")
        st, _ = client.call_fast(native.FAST_PUT, b"k1", b"v2",
                                 flags=0, timeout=10)
        assert st == 0
        st, v = client.call_fast(native.FAST_GET, b"k1", timeout=10)
        assert v == b"v1"
        assert server.kv_fast_get(b"k1") == b"v1"
        server.kv_fast_put(b"k2", b"host")
        st, v = client.call_fast(native.FAST_GET, b"k2", timeout=10)
        assert (st, v) == (1, b"host")
        assert set(server.kv_fast_items()) == {b"k1", b"k2"}
        v0 = server.kv_fast_version()
        st, _ = client.call_fast(native.FAST_DEL, b"k1", timeout=10)
        assert st == 1
        assert server.kv_fast_version() > v0
        st, _ = client.call_fast(native.FAST_GET, b"k1", timeout=10)
        assert st == 0
    finally:
        client.close()
        server.stop()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_kv_fastpath_mixed_with_pickle_calls(pkg):
    protocol, native = modules(pkg)
    server = native.RpcServer(_echo_handlers(protocol), name="mix")
    server.enable_kv_fastpath()
    client = native.RpcClient(server.address, name="mix-c")
    try:
        for i in range(50):
            client.call_fast(native.FAST_PUT, b"k%d" % i, b"v%d" % i,
                             flags=1, timeout=10)
            assert client.call("echo", i, timeout=10) == i
        st, v = client.call_fast(native.FAST_GET, b"k7", timeout=10)
        assert (st, v) == (1, b"v7")
    finally:
        client.close()
        server.stop()
