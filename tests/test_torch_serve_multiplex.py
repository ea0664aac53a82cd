"""The port's model multiplexing (``ray_tpu_torch.serve.multiplex``)
against ray_tpu's: the per-replica LRU model cache, request tagging,
model-aware routing, and batching partitioned by model id.

The unit programs of ``tests/test_serve_multiplex.py`` run against each
package's module without a cluster; its cluster programs run once through
each package's cluster runtime. Each must give the result the JAX
package's test asserts.
"""

import importlib
from concurrent.futures import ThreadPoolExecutor

import pytest
from test_torch_serve import stop_serve

PACKAGES = ["ray_tpu", "ray_tpu_torch"]


def multiplex_of(pkg):
    return importlib.import_module(f"{pkg}.serve.multiplex")


def loader_class(pkg):
    """A plain object standing in for a deployment instance."""
    multiplexed = multiplex_of(pkg).multiplexed

    class _Loader:
        def __init__(self):
            self.loads = []

        @multiplexed(max_num_models_per_replica=2)
        def load(self, model_id: str):
            self.loads.append(model_id)
            return {"id": model_id}

    return _Loader


# ---------------------------------------------------------- unit: cache


@pytest.mark.parametrize("pkg", PACKAGES)
def test_multiplexed_lru_eviction(pkg):
    host = loader_class(pkg)()
    assert host.load("a")["id"] == "a"
    assert host.load("b")["id"] == "b"
    assert host.load("a")["id"] == "a"      # hit — no reload
    assert host.loads == ["a", "b"]
    host.load("c")                          # evicts LRU = "b"
    assert host.load("a")["id"] == "a"      # still cached
    assert host.loads == ["a", "b", "c"]
    host.load("b")                          # reload after eviction
    assert host.loads == ["a", "b", "c", "b"]
    assert set(host.load.cache.model_ids()) == {"a", "b"}
    assert host.load.cache.evict_count == 2


@pytest.mark.parametrize("pkg", PACKAGES)
def test_multiplexed_plain_function(pkg):
    calls = []

    @multiplex_of(pkg).multiplexed(max_num_models_per_replica=1)
    def load(model_id: str):
        calls.append(model_id)
        return model_id.upper()

    assert load("x") == "X"
    assert load("x") == "X"
    assert calls == ["x"]
    load("y")                               # evicts x (max=1)
    load("x")
    assert calls == ["x", "y", "x"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_multiplexed_eager_teardown(pkg):
    died = []

    class Model:
        def __init__(self, mid):
            self.mid = mid

        def __del__(self):
            died.append(self.mid)

    @multiplex_of(pkg).multiplexed(max_num_models_per_replica=1)
    def load(model_id: str):
        return Model(model_id)

    m1 = load("one")
    load("two")
    # eviction of "one" calls its __del__ eagerly even while m1 is held
    assert "one" in died
    del m1


@pytest.mark.parametrize("pkg", PACKAGES)
def test_multiplexed_rejects_bad_config(pkg):
    with pytest.raises(ValueError):
        multiplex_of(pkg).multiplexed(max_num_models_per_replica=0)(
            lambda mid: mid)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_multiplex_descriptor_detected(pkg):
    assert isinstance(loader_class(pkg).__dict__["load"],
                      multiplex_of(pkg)._MultiplexedDescriptor)


class _FakeReplica:
    def __init__(self, name):
        self.actor_id = type("Id", (), {"hex": lambda _self: name})()


def test_new_models_spread_over_replicas():
    """The port's router sends a model no replica holds to a replica
    homing the fewest models, so two models on two replicas get a replica
    each (the JAX router picks by load alone, and may home both on one
    replica, where a third model then evicts one of them); a known model
    keeps its home."""
    import threading

    from ray_tpu_torch.serve.router import Router
    for _ in range(50):
        router = Router.__new__(Router)
        router._lock = threading.RLock()
        router._replicas = [_FakeReplica("a"), _FakeReplica("b")]
        router._inflight = {}
        router._mux_affinity = {}
        home1 = router._pick("m1").actor_id.hex()
        home2 = router._pick("m2").actor_id.hex()
        assert home1 != home2
        assert router._pick("m1").actor_id.hex() == home1
        assert router._pick("m2").actor_id.hex() == home2


# ------------------------------------------------- cluster: serve routing


@pytest.fixture(scope="module", params=PACKAGES)
def serve_rt(request):
    rt = importlib.import_module(request.param)
    rt.init(num_cpus=8)
    serve = importlib.import_module(f"{request.param}.serve")
    yield rt, serve
    stop_serve(serve)
    rt.shutdown()


def mux_server(rt, serve):
    @serve.deployment(num_replicas=2)
    class MuxServer:
        def __init__(self):
            # worker id is unique per replica process — a replica tag
            self.replica_tag = rt.get_runtime_context().worker_id.hex()[:8]

        @serve.multiplexed(max_num_models_per_replica=2)
        def load(self, model_id: str):
            return {"model": model_id, "loaded_on": self.replica_tag}

        def __call__(self, body):
            mid = serve.get_multiplexed_model_id()
            model = self.load(mid)
            return {"model_id": mid, "replica": self.replica_tag,
                    "loaded_on": model["loaded_on"]}

    return MuxServer


def test_multiplex_routing_affinity(serve_rt):
    handle = serve_rt[1].run(mux_server(*serve_rt).bind())
    # first touch establishes each model's home replica
    homes = {}
    for mid in ("m1", "m2"):
        out = handle.options(multiplexed_model_id=mid).remote(mid) \
            .result(timeout=60)
        assert out["model_id"] == mid
        homes[mid] = out["replica"]
    # repeated traffic for a model sticks to its home replica
    for _ in range(6):
        for mid in ("m1", "m2"):
            out = handle.options(multiplexed_model_id=mid).remote(mid) \
                .result(timeout=60)
            assert out["replica"] == homes[mid], \
                f"{mid} moved from {homes[mid]} to {out['replica']}"
    # untagged requests still route (no affinity involved)
    out = handle.remote("untagged").result(timeout=60)
    assert out["model_id"] == ""


def _replica_model_ids(rt, handle, app):
    """The model ids every replica of ``app`` reports in its stats."""
    table = rt.get(handle._controller.get_routing_table.remote(app),
                   timeout=30)
    ids = set()
    for h in table["replicas"]:
        s = rt.get(h.stats.remote(), timeout=30)
        ids.update(s.get("multiplexed_model_ids", []))
    return ids


def test_multiplex_model_ids_in_stats(serve_rt):
    """Its own deployment and traffic: two models on replicas that hold
    up to three each, so no eviction can drop an id from the stats."""
    rt, serve = serve_rt

    @serve.deployment(num_replicas=2)
    class MuxStats:
        @serve.multiplexed(max_num_models_per_replica=3)
        def load(self, model_id: str):
            return model_id

        def __call__(self, body):
            return self.load(serve.get_multiplexed_model_id())

    handle = serve.run(MuxStats.bind())
    for mid in ("m1", "m2"):
        out = handle.options(multiplexed_model_id=mid).remote({}) \
            .result(timeout=60)
        assert out == mid
    assert "MuxStats" in serve.status()
    assert {"m1", "m2"} <= _replica_model_ids(rt, handle, "MuxStats")


@pytest.mark.parametrize("serve_rt", ["ray_tpu_torch"], indirect=True)
def test_new_models_home_on_the_replica_holding_fewest(serve_rt):
    """The port's router homes a new model on a replica holding the
    fewest: m1 and m2 land on different replicas, and an untagged
    request's model ("") then fills one of them to its two models
    without evicting m1 or m2, whose ids stay in the stats. (The JAX
    router homes by load alone: all three may meet on one replica.)"""
    rt, serve = serve_rt

    @serve.deployment(num_replicas=2)
    class MuxHoming:
        def __init__(self):
            self.replica_tag = rt.get_runtime_context().worker_id.hex()[:8]

        @serve.multiplexed(max_num_models_per_replica=2)
        def load(self, model_id: str):
            return model_id

        def __call__(self, body):
            self.load(serve.get_multiplexed_model_id())
            return self.replica_tag

    handle = serve.run(MuxHoming.bind())
    homes = {mid: handle.options(multiplexed_model_id=mid).remote({})
             .result(timeout=60) for mid in ("m1", "m2")}
    assert homes["m1"] != homes["m2"], homes
    handle.remote({}).result(timeout=60)
    assert {"m1", "m2", ""} <= _replica_model_ids(rt, handle, "MuxHoming")


# --------------------------------------------- batching x multiplexing


def test_batch_partitions_by_model_id(serve_rt):
    _, serve = serve_rt

    @serve.deployment(num_replicas=1)
    class BatchedMux:
        @serve.multiplexed(max_num_models_per_replica=4)
        def load(self, model_id: str):
            return model_id.upper()

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.05)
        def predict(self, bodies):
            # runs on the batcher thread: the model id must still resolve,
            # and every request in one batch shares it by construction
            mid = serve.get_multiplexed_model_id()
            w = self.load(mid)
            return [{"model_id": mid, "weights": w, "n": len(bodies)}
                    for _ in bodies]

        def __call__(self, body):
            return self.predict(body)

    handle = serve.run(BatchedMux.bind())

    def call(mid):
        return handle.options(multiplexed_model_id=mid).remote({}) \
            .result(timeout=60)

    with ThreadPoolExecutor(max_workers=8) as ex:
        outs = list(ex.map(call, ["a", "b", "a", "b", "a", "b", "a", "b"]))
    for out in outs:
        # the batched fn saw the request's own model id — never another
        # model's (queues are partitioned per model id)
        assert out["weights"] == out["model_id"].upper()
    assert {o["model_id"] for o in outs} == {"a", "b"}
    # batching still coalesced concurrent same-model requests
    assert any(o["n"] > 1 for o in outs), [o["n"] for o in outs]
