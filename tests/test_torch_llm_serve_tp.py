"""A tensor-parallel LLM deployment through each package's Serve: the
counterpart of tests/test_llm_serve.py's tp=2 deployment test, run once
through ``ray_tpu`` (8 TPU resources, the replica's engine on 2 virtual
CPU devices from its runtime_env) and once through the port (a cluster
told of two cards, ``init(num_gpus=2)``; the replica's engine drives two
shards on the CPU, no CUDA runs).

Both: ``placement_for_engine``'s bundles, the tp=2 replica's greedy
stream equal to the tp=1 replica's, and the gang booked while the
replica lives; for the port also the lease's two cards in the replica
worker's ``CUDA_VISIBLE_DEVICES`` and the cards freed after
``serve.delete``.

The port's model runs in fp32 here: in bf16 its tp=2 split sum rounds
each shard's partial product before adding, and from its seed the tiny
model has a top-2 margin of 0.0066 at the third token, under that
noise (the JAX model, from its own seed, has none), so the streams may
part there. In fp32 they must be equal.
"""

import importlib
import time

import pytest
from test_torch_llm_serve import leased_workers
from test_torch_serve import stop_serve

PACKAGES = ["ray_tpu", "ray_tpu_torch"]
MODEL = {"n_layers": 2}
ENGINE = {"page_size": 8, "total_pages": 64, "max_batch": 4,
          "max_seq_len": 128, "seed": 7}
PROMPT = {"prompt_ids": [5, 17, 42, 9], "max_tokens": 6}


@pytest.fixture(scope="module", params=PACKAGES)
def serve_rt(request):
    rt = importlib.import_module(request.param)
    accel = ({"num_gpus": 2} if request.param == "ray_tpu_torch"
             else {"resources": {"TPU": 8}})
    rt.init(num_cpus=4, **accel, _system_config={
        "object_store_memory_bytes": 128 * 1024 * 1024,
        "worker_pool_prestart": 2,
    })
    serve = importlib.import_module(f"{request.param}.serve")
    yield rt, serve
    stop_serve(serve)
    rt.shutdown()


def _wait_free(rt, key, want):
    deadline = time.monotonic() + 30
    while rt.available_resources().get(key, 0.0) != want:
        assert time.monotonic() < deadline, rt.available_resources()
        time.sleep(0.2)


def test_llm_tp_deployment_gang_resources(serve_rt):
    rt, serve = serve_rt
    llm = importlib.import_module(f"{rt.__name__}.llm.serve_llm")
    port = rt.__name__ == "ray_tpu_torch"
    key = "GPU" if port else "TPU"
    bundles, strategy = llm.placement_for_engine(2)
    assert bundles == [{key: 2.0}] and strategy == "STRICT_PACK"
    bundles, strategy = llm.placement_for_engine(8, 2)
    assert bundles == [{key: 8.0}] * 2 and strategy == "PACK"

    if port:
        # the engine runs on the CPU in the two cards' worker
        model = dict(MODEL, dtype="float32")
        eng, kw = dict(ENGINE, device="cpu"), {"use_gpu_resources": True}
        one = dict(kw, use_gpu_resources=False)
    else:
        model = MODEL
        eng, kw = ENGINE, {"runtime_env": {"env_vars": {
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=2"}}}
        one = kw
    app_tp = llm.build_llm_app(model, {**eng, "tp": 2}, name="llm-tp2",
                               **kw)
    assert app_tp.deployment._config["resources"] == {key: 2.0}
    h_tp = serve.run(app_tp, timeout_s=300)
    out_tp = h_tp.remote(PROMPT).result(timeout=300)
    h_1 = serve.run(llm.build_llm_app(model, eng, name="llm-tp1", **one),
                    timeout_s=300)
    out_1 = h_1.remote(PROMPT).result(timeout=300)
    assert len(out_1["token_ids"]) == 6
    assert out_tp["token_ids"] == out_1["token_ids"]

    # the tp replica holds its gang while it lives
    if port:
        assert rt.available_resources().get("GPU", 0.0) == 0.0
        assert leased_workers() == ["0,1"]
    else:
        assert rt.available_resources().get("TPU", 0) <= 6.0
    serve.delete("llm-tp2")
    serve.delete("llm-tp1")
    _wait_free(rt, key, 2.0 if port else 8.0)
