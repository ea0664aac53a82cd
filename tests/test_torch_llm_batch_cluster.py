"""``batch_inference`` on the cluster runtime: the programs of
``tests/test_llm_batch.py`` through each package's ``init(num_cpus=4)``
(pool actors in worker processes), against each other.

Both packages run the JAX package's parameters (carried across with
``convert``, shipped to the pool's actors in the engine config), so the
rows must be equal, key by key, besides meeting the JAX tests' own
criteria: every text prompt comes back with its id, 4 generated token
ids and its text; six copies of one prompt in 3 blocks over a pool of 2
actors give one greedy stream (cold prefill and prefix hits alike). Each
package's cluster boots once, runs both programs and shuts down before
the other's boots.
"""

import importlib

import jax
import jax.numpy as jnp
import pytest

from ray_tpu.models import llama as jl
from ray_tpu_torch import convert

PACKAGES = ["ray_tpu", "ray_tpu_torch"]
ENGINE = {"page_size": 8, "total_pages": 64, "max_batch": 4,
          "max_seq_len": 64}
TEXT_ROWS = [{"prompt": "hello", "id": 0}, {"prompt": "worldly", "id": 1},
             {"prompt": "abc", "id": 2}]


def _programs(pkg, params):
    """Both programs of tests/test_llm_batch.py through ``pkg``'s cluster
    runtime: -> (the text rows by id, the repeated prompt's rows)."""
    rt = importlib.import_module(pkg)
    data = importlib.import_module(f"{pkg}.data")
    batch = importlib.import_module(f"{pkg}.llm.batch")
    if pkg == "ray_tpu":
        model = {"n_layers": 2, "dtype": jnp.float32}
        engine = dict(ENGINE, params=params[0])
    else:
        model = {"n_layers": 2, "dtype": "float32"}
        engine = dict(ENGINE, params=params[1], device="cpu")
    rt.init(num_cpus=4)
    try:
        text = batch.batch_inference(
            data.from_items(TEXT_ROWS), model_config=model,
            max_new_tokens=4, engine_config=engine,
            concurrency=1).take_all()
        repeat = batch.batch_inference(
            data.from_items([{"prompt": "repeat me"} for _ in range(6)],
                            num_blocks=3),
            model_config=model, max_new_tokens=5, engine_config=engine,
            concurrency=2).take_all()
    finally:
        rt.shutdown()
    return {r["id"]: r for r in text}, repeat


@pytest.fixture(scope="module")
def runs():
    cfg = jl.LlamaConfig.tiny(n_layers=2, dtype=jnp.float32)
    jp = jl.init_params(cfg, jax.random.PRNGKey(7))
    params = (jp, convert.from_jax(jp, device="cpu"))
    return {pkg: _programs(pkg, params) for pkg in PACKAGES}


def test_batch_inference_text_prompts_on_the_cluster(runs):
    for pkg in PACKAGES:
        by_id = runs[pkg][0]
        assert sorted(by_id) == [0, 1, 2], pkg
        for i, row in by_id.items():
            assert len(row["generated"]) == 4, (pkg, row)
            assert isinstance(row["generated_text"], str)
            assert row["prompt"] == TEXT_ROWS[i]["prompt"]
    assert runs["ray_tpu_torch"][0] == runs["ray_tpu"][0]


def test_batch_inference_is_deterministic_per_prompt_on_the_cluster(runs):
    gens = {pkg: {tuple(r["generated"]) for r in runs[pkg][1]}
            for pkg in PACKAGES}
    for pkg in PACKAGES:
        assert len(runs[pkg][1]) == 6 and len(gens[pkg]) == 1, (pkg, gens)
    assert gens["ray_tpu_torch"] == gens["ray_tpu"]
    key = lambda r: (r["prompt"], tuple(r["generated"]))  # noqa: E731
    assert sorted(runs["ray_tpu_torch"][1], key=key) == \
        sorted(runs["ray_tpu"][1], key=key)
