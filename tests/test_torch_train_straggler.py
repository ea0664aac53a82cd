"""The port's cross-host straggler attribution, held to
``tests/test_train_straggler.py``'s assertions: one host of a 2-worker CPU
train is slowed through the env-armed fault point
``train.report.rank1=sleep:...``; host 0 compares the ranks' per-phase
step times each report and must surface the lag as
``train_phase_skew_s{phase,host}`` gauges and ONE ``train_straggler``
journal event naming host 1, trace-linked to the run. The event depends on
timing, so only the port's program runs here; the JAX package's runs in its
own file.

Deliberate differences, pinned here: the trainer is ``TorchTrainer`` (the
port has no ``JaxTrainer``), and the fault point is armed through the
port's ``util/fault_injector.py``, whose variable is ``RTPT_FAULT_INJECT``.
The ranks run uncoupled, as in the JAX test (per-step collectives would
equalise their step times). chip_smoke.py's phase 22e runs this program
a rank a card, each step a flash forward and backward.
"""

import os
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import train

SLEEP_S = 0.4
FAST_S = 0.05


@pytest.fixture(scope="module")
def straggler_rt():
    from ray_tpu_torch.util import fault_injector as fi
    # armed BEFORE init: node daemon + workers inherit the spec, and
    # fire() lazily reloads the env inside each worker process
    os.environ[fi.ENV_VAR] = f"train.report.rank1=sleep:{SLEEP_S}"
    rt.init(num_cpus=2, _system_config={
        "object_store_memory_bytes": 64 * 1024 * 1024,
        "metrics_export_period_s": 0.2,
    })
    yield rt
    rt.shutdown()
    os.environ.pop(fi.ENV_VAR, None)
    fi.reset()


def _make_loop():
    def loop(cfg):
        import time as _t

        ctx = train.get_context()
        t0 = _t.monotonic()
        # wall-clock bounded (not step-count) so the slowed rank ends
        # near the fast one despite ~9x slower steps
        while _t.monotonic() - t0 < cfg["run_s"]:
            _t.sleep(cfg["fast_s"])
            # rank 1's report() entry hits the armed sleep fault, so its
            # implicit 'step' phase runs ~(fast_s + sleep_s)
            train.report({"ok": 1})
    return loop


def test_the_trainer_and_fault_variable_are_the_ports():
    from ray_tpu_torch.util import fault_injector as fi
    assert hasattr(train, "TorchTrainer") and not hasattr(train,
                                                          "JaxTrainer")
    assert fi.ENV_VAR == "RTPT_FAULT_INJECT"


def test_one_slow_host_surfaces_as_straggler(straggler_rt, tmp_path):
    from ray_tpu_torch.core.worker import global_worker

    result = train.TorchTrainer(
        _make_loop(),
        train_loop_config={"run_s": 4.0, "fast_s": FAST_S},
        scaling_config=train.ScalingConfig(num_workers=2),
        run_config=train.RunConfig(
            name="straggle", storage_path=str(tmp_path))).fit()
    assert result.error is None, result.error
    # sanity: rank 0 got many fast steps in, so it ran the comparison
    # many times while rank 1's slowed windows were live in the KV
    assert result.metrics["_step"] > 20, result.metrics

    head = global_worker.backend.head

    # --- the journal names the lagging host, trace-linked to the run
    evs = []
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        evs = head.call("events_dump", {"type": "train_straggler"},
                        timeout=10)
        if evs:
            break
        time.sleep(0.3)
    assert evs, "train_straggler never reached the head journal"
    ev = evs[-1]
    assert ev["host"] == "1" and ev["rank"] == 1, ev
    assert ev["world_size"] == 2
    assert ev["trace_id"].startswith("train:"), ev
    factors = ev["slowdown_factors"]
    assert "step" in factors and factors["step"] > 2.0, factors
    # only ONE event per excursion: a persistent straggler must not
    # journal once per report (rank 0 reported dozens of times)
    assert len(evs) <= 2, [e["seq"] for e in evs]

    # --- the skew gauge attributes seconds-behind-fastest to host 1
    skew, agg = {}, {}
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        agg = head.call("metrics_dump", timeout=10) or {}
        skew = (agg.get("train_phase_skew_s") or {}).get("values", {})
        if any(k.endswith("|1") for k in skew):
            break
        time.sleep(0.3)
    assert skew, f"no train_phase_skew_s series in {sorted(agg)}"
    host1 = {k: v for k, v in skew.items() if k.endswith("|1")}
    assert host1, skew
    # host 1 lags by roughly the injected sleep (lenient: scheduling
    # noise, but it must be well clear of zero and of host 0's skew)
    assert max(host1.values()) > SLEEP_S / 2, host1
    host0 = {k: v for k, v in skew.items() if k.endswith("|0")}
    if host0:
        assert max(host0.values()) <= max(host1.values()), (host0, host1)
