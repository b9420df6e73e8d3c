"""The port's serving daemon against the JAX package's: the supervisor,
the drain, checkpoint loading, telemetry and profiling.

* **The supervisor.** The JAX ``GenerationService`` and the port's, each
  over a factory of ``tiny`` f32 engines (weights from ``JaxLM.init``)
  wired to its own package's ``ServingFaultPlan`` and ``FlightRecorder``,
  meet the same faults and are driven tick by tick (``do_run``), as the
  JAX tests do (``tests/unit/test_serving_faults.py``,
  ``test_flight_recorder.py``): a transient retry on the same engine; a
  fatal fault (one crash dump holding the in-flight row, fail fast, a
  rebuild); an exhausted restart budget (the breaker opens with its
  reason, stays open, and a probe after the cooldown recovers); the
  shutdown drain and its stragglers. The budget's window and the cooldown
  run on a fake clock (the port's ``clock`` argument; the JAX module's
  ``time`` replaced for the test). Outcomes, error texts, tokens, restart
  counts, the breaker and the serving state must be equal.
* **Checkpoints.** A missing, an unreadable and a wrong-preset checkpoint
  each leave the daemon up with no engine and the reason published. JAX
  trains ``tiny`` two steps and writes them to orbax;
  ``tools/torch_convert_checkpoint.py`` converts them, and the port's
  daemon then serves the saved weights, greedy tokens identical to the
  JAX engine's on the orbax checkpoint (both f32: the ``tiny`` preset's
  dtype is set to f32 in both packages for the test).
* **Telemetry and profiling.** The emitter's drop file has the JAX
  emitter's keys and layout (both statistics sources injected); the
  trace capture is single-flight and clamps its duration; with profiling
  off the config gate raises ``ProfileUnavailableError``.
"""
import dataclasses
import json
import os
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorhive_tpu import serving as jax_serving
from tensorhive_tpu import telemetry as jax_telemetry
from tensorhive_tpu import train as jax_train
from tensorhive_tpu.core.services import generation as jax_generation
from tensorhive_tpu.models.transformer import PRESETS as JAX_PRESETS
from tensorhive_tpu.models.transformer import TransformerLM as JaxLM
from tensorhive_tpu.serving import faults as jax_faults
from tensorhive_tpu.serving import flight_recorder as jax_flight
from tensorhive_tpu.serving.engine import SlotEngine as JaxSlotEngine
from tensorhive_tpu_torch import serving, telemetry, train
from tensorhive_tpu_torch.config import Config, GenerationConfig
from tensorhive_tpu_torch.convert import params_from_jax
from tensorhive_tpu_torch.core.services import generation
from tensorhive_tpu_torch.core.services.base import Service
from tensorhive_tpu_torch.models.transformer import PRESETS
from tensorhive_tpu_torch.observability import (
    get_request_ledger,
    parse_rendered,
    profiling,
)
from tensorhive_tpu_torch.serving import faults, flight_recorder
from tensorhive_tpu_torch.serving.engine import SlotEngine
from tools.torch_convert_checkpoint import convert


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tiny engines run thousands of small ops: one intra-op thread
    keeps them from contending with JAX and the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def clean_serving_state():
    """Both packages' process-wide serving planes start and end empty."""
    for package in (jax_serving, serving):
        package.set_engine(None)
        package.set_unavailable_reason(None)
    yield
    for package in (jax_serving, serving):
        package.set_engine(None)
        package.set_unavailable_reason(None)
        package.update_serving_state(supervisor_active=False,
                                     crash_loop=False, restarts=0,
                                     retry_after_s=None)


class FakeClock:
    def __init__(self, start: float = 1000.0) -> None:
        self.now = start

    def __call__(self) -> float:
        return self.now

    def advance(self, seconds: float) -> None:
        self.now += seconds


_PARAMS = {}


def weights():
    if not _PARAMS:
        jax_config = dataclasses.replace(
            JAX_PRESETS["tiny"], dtype=jnp.float32, use_flash=False,
            remat=False, max_seq_len=128)
        config = dataclasses.replace(PRESETS["tiny"], dtype=torch.float32,
                                     max_seq_len=128)
        jax_params = JaxLM.init(jax.random.PRNGKey(0), jax_config)
        params = params_from_jax(
            jax.tree_util.tree_map(np.asarray, jax_params), config,
            device="cpu")
        _PARAMS.update(jax=(jax_params, jax_config), port=(params, config))
    return _PARAMS


ENGINE = dict(slots=2, max_len=96, queue_depth=8, kv_quant="off",
              speculative="off")


class Side:
    """One package's daemon under test, with its plan, clock and the
    package modules the scenario reads."""

    def __init__(self, package, service, plan, clock, config_dir):
        self.package, self.service, self.plan = package, service, plan
        self.clock, self.config_dir = clock, config_dir
        self.faults = jax_faults if package == "jax" else faults
        self.serving = jax_serving if package == "jax" else serving
        self.flight = jax_flight if package == "jax" else flight_recorder


@pytest.fixture()
def supervised(config, db, tmp_path, monkeypatch):
    """``supervised(**generation_knobs)`` -> [JAX side, port side]; each a
    daemon over a plan-wired, recorded engine factory."""
    made = []

    def make(**knobs):
        sides = []
        for package in ("jax", "port"):
            clock = FakeClock()
            plan = (jax_faults if package == "jax"
                    else faults).ServingFaultPlan()
            params, model_config = weights()[package]
            knobs_ = dict(interval_s=0.05, transient_backoff_s=0.0,
                          restart_budget=2, restart_window_s=60.0,
                          restart_cooldown_s=5.0, **knobs)
            if package == "jax":
                for key, value in knobs_.items():
                    setattr(config.generation, key, value)
                monkeypatch.setattr(
                    jax_generation, "time",
                    types.SimpleNamespace(monotonic=clock, time=time.time,
                                          sleep=time.sleep))

                def factory(plan=plan):
                    return JaxSlotEngine(
                        *weights()["jax"], fault_plan=plan,
                        flight_recorder=jax_flight.FlightRecorder(64),
                        paged_kernel="off", **ENGINE)

                service = jax_generation.GenerationService(
                    config=config, engine=factory(), engine_factory=factory)
                config_dir = str(config.flightrec_dir)
            else:
                port_config = Config(config_dir=tmp_path / "port")
                port_config.generation = GenerationConfig(**knobs_)

                def factory(plan=plan):
                    return SlotEngine(
                        *weights()["port"], fault_plan=plan,
                        flight_recorder=flight_recorder.FlightRecorder(64),
                        device="cpu", **ENGINE)

                service = generation.GenerationService(
                    config=port_config, engine=factory(),
                    engine_factory=factory, clock=clock)
                config_dir = str(port_config.flightrec_dir)
            side = Side(package, service, plan, clock, config_dir)
            made.append(side)
            sides.append(side)
        return sides

    yield make
    for side in made:
        side.service.shutdown()


def pump_until_done(service, handle, ticks=50):
    for _ in range(ticks):
        if handle.done:
            return
        service.do_run()
    raise AssertionError("handle never finished")


def error_of(handle):
    with pytest.raises(RuntimeError) as info:
        handle.result(timeout_s=1)
    return str(info.value)


def both(make, scenario, **knobs):
    """Run ``scenario(side)`` on the JAX daemon and the port's; returns
    (JAX's result, the port's)."""
    jax_side, port_side = make(**knobs)
    return scenario(jax_side), scenario(port_side)


def transient_scenario(side):
    service, plan = side.service, side.plan
    engine = service.engine
    handle = engine.submit([1, 2, 3], max_new_tokens=4)
    plan.fail_next("step", 2, side.faults.TransientDispatchError)
    service.do_run()                       # transient retry 1 (no rebuild)
    service.do_run()                       # transient retry 2
    pump_until_done(service, handle)
    summary = handle.result(timeout_s=5)
    return (service.engine is engine, side.serving.get_serving_state(),
            summary["outcome"], summary["tokens"],
            plan.faults_injected["step"])


def test_transient_fault_retries_on_the_same_engine_like_jax(supervised):
    theirs, ours = both(supervised, transient_scenario)
    assert ours == theirs
    assert ours[0] is True and ours[1]["restarts"] == 0
    assert ours[2] == "completed"


def fatal_scenario(side):
    service, plan = side.service, side.plan
    first = service.engine
    doomed = first.submit([1, 2, 3, 4], max_new_tokens=8)
    plan.fail_next("step", 1)              # the first decode dispatch dies
    service.do_run()                       # fatal -> dump -> fail fast ->
    message = error_of(doomed)             # rebuild
    rebuilt = side.serving.get_engine()
    dumps = side.flight.list_crash_dumps(side.config_dir)
    dump = side.flight.load_crash_dump(side.config_dir, dumps[0]["file"])
    inflight = {row["requestId"]: row for row in dump["inFlight"]}
    handle = rebuilt.submit(list(range(5, 13)), max_new_tokens=6)
    pump_until_done(service, handle)
    return (message, rebuilt is not None and rebuilt is not first,
            service.engine is rebuilt, side.serving.get_serving_state(),
            len(dumps), dump["reason"], dump["ticks"][-1]["faults"],
            inflight[doomed.request_id]["outcome"],
            handle.result(timeout_s=5)["tokens"])


def test_fatal_fault_fails_fast_dumps_once_and_rebuilds_like_jax(
        supervised):
    theirs, ours = both(supervised, fatal_scenario)
    assert ours == theirs
    message, rebuilt, published, state, dumps, reason, faulted, outcome, _ \
        = ours
    assert "restarting" in message and rebuilt and published
    assert state["restarts"] == 1 and state["crash_loop"] is False
    assert dumps == 1 and "DeviceLostError" in reason and faulted == 1
    assert outcome is None        # the dump precedes the fail-fast


def crash_loop_scenario(side):
    service, plan = side.service, side.plan
    plan.set_device_lost(True)
    messages = []
    for _ in range(3):      # budget 2: the third fatal trips the breaker
        handle = side.serving.get_engine().submit([1, 2, 3],
                                                  max_new_tokens=4)
        service.do_run()
        messages.append(error_of(handle))
    tripped = (side.serving.get_engine(), side.serving.get_serving_state(),
               side.serving.get_unavailable_reason())
    service.do_run()                       # breaker open: no rebuild yet
    still_open = side.serving.get_engine()
    plan.set_device_lost(False)
    side.clock.advance(5.0 + 0.01)         # the cooldown elapses
    service.do_run()                       # the probe rebuild
    rebuilt = side.serving.get_engine()
    handle = rebuilt.submit([7, 8, 9, 10], max_new_tokens=5)
    pump_until_done(service, handle)
    return (messages, tripped, still_open, rebuilt is not None,
            side.serving.get_serving_state(),
            handle.result(timeout_s=5)["tokens"],
            len(side.flight.list_crash_dumps(side.config_dir)))


def test_exhausted_restart_budget_trips_the_breaker_like_jax(supervised):
    theirs, ours = both(supervised, crash_loop_scenario)
    assert ours == theirs
    messages, (engine, state, reason), still_open, rebuilt, after, _, _ = \
        ours
    assert all("restarting" in m for m in messages)
    assert engine is None and still_open is None and rebuilt
    assert state["crash_loop"] is True and state["retry_after_s"] == 5.0
    assert reason.startswith("serving engine crash loop: 2 restarts")
    assert after["crash_loop"] is False and after["restarts"] == 3


@pytest.mark.parametrize("drain_timeout_s", [30.0, 0.0])
def test_shutdown_drains_then_fails_stragglers_like_jax(supervised,
                                                        drain_timeout_s):
    def scenario(side):
        handle = side.service.engine.submit([1, 2, 3, 4], max_new_tokens=4)
        side.service.shutdown()            # no pump thread: shutdown pumps
        try:
            result = handle.result(timeout_s=1)["tokens"]
        except RuntimeError as exc:
            result = str(exc)
        return (result, side.serving.get_engine(),
                side.serving.get_serving_state())

    theirs, ours = both(supervised, scenario, drain_timeout_s=drain_timeout_s)
    assert ours == theirs
    assert ours[1] is None and ours[2]["supervisor_active"] is False
    if drain_timeout_s:
        assert isinstance(ours[0], list) and len(ours[0]) == 4
    else:
        assert "shutting down" in ours[0]


def test_fatal_without_recorder_writes_no_dump(tmp_path):
    config = Config(config_dir=tmp_path)
    config.generation = GenerationConfig(transient_backoff_s=0.0)
    plan = faults.ServingFaultPlan()

    def factory():
        return SlotEngine(*weights()["port"], fault_plan=plan, device="cpu",
                          **ENGINE)

    service = generation.GenerationService(config=config, engine=factory(),
                                           engine_factory=factory)
    try:
        plan.fail_next("step", 1)
        service.engine.submit([1, 2], max_new_tokens=2)
        service.do_run()
        assert flight_recorder.list_crash_dumps(
            str(config.flightrec_dir)) == []
        assert serving.get_serving_state()["restarts"] == 1
    finally:
        service.shutdown()


def test_dead_engine_releases_its_device_state(supervised):
    _, side = supervised()
    first = side.service.engine
    held = first.submit([1, 2, 3], max_new_tokens=4)   # a client's handle
    side.plan.fail_next("step", 1)
    side.service.do_run()
    error_of(held)
    assert first.params is None and first._cache is None
    assert held._engine is first                       # still referenced
    assert first.stats()["slotsBusy"] == 0             # host state readable


def test_daemon_thread_serves_concurrent_clients(tmp_path):
    """The pump on its own thread: 4 client threads submit under their own
    user keys; every stream completes with the tokens a bare engine gives
    for its prompt alone, and the ledger holds one completed row each."""
    config = Config(config_dir=tmp_path)
    config.generation = GenerationConfig(interval_s=0.02)
    factory = lambda: SlotEngine(*weights()["port"], device="cpu",  # noqa
                                 **ENGINE)
    prompts = [[3 + i, 9, 11 + i, 4] for i in range(8)]
    bare = factory()
    expected = []
    for prompt in prompts:
        handle = bare.submit(prompt, max_new_tokens=5)
        bare.pump()
        expected.append(handle.result(timeout_s=5)["tokens"])
    service = generation.GenerationService(config=config, engine=factory(),
                                           engine_factory=factory)
    ledger = get_request_ledger()
    ledger.clear()
    results = {}

    def client(index):
        for n in (index, index + 4):
            handle = service.engine.submit(prompts[n], max_new_tokens=5,
                                           user_key=f"user{index}")
            results[n] = (handle.request_id,
                          handle.result(timeout_s=30)["tokens"])

    service.start()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=60)
    service.shutdown()
    service.join(timeout=10)
    assert not service.is_alive()
    assert not any(thread.is_alive() for thread in threads)
    assert [results[n][1] for n in range(8)] == expected
    rows = {row["requestId"]: row for row in ledger.recent()}
    assert all(rows[rid]["outcome"] == "completed"
               for rid, _ in results.values())
    assert service.ticks_completed > 0
    assert service.tick_latency_stats()["max"] is not None


def test_service_base_ticks_and_counts_overruns():
    class Slow(Service):
        def __init__(self):
            super().__init__(interval_s=0.005, name="slow-test")
            self.calls = 0

        def do_run(self):
            self.calls += 1
            if self.calls == 2:
                raise RuntimeError("one bad tick")
            self.wait(0.006)                            # past the interval

    from tensorhive_tpu_torch.observability import get_registry

    service = Slow()
    service.start()
    deadline = time.monotonic() + 10
    while service.ticks_completed < 4 and time.monotonic() < deadline:
        time.sleep(0.005)
    service.shutdown()
    service.join(timeout=10)
    assert not service.is_alive() and service.ticks_completed >= 4
    assert service.tick_overruns >= 1
    samples = parse_rendered(get_registry().render())
    assert samples['tpuhive_service_tick_failures_total'
                   '{service="slow-test"}'] >= 1
    assert samples['tpuhive_service_ticks_total{service="slow-test"}'] >= 4


# -- checkpoints --------------------------------------------------------------------

def daemon_with_checkpoint(tmp_path, path, preset="tiny"):
    config = Config(config_dir=tmp_path)
    config.generation = GenerationConfig(
        preset=preset, checkpoint_path=str(path), slots=2, max_len=64,
        kv_quant="off", speculative="off")
    return generation.GenerationService(config=config, device="cpu")


def assert_down_with_reason(service, *fragments):
    assert service.engine is None and serving.get_engine() is None
    reason = serving.get_unavailable_reason()
    for fragment in fragments:
        assert fragment in reason, reason
    service.do_run()                       # no factory success: still down
    return reason


def test_missing_checkpoint_leaves_the_daemon_up_like_jax(config, db,
                                                          tmp_path):
    missing = tmp_path / "nowhere"
    config.generation.checkpoint_path = str(missing / "jax")
    config.generation.use_flash = False
    jax_service = jax_generation.GenerationService(config=config)
    jax_reason = jax_serving.get_unavailable_reason()
    assert jax_service.engine is None and jax_reason.startswith(
        "no checkpoint steps under")
    service = daemon_with_checkpoint(tmp_path, missing / "port")
    reason = assert_down_with_reason(service, str(missing / "port"))
    assert reason.startswith("no checkpoint steps under")
    assert serving.get_serving_state()["supervisor_active"] is True


def test_unreadable_checkpoint_leaves_the_daemon_up(tmp_path):
    directory = tmp_path / "ckpt"
    directory.mkdir()
    (directory / "step_0000000003.pt").write_bytes(b"not a torch file")
    service = daemon_with_checkpoint(tmp_path, directory)
    assert_down_with_reason(service, "cannot read checkpoint", str(directory))


def test_wrong_preset_checkpoint_names_the_mismatches(tmp_path):
    config = dataclasses.replace(PRESETS["tiny"], dtype=torch.float32)
    params, opt_state = train.init_train_state(
        config, train.TrainConfig(), device="cpu")
    train.save_checkpoint(str(tmp_path / "ckpt"), 5, params, opt_state)
    service = daemon_with_checkpoint(tmp_path, tmp_path / "ckpt",
                                     preset="t2t-base")
    reason = assert_down_with_reason(
        service, "does not fit preset params (57 mismatches)",
        "blocks[2].attn_norm.scale missing")
    with pytest.raises(serving.CheckpointLoadError,
                       match=r"\(2 mismatches\): tok_embed shape "
                             r"\(512, 64\) != expected \(1024, 64\); "
                             r"w_lm_head shape"):
        generation.load_checkpoint_params(
            str(tmp_path / "ckpt"), dataclasses.replace(
                PRESETS["tiny"], vocab_size=1024), device="cpu")
    # the same file fits its own preset
    step, loaded = generation.load_checkpoint_params(
        str(tmp_path / "ckpt"), PRESETS["tiny"], device="cpu")
    assert step == 5 and loaded["tok_embed"].dtype == torch.bfloat16
    assert torch.equal(loaded["blocks"][1]["wq"],
                       params["blocks"][1]["wq"].to(torch.bfloat16))
    assert loaded["final_norm"]["scale"].dtype == torch.float32


def test_converted_orbax_checkpoint_serves_the_jax_tokens(
        config, db, tmp_path, monkeypatch):
    """JAX trains two steps (seeded 3, so the weights differ from any
    seed-0 init) and writes orbax; the converter writes step_<n>.pt; the
    port's daemon serves it with JAX's greedy tokens."""
    monkeypatch.setitem(JAX_PRESETS, "tiny", dataclasses.replace(
        JAX_PRESETS["tiny"], dtype=jnp.float32))
    monkeypatch.setitem(PRESETS, "tiny", dataclasses.replace(
        PRESETS["tiny"], dtype=torch.float32))
    jax_config = dataclasses.replace(JAX_PRESETS["tiny"], use_flash=False,
                                     remat=False)
    tc = jax_train.TrainConfig(batch_size=2, seq_len=16, warmup_steps=1,
                               total_steps=10)
    params, opt_state = jax_train.init_train_state(
        jax.random.PRNGKey(3), jax_config, tc)
    step_fn = jax_train.make_train_step(jax_config, tc)
    key = jax.random.PRNGKey(1)
    for _ in range(2):
        key, data_key = jax.random.split(key)
        params, opt_state, _ = step_fn(
            params, opt_state,
            jax_train.synthetic_batch(data_key, tc, jax_config.vocab_size))
    orbax_dir, torch_dir = tmp_path / "orbax", tmp_path / "torch"
    jax_train.save_checkpoint(str(orbax_dir), 2, params, opt_state)
    assert convert(str(orbax_dir), str(torch_dir), "tiny") == 2
    assert train.checkpoint_steps(torch_dir) == [2]

    knobs = dict(preset="tiny", slots=2, max_len=64, kv_quant="off",
                 speculative="off")
    for key_, value in knobs.items():
        setattr(config.generation, key_, value)
    config.generation.use_flash = False
    config.generation.checkpoint_path = str(orbax_dir)
    jax_engine = jax_generation.build_engine(config)
    service = daemon_with_checkpoint(tmp_path, torch_dir)
    engine = service.engine
    assert engine is not None and serving.get_engine() is engine
    for name in ("tok_embed", "w_lm_head"):
        np.testing.assert_array_equal(engine.params[name].numpy(),
                                      np.asarray(params[name]))
    prompt = [5, 17, 33, 2, 9, 41, 7]
    tokens = []
    for served in (jax_engine, engine):
        handle = served.submit(prompt, max_new_tokens=8)
        served.pump()
        tokens.append(handle.result(timeout_s=5)["tokens"])
    assert tokens[1] == tokens[0]
    # the converted file resumes training too: Adam's state came across
    port_config = dataclasses.replace(PRESETS["tiny"])
    like_params, like_opt = train.init_train_state(
        port_config, train.TrainConfig(), device="cpu")
    step, _, restored = train.restore_checkpoint(str(torch_dir), like_params,
                                                 like_opt)
    assert step == 2 and restored["count"] == 2
    assert float(restored["nu"]["tok_embed"].abs().sum()) > 0


# -- build_engine ---------------------------------------------------------------------

def test_build_engine_wires_ledger_recorder_and_meter(tmp_path):
    from tensorhive_tpu_torch import config as port_config
    from tensorhive_tpu_torch.observability import accounting

    small = dict(preset="tiny", slots=2, max_len=64, speculative="off")
    engine = generation.build_engine(
        GenerationConfig(request_ledger_size=7, flightrec_ticks=33,
                         **small), device="cpu")
    assert get_request_ledger().capacity == 7
    assert engine.flight_recorder.capacity == 33
    assert engine.tenant_meter is accounting.get_tenant_meter()
    assert engine.tenant_meter is not None
    disabled = Config()
    disabled.accounting.enabled = False
    port_config.set_config(disabled)
    accounting.set_tenant_meter(None)
    try:
        engine = generation.build_engine(
            GenerationConfig(flight_recorder=False, **small), device="cpu")
        assert engine.flight_recorder is None and engine.tenant_meter is None
    finally:
        port_config.reset_config()
        accounting.set_tenant_meter(None)
        get_request_ledger().set_capacity(256)
    for bad in (dict(request_ledger_size=0), dict(flightrec_ticks=0)):
        with pytest.raises(ValueError):
            generation.build_engine(GenerationConfig(**bad, **small),
                                    device="cpu")


@pytest.mark.parametrize("ticks", [1, 33])
def test_build_flight_recorder_matches_jax(config, ticks):
    config.generation.flightrec_ticks = ticks
    ours = generation.build_flight_recorder(
        GenerationConfig(flightrec_ticks=ticks))
    theirs = jax_generation.build_flight_recorder(config.generation)
    assert ours.capacity == theirs.capacity == ticks
    assert generation.build_flight_recorder(
        GenerationConfig(flight_recorder=False)) is None


def test_config_defaults_match_jax(config):
    theirs = config.generation
    ours = GenerationConfig()
    for field in dataclasses.fields(ours):
        assert getattr(ours, field.name) == getattr(theirs, field.name), \
            field.name
    for section in ("accounting", "profiling"):
        assert dataclasses.asdict(getattr(Config(), section)) == \
            dataclasses.asdict(getattr(config, section))
    port = Config(config_dir=config.config_dir)
    assert port.flightrec_dir == config.flightrec_dir
    assert port.profile_artifact_dir == config.profile_artifact_dir


# -- telemetry ----------------------------------------------------------------------

def fake_stats(device):
    return {"bytes_in_use": 1234 + (device.index or 0),
            "bytes_limit": 80 << 30}


def test_emitter_drop_file_has_the_jax_layout(tmp_path, monkeypatch):
    class FakeJaxDevice:
        local_hardware_id = 0

        def memory_stats(self):
            return fake_stats(torch.device("cpu"))

    monkeypatch.setattr(jax, "local_devices", lambda: [FakeJaxDevice()])
    theirs = jax_telemetry.TelemetryEmitter(
        name="jax", metrics_dir=str(tmp_path), min_write_interval_s=0.0)
    ours = telemetry.TelemetryEmitter(
        name="port", metrics_dir=str(tmp_path), min_write_interval_s=0.0,
        device="cpu", memory_stats=fake_stats)
    for emitter in (theirs, ours):
        emitter.sample(step_time_s=0.01)
        emitter.sample(step_time_s=0.01)
    with open(theirs.path) as handle:
        jax_payload = json.load(handle)
    with open(ours.path) as handle:
        payload = json.load(handle)
    assert ours.path.name == f"port-{os.getpid()}.json"
    assert set(payload) == set(jax_payload) == {"0"}
    assert set(payload["0"]) == set(jax_payload["0"])
    assert payload["0"]["hbm_used_bytes"] == jax_payload["0"][
        "hbm_used_bytes"] == 1234
    assert payload["0"]["hbm_total_bytes"] == 80 << 30
    assert 0.0 <= payload["0"]["duty_cycle_pct"] <= 100.0
    samples = parse_rendered(
        __import__("tensorhive_tpu_torch.observability",
                   fromlist=["get_registry"]).get_registry().render())
    assert samples['tpuhive_workload_hbm_used_bytes{device="0"}'] == 1234
    ours.close()
    assert not ours.path.exists()


def test_emitter_counts_a_device_without_memory_stats(tmp_path):
    from tensorhive_tpu_torch.observability import get_registry

    def failures():
        return parse_rendered(get_registry().render()).get(
            "tpuhive_workload_memory_stats_failures_total", 0.0)

    before = failures()
    emitter = telemetry.TelemetryEmitter(metrics_dir=str(tmp_path),
                                         min_write_interval_s=0.0,
                                         device="cpu")
    metrics = emitter.sample()
    assert metrics == {"0": {"hbm_used_bytes": None,
                             "hbm_total_bytes": None,
                             "duty_cycle_pct": None}}
    assert failures() == before + 1


# -- profiling ----------------------------------------------------------------------

def test_capture_writes_a_chrome_trace_and_records_a_span(tmp_path):
    from tensorhive_tpu_torch.observability import get_tracer

    def busy_sleep(seconds):
        operand = torch.ones(32, 32)
        until = time.monotonic() + seconds
        while time.monotonic() < until:
            torch.mm(operand, operand)

    result = profiling.capture_trace(str(tmp_path / "profiles"),
                                     duration_s=0.05, sleep=busy_sleep,
                                     tracer=get_tracer())
    assert result["bytes"] > 0 and result["durationS"] >= 0.05
    assert any(name.startswith("trace-") and name.endswith(".json")
               for name in result["files"])
    trace = json.loads((tmp_path / "profiles" / result["files"][0])
                       .read_text())
    assert any(event.get("name") == "aten::mm"
               for event in trace["traceEvents"])
    assert get_tracer().recent(kind="profile")[-1]["name"] == \
        "profile.capture"


def test_capture_is_single_flight_and_clamped(tmp_path):
    entered, release = threading.Event(), threading.Event()

    def slow_sleep(_duration):
        entered.set()
        assert release.wait(timeout=10)

    results = {}

    def first():
        results["first"] = profiling.capture_trace(
            str(tmp_path / "a"), duration_s=0.01, sleep=slow_sleep)

    thread = threading.Thread(target=first)
    thread.start()
    assert entered.wait(timeout=10)
    assert profiling.capture_in_flight()
    with pytest.raises(profiling.ProfileInFlightError):
        profiling.capture_trace(str(tmp_path / "b"), duration_s=0.01)
    release.set()
    thread.join(timeout=10)
    assert not thread.is_alive() and results["first"]["bytes"] > 0
    assert not profiling.capture_in_flight()
    for duration, ceiling in ((0.0, 10.0), (11.0, 10.0), (61.0, 100.0)):
        with pytest.raises(ValueError):
            profiling.capture_trace(str(tmp_path), duration_s=duration,
                                    max_duration_s=ceiling)


def test_profiling_off_is_unavailable(tmp_path):
    config = Config(config_dir=tmp_path)
    with pytest.raises(profiling.ProfileUnavailableError):
        profiling.capture_from_config(config, duration_s=0.01)
    config.profiling.enabled = True
    result = profiling.capture_from_config(config, duration_s=0.01)
    assert result["artifactDir"] == str(tmp_path / "profiles")
    with pytest.raises(ValueError):
        profiling.capture_from_config(config, duration_s=11.0)
    with pytest.raises(profiling.ProfileUnavailableError):
        profiling.device_memory_summary()           # no card here


def test_hbm_collector_is_inert_without_profiling_or_a_card(tmp_path):
    """The live-bytes gauge is refreshed at scrape time only while the
    port config enables profiling and CUDA is initialized: here neither
    path writes a child."""
    from tensorhive_tpu_torch import config as port_config
    from tensorhive_tpu_torch.observability import get_registry

    def children():
        family = get_registry().get("tpuhive_device_hbm_live_bytes")
        return [] if family is None else family.children()

    before = children()
    get_registry().render()
    config = Config(config_dir=tmp_path)
    config.profiling.enabled = True
    port_config.set_config(config)
    try:
        get_registry().render()
    finally:
        port_config.reset_config()
    assert children() == before == []
