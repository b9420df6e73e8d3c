"""The port's serving observability against the JAX package's: the metrics
registry, the span tracer, the request ledger, the tenant meter and the
flight recorder, alone and wired into the engine.

* **The copied containers.** Each case of the JAX unit tests of these
  modules (``tests/unit/test_requests_ledger.py``,
  ``test_flight_recorder.py``, ``test_accounting.py``) runs on the JAX
  class and on the port's, as one parametrised test (``pkg``); the
  registry's text exposition of the same writes is equal line for line.
* **Engine parity.** One f32 ``tiny`` schedule runs through the JAX
  ``SlotEngine`` and the port's, each with a fresh ledger, tracer and
  registry, a ``TenantMeter`` and a ``FlightRecorder``, on its own
  ``FakeClock`` advanced alike: a miss in three chunks, a prefix hit, a
  rate-limit and a queue-full rejection, a cancel in the queue and one
  mid-decode, a deadline timeout and, with int8 pages, KV tiering (two
  prompts churn the first one's pages out to the host store, then a host
  hit; both engines on a synchronous copy lane). int8 pages on and off.
  Equal: the ledger rows field by field (request ids by their order, wall
  stamps as their difference), the spans (names, request ids,
  durations, attributes), the ``parse_rendered`` value of every sample of
  every ``tpuhive_generate_*`` family, the meter's per-tenant totals and
  the recorder's ticks field by field (less the wall stamp ``ts``). The
  JAX engine runs the schedule once before, so its compile events are a
  warm engine's ("hit", 0 compiles), which is what the port records.
* **Off path.** With recorder and meter ``None`` the port's engine gives
  the same tokens, counters and launches as with them on, and JAX's
  tokens; ``busySlotSeconds`` is null.

Weights come from ``JaxLM.init`` and are carried across.
"""
import dataclasses
import json
import logging
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorhive_tpu.observability as jax_observability
from tensorhive_tpu.models.transformer import PRESETS as JAX_PRESETS
from tensorhive_tpu.models.transformer import TransformerLM as JaxLM
from tensorhive_tpu.observability import accounting as jax_accounting
from tensorhive_tpu.observability import metrics as jax_metrics
from tensorhive_tpu.observability import requests as jax_requests
from tensorhive_tpu.observability import tracing as jax_tracing
from tensorhive_tpu.serving import QueueFullError as JaxQueueFullError
from tensorhive_tpu.serving import RateLimitError as JaxRateLimitError
from tensorhive_tpu.serving import flight_recorder as jax_flight
from tensorhive_tpu.serving import paging as jax_paging
from tensorhive_tpu.serving.engine import SlotEngine as JaxSlotEngine
import tensorhive_tpu_torch.observability as observability
from tensorhive_tpu_torch import config as port_config
from tensorhive_tpu_torch import serving
from tensorhive_tpu_torch.convert import params_from_jax
from tensorhive_tpu_torch.models.transformer import PRESETS
from tensorhive_tpu_torch.observability import accounting
from tensorhive_tpu_torch.observability import metrics
from tensorhive_tpu_torch.observability import requests
from tensorhive_tpu_torch.observability import tracing
from tensorhive_tpu_torch.serving import QueueFullError, RateLimitError
from tensorhive_tpu_torch.serving import flight_recorder
from tensorhive_tpu_torch.serving.engine import SlotEngine
from tensorhive_tpu_torch.serving.paging import LaneJob

PKGS = {
    "jax": types.SimpleNamespace(
        metrics=jax_metrics, tracing=jax_tracing, requests=jax_requests,
        accounting=jax_accounting, flight=jax_flight),
    "port": types.SimpleNamespace(
        metrics=metrics, tracing=tracing, requests=requests,
        accounting=accounting, flight=flight_recorder),
}
both_packages = pytest.mark.parametrize("pkg", sorted(PKGS))
#: the port recorder's phase columns, in the order they tile a tick
PHASE_COLUMNS = ("admitS", "prefillS", "dispatchS", "waitS", "applyS")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tiny engines run thousands of small ops: one intra-op thread
    keeps them from contending with JAX and the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class FakeClock:
    def __init__(self, start: float = 1000.0) -> None:
        self.now = start

    def __call__(self) -> float:
        return self.now

    def advance(self, seconds: float) -> None:
        self.now += seconds


# -- the registry --------------------------------------------------------------

def fill_registry(registry):
    requests_total = registry.counter("tpuhive_x_requests_total",
                                      "Requests by outcome.",
                                      labels=("outcome",))
    requests_total.labels(outcome="completed").inc(3)
    requests_total.labels(outcome='quote"back\\slash\nline').inc()
    registry.gauge("tpuhive_x_depth", "Queue depth.").set(2.5)
    latency = registry.histogram("tpuhive_x_seconds", "Latency.",
                                 labels=("phase",), buckets=(0.1, 1.0))
    for value in (0.05, 0.5, 5.0):
        latency.labels(phase="queue").observe(value)
    registry.counter("tpuhive_x_unused_total", "Never written.")
    return requests_total


def test_render_matches_jax_line_for_line():
    ours, theirs = metrics.MetricsRegistry(), jax_metrics.MetricsRegistry()
    fill_registry(ours)
    fill_registry(theirs)
    text = ours.render()
    assert text == theirs.render()
    assert "tpuhive_x_unused_total" not in text       # no children: skipped
    parsed = metrics.parse_rendered(text)
    assert parsed == jax_metrics.parse_rendered(text)
    assert parsed['tpuhive_x_seconds_bucket{phase="queue",le="1"}'] == 2
    assert parsed['tpuhive_x_seconds_bucket{phase="queue",le="+Inf"}'] == 3
    assert parsed['tpuhive_x_requests_total{outcome="completed"}'] == 3


@both_packages
def test_registration_is_idempotent_and_type_checked(pkg):
    registry = PKGS[pkg].metrics.MetricsRegistry()
    family = registry.counter("tpuhive_y_total", labels=("a",))
    assert registry.counter("tpuhive_y_total", labels=("a",)) is family
    with pytest.raises(ValueError):
        registry.gauge("tpuhive_y_total", labels=("a",))
    with pytest.raises(ValueError):
        registry.counter("tpuhive_y_total", labels=("b",))
    with pytest.raises(ValueError):
        family.labels(b="1")
    with pytest.raises(ValueError):
        family.labels(a="1").inc(-1)


@both_packages
def test_reset_keeps_children_and_collectors_run(pkg):
    registry = PKGS[pkg].metrics.MetricsRegistry()
    child = fill_registry(registry).labels(outcome="completed")
    calls = []

    def collector(reg):
        calls.append(reg)

    def broken(_reg):
        raise RuntimeError("collector down")

    registry.register_collector(collector)
    registry.register_collector(collector)           # idempotent
    registry.register_collector(broken)
    registry.reset_values()
    child.inc()                                       # the handle still works
    samples = PKGS[pkg].metrics.parse_rendered(registry.render())
    assert samples['tpuhive_x_requests_total{outcome="completed"}'] == 1
    assert samples["tpuhive_x_depth"] == 0
    assert calls == [registry]


def test_process_metrics_and_histogram_quantiles_match_jax():
    ours, theirs = metrics.MetricsRegistry(), jax_metrics.MetricsRegistry()
    metrics.register_process_metrics(ours, "v")
    jax_metrics.register_process_metrics(theirs, "v")
    names = [family.name for family in ours.families()]
    assert names == [family.name for family in theirs.families()]
    assert 'tpuhive_build_info{version="v"} 1' in ours.render()
    hist, jax_hist = metrics.Histogram(), jax_metrics.Histogram()
    for value in np.random.default_rng(0).exponential(0.2, 200):
        hist.observe(value)
        jax_hist.observe(value)
    for q in (0.0, 0.5, 0.95, 1.0):
        assert hist.quantile(q) == jax_hist.quantile(q)


# -- the tracer ------------------------------------------------------------------

@both_packages
def test_spans_nest_per_thread_and_dump_in_completion_order(pkg):
    tracer = PKGS[pkg].tracing.SpanTracer(capacity=3)
    with tracer.span("outer", kind="tick") as outer:
        with tracer.span("inner") as inner:
            assert inner.parent_id == outer.span_id
        other = []
        thread = threading.Thread(
            target=lambda: other.append(tracer.start_span("elsewhere")))
        thread.start()
        thread.join(timeout=10)
        assert other[0].parent_id is None             # stacks are per thread
    tracer.record_span("after", start_ts=1.0, duration_s=0.25,
                       request_id="r1")
    with pytest.raises(KeyError):
        with tracer.span("failing"):
            raise KeyError("x")
    spans = tracer.recent()
    assert [s["name"] for s in spans] == ["outer", "after", "failing"]
    assert [s["seq"] for s in spans] == sorted(s["seq"] for s in spans)
    assert spans[1]["durationMs"] == 250.0
    assert spans[1]["attrs"] == {"request_id": "r1"}
    assert spans[2]["status"] == "error"
    assert len(tracer) == 3 and tracer.recent(kind="tick")[0]["name"] == \
        "outer"


@both_packages
def test_span_log_filter_stamps_the_current_span(pkg):
    tracer = PKGS[pkg].tracing.SpanTracer()
    log_filter = PKGS[pkg].tracing.SpanLogFilter(tracer)
    record = logging.LogRecord("x", logging.INFO, __file__, 1, "m", (), None)
    log_filter.filter(record)
    assert record.span_id == ""
    with tracer.span("tick") as span:
        log_filter.filter(record)
        assert record.span_id == span.span_id


# -- the ledger ------------------------------------------------------------------

@both_packages
def test_ring_evicts_oldest_at_capacity(pkg):
    ledger = PKGS[pkg].requests.RequestLedger(capacity=3)
    for index in range(5):
        record = ledger.begin(f"req-{index}", prompt_tokens=1,
                              max_new_tokens=1, temperature=0.0)
        ledger.finish(record, "completed")
    assert len(ledger) == 3
    assert [row["requestId"] for row in ledger.recent()] == [
        "req-4", "req-3", "req-2"]
    assert ledger.get("req-0") is None
    assert ledger.get("req-4") is not None


@both_packages
def test_finish_is_exactly_once_and_discard_drops(pkg):
    ledger = PKGS[pkg].requests.RequestLedger(capacity=4)
    record = ledger.begin("req-a", prompt_tokens=1, max_new_tokens=1,
                          temperature=0.0)
    ledger.finish(record, "completed")
    ledger.finish(record, "cancelled")              # racing cancel: ignored
    rows = ledger.recent()
    assert len(rows) == 1 and rows[0]["outcome"] == "completed"
    dropped = ledger.begin("req-b", prompt_tokens=1, max_new_tokens=1,
                           temperature=0.0)
    assert ledger.in_flight()[0]["requestId"] == "req-b"
    ledger.discard(dropped)
    assert ledger.in_flight() == []


@both_packages
def test_set_capacity_rebounds_and_keeps_newest(pkg):
    ledger = PKGS[pkg].requests.RequestLedger(capacity=8)
    for index in range(6):
        record = ledger.begin(f"req-{index}", prompt_tokens=1,
                              max_new_tokens=1, temperature=0.0,
                              user_key="u" if index % 2 else None)
        ledger.finish(record, "completed" if index < 5 else "timeout")
    assert [r["requestId"] for r in ledger.recent(user="u")] == [
        "req-5", "req-3", "req-1"]
    assert [r["requestId"] for r in ledger.recent(outcome="timeout")] == [
        "req-5"]
    ledger.set_capacity(2)
    assert [row["requestId"] for row in ledger.recent()] == ["req-5",
                                                             "req-4"]
    with pytest.raises(ValueError):
        ledger.set_capacity(0)


@both_packages
def test_cross_thread_begin_finish_isolation(pkg):
    ledger = PKGS[pkg].requests.RequestLedger(capacity=64)
    errors = []

    def worker():
        try:
            for _ in range(25):
                request_id = ledger.new_request_id()
                record = ledger.begin(request_id, prompt_tokens=2,
                                      max_new_tokens=2, temperature=0.0)
                record.tokens = 2
                ledger.finish(record, "completed")
        except Exception as exc:  # pragma: no cover - failure path
            errors.append(exc)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=10)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(ledger) == 64                        # 100 finished, ring-bound
    ids = [row["requestId"] for row in ledger.recent()]
    assert len(set(ids)) == len(ids)
    assert not ledger.in_flight()


def test_record_rows_have_the_jax_fields():
    kwargs = dict(request_id="r", submitted_ts=5.0, prompt_tokens=3,
                  max_new_tokens=4, temperature=0.5, user_key="u")
    ours = requests.RequestRecord(**kwargs)
    theirs = jax_requests.RequestRecord(**kwargs)
    for record in (ours, theirs):
        record.draft_tokens, record.accepted_tokens = 8, 6
        record._gaps_ms.extend([1.0, 3.0, 2.0])
        record.device_seconds = 0.1234567
    assert ours.to_dict() == theirs.to_dict()
    assert requests.OUTCOMES == jax_requests.OUTCOMES


# -- the flight recorder ---------------------------------------------------------

@both_packages
def test_ring_records_and_wraps_with_fixed_capacity(pkg):
    recorder = PKGS[pkg].flight.FlightRecorder(capacity=4)
    for tick in range(10):
        recorder.record(duration_s=0.001 * tick, admitted=tick,
                        ts=float(tick))
    assert recorder.recorded == 10 and len(recorder) == 4
    rows = recorder.snapshot()
    assert [r["tick"] for r in rows] == [6, 7, 8, 9]
    assert [r["admitted"] for r in rows] == [6, 7, 8, 9]
    assert rows[-1]["durationS"] == pytest.approx(0.009)


@both_packages
def test_snapshot_limit_and_field_names(pkg):
    recorder = PKGS[pkg].flight.FlightRecorder(capacity=8)
    recorder.record(duration_s=0.5, admitted=1, prefill_chunks=2,
                    decode_slots=3, slots_busy=4, queue_depth=5,
                    pages_free=6, compiles=7, faults=8,
                    host_demotions=9, host_promotions=10, ts=1.0)
    recorder.record(duration_s=0.25, ts=2.0)
    rows = recorder.snapshot(last_n=1)
    assert len(rows) == 1 and rows[0]["tick"] == 1
    expected = {
        "tick": 0, "ts": 1.0, "durationS": 0.5, "admitted": 1,
        "prefillChunks": 2, "decodeSlots": 3, "slotsBusy": 4,
        "queueDepth": 5, "pagesFree": 6, "compiles": 7, "faults": 8,
        "hostDemotions": 9, "hostPromotions": 10}
    if pkg == "port":
        # the port's columns: the start defaults to the stamp less the
        # duration, the phases to 0
        expected.update(startTs=0.5, **dict.fromkeys(PHASE_COLUMNS, 0.0))
    assert recorder.snapshot()[0] == expected
    recorder.clear()
    assert recorder.recorded == 0 and recorder.snapshot() == []
    with pytest.raises(ValueError):
        PKGS[pkg].flight.FlightRecorder(capacity=0)


@both_packages
def test_write_list_load_dump_roundtrip(pkg, tmp_path):
    flight = PKGS[pkg].flight
    recorder = flight.FlightRecorder(capacity=4)
    recorder.record(duration_s=0.01, faults=1, ts=5.0)
    path = flight.write_crash_dump(
        str(tmp_path), reason="DeviceLostError: injected", recorder=recorder,
        inflight=[{"requestId": "r1", "outcome": None}],
        alerts=["slo_burn_fast"], now=1_700_000_000.0)
    dumps = flight.list_crash_dumps(str(tmp_path))
    assert len(dumps) == 1
    assert dumps[0]["reason"] == "DeviceLostError: injected"
    assert (dumps[0]["ticks"], dumps[0]["inFlight"],
            dumps[0]["firingAlerts"]) == (1, 1, 1)
    dump = flight.load_crash_dump(str(tmp_path), dumps[0]["file"])
    assert dump["schemaVersion"] == 1 and dump["ticks"][-1]["faults"] == 1
    assert dump["inFlight"][0]["requestId"] == "r1"
    assert dump["firingAlerts"] == ["slo_burn_fast"]
    with open(path) as handle:
        assert json.load(handle) == dump
    assert not list(tmp_path.glob("*.tmp"))


@both_packages
def test_dump_names_validated_and_pruned(pkg, tmp_path):
    flight = PKGS[pkg].flight
    (tmp_path / "secret.txt").write_text("{}")
    assert flight.load_crash_dump(str(tmp_path), "../secret.txt") is None
    assert flight.load_crash_dump(str(tmp_path),
                                  "crash-20260101T000000-1.json") is None
    assert flight.list_crash_dumps(str(tmp_path)) == []
    assert flight.list_crash_dumps(str(tmp_path / "nope")) == []
    recorder = flight.FlightRecorder(capacity=2)
    for tick in range(5):
        flight.write_crash_dump(str(tmp_path), reason=f"crash {tick}",
                                recorder=recorder, max_dumps=3,
                                now=1_700_000_000.0 + 60.0 * tick)
    dumps = flight.list_crash_dumps(str(tmp_path))
    assert [d["reason"] for d in dumps] == ["crash 4", "crash 3", "crash 2"]
    empty = flight.write_crash_dump(str(tmp_path / "x"), reason="no ring",
                                    recorder=None, now=1_700_000_000.0)
    with open(empty) as handle:
        dump = json.load(handle)
    assert dump["ticks"] == [] and dump["ticksRecorded"] == 0


def test_dump_without_an_alert_engine_leaves_the_field_out(tmp_path):
    """The port has no alert engine: its supervisor passes ``alerts=None``
    and the dump carries no ``firingAlerts`` (JAX always writes one)."""
    path = flight_recorder.write_crash_dump(
        str(tmp_path), reason="r", recorder=None, alerts=None)
    with open(path) as handle:
        assert "firingAlerts" not in json.load(handle)
    assert flight_recorder.list_crash_dumps(
        str(tmp_path))[0]["firingAlerts"] == 0


# -- the tenant meter ------------------------------------------------------------

@both_packages
def test_charge_tick_and_feeds_accumulate(pkg):
    meter = PKGS[pkg].accounting.TenantMeter(clock=FakeClock())
    meter.charge_tick({"a": (2.0, 100.0, 10.0), "b": (1.0, 50.0, 0.0)})
    meter.charge_tick({"a": (0.5, 25.0, 0.0)})
    meter.count_tokens("a", "prefill", 32)
    meter.count_tokens("a", "decode", 8)
    meter.count_tokens("a", "cached", 16)
    meter.count_tokens("a", "spec_accepted", 4)
    meter.count_tokens("a", "decode", 0)            # ignored
    meter.charge_queue("a", 1.25)
    meter.charge_queue("a", -1.0)                   # ignored
    meter.charge_reservation("a", 2.0, effective_chip_seconds=1.0)
    usage = meter.totals()["a"]
    assert (usage.device_seconds, usage.kv_byte_seconds,
            usage.host_kv_byte_seconds) == (2.5, 125.0, 10.0)
    assert (usage.prefill_tokens, usage.decode_tokens, usage.cached_tokens,
            usage.spec_accepted_tokens) == (32, 8, 16, 4)
    assert usage.queue_seconds == 1.25
    assert (usage.reserved_chip_seconds,
            usage.effective_chip_seconds) == (2.0, 1.0)
    assert meter.tenants() == ["a", "b"]
    with pytest.raises(ValueError, match="unknown token kind"):
        meter.count_tokens("a", "bogus", 1)
    with pytest.raises(ValueError):
        PKGS[pkg].accounting.TenantMeter(top_k=0)
    with pytest.raises(ValueError):
        PKGS[pkg].accounting.TenantMeter(window_s=0)


@both_packages
def test_rollup_subtracts_window_baseline(pkg):
    clock = FakeClock(start=0.0)
    meter = PKGS[pkg].accounting.TenantMeter(
        window_s=100.0, snapshot_interval_s=10.0, clock=clock)
    for _ in range(30):
        meter.charge_tick({"a": (1.0, 10.0, 0.0)})
        clock.advance(10.0)
    assert meter.rollup(window_s=10_000.0)["a"].device_seconds == 30.0
    windowed = meter.rollup(window_s=100.0)
    assert windowed["a"].device_seconds == pytest.approx(9.0)
    assert windowed["a"].kv_byte_seconds == pytest.approx(90.0)
    meter.charge_reservation("quiet", 1.0)
    clock.advance(200.0)
    meter.charge_tick({"a": (1.0, 10.0, 0.0)})
    assert "quiet" not in meter.rollup(window_s=50.0)


@both_packages
def test_export_totals_caps_cardinality(pkg):
    acct = PKGS[pkg].accounting
    meter = acct.TenantMeter(top_k=4, clock=FakeClock())
    for index in range(100):
        meter.charge_tick({f"user{index:03d}": (float(index + 1), 0.0, 0.0)})
    export = meter.export_totals()
    assert len(export) == 5 and acct.OVERFLOW_TENANT in export
    assert {"user099", "user098", "user097", "user096"} <= set(export)
    assert (sum(u.device_seconds for u in export.values())
            == sum(u.device_seconds for u in meter.totals().values()))
    small = acct.TenantMeter(top_k=8, clock=FakeClock())
    small.charge_tick({"a": (1.0, 0.0, 0.0), "b": (2.0, 0.0, 0.0)})
    assert set(small.export_totals()) == {"a", "b"}
    delta = acct.TenantUsage(device_seconds=1.0).delta(
        acct.TenantUsage(device_seconds=3.0, queue_seconds=1.0))
    assert delta.device_seconds == 0.0 and delta.queue_seconds == 0.0


@pytest.fixture()
def port_meter_state():
    """The port's process-wide meter and config, restored afterwards."""
    yield
    accounting.set_tenant_meter(None)
    port_config.reset_config()
    serving.set_engine(None)


def tenant_lines(rendered, family="tpuhive_tenant_device_seconds_total"):
    return [line for line in rendered.splitlines()
            if line.startswith(family + "{")]


def test_scrape_is_bounded_and_follows_top_k(port_meter_state):
    meter = accounting.TenantMeter(top_k=4, clock=FakeClock())
    accounting.set_tenant_meter(meter)
    for index in range(100):
        meter.charge_tick({f"user{index:03d}": (float(index + 1), 5.0, 0.0)})
        meter.count_tokens(f"user{index:03d}", "decode", 3)
    rendered = observability.get_registry().render()
    device_lines = tenant_lines(rendered)
    assert 0 < len(device_lines) <= 5
    assert any('tenant="other"' in line for line in device_lines)
    assert 0 < len(tenant_lines(rendered, "tpuhive_tenant_tokens_total")) \
        <= 5 * 4
    small = accounting.TenantMeter(top_k=1, clock=FakeClock())
    accounting.set_tenant_meter(small)
    small.charge_tick({"a": (10.0, 0.0, 0.0), "b": (1.0, 0.0, 0.0)})
    lines = tenant_lines(observability.get_registry().render())
    assert any('tenant="a"' in line for line in lines)
    small.charge_tick({"b": (20.0, 0.0, 0.0)})       # b overtakes a
    lines = tenant_lines(observability.get_registry().render())
    assert not any('tenant="a"' in line for line in lines)
    other = next(line for line in lines if 'tenant="other"' in line)
    assert float(other.rsplit(" ", 1)[1]) == 10.0


def test_disabled_accounting_builds_no_meter_and_no_series(
        port_meter_state):
    meter = accounting.TenantMeter(top_k=4, clock=FakeClock())
    accounting.set_tenant_meter(meter)
    meter.charge_tick({"a": (1.0, 1.0, 0.0)})
    assert "tpuhive_tenant_" in observability.get_registry().render()
    accounting.set_tenant_meter(None)
    config = port_config.Config()
    config.accounting.enabled = False
    port_config.set_config(config)
    assert accounting.get_tenant_meter() is None
    assert "tpuhive_tenant_" not in observability.get_registry().render()
    port_config.reset_config()
    accounting.set_tenant_meter(None)
    rebuilt = accounting.get_tenant_meter()         # enabled by default
    assert rebuilt is not None and rebuilt.top_k == 8


# -- engines -----------------------------------------------------------------------

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


class SyncLane:
    """A copy lane that runs each job as it is submitted."""

    def __init__(self, job_class) -> None:
        self.job_class = job_class

    def submit(self, fn, urgent=False):
        job = self.job_class(fn)
        job.run()
        return job


PROMPT_A = list(range(3, 27))       # page 4: 5 cacheable pages
PROMPT_B = list(range(40, 64))
PROMPT_C = list(range(70, 94))


def build(package, kv_quant, clock, hooks=True):
    params, config = weights()[package]
    tier = kv_quant == "on"
    knobs = dict(slots=2, max_len=64, queue_depth=2, page_size=4,
                 kv_pages=12, kv_quant=kv_quant, prefix_cache="on",
                 prefix_min_tokens=4, prefill_chunk_tokens=8,
                 host_kv_bytes=(1 << 20) if tier else 0,
                 max_concurrent_per_user=1, speculative="off", clock=clock)
    pkg = PKGS[package]
    if hooks:
        knobs.update(flight_recorder=pkg.flight.FlightRecorder(capacity=256),
                     tenant_meter=pkg.accounting.TenantMeter(clock=clock))
    if package == "jax":
        engine = JaxSlotEngine(params, config, paged_kernel="off", **knobs)
        lane_job = jax_paging.LaneJob
    else:
        engine = SlotEngine(params, config, device="cpu", **knobs)
        lane_job = LaneJob
    if tier:
        engine._host_lane = SyncLane(lane_job)
    return engine


def schedule(engine, clock, package):
    """The schedule of the module docstring; returns what it observed."""
    errors = (JaxRateLimitError, JaxQueueFullError) if package == "jax" \
        else (RateLimitError, QueueFullError)
    out = {"tokens": [], "rejected": []}

    def tick():
        clock.advance(0.25)
        engine.step()

    def drain():
        while engine.has_work():
            tick()

    def serve(prompt, user, new_tokens=6):
        handle = engine.submit(prompt, max_new_tokens=new_tokens,
                               user_key=user)
        drain()
        out["tokens"].append(handle.result(timeout_s=5)["tokens"])

    serve(PROMPT_A, "alice")                        # miss, three chunks
    serve(PROMPT_A, "bob")                          # prefix hit
    def rejected(prompt, user):
        with pytest.raises(errors) as info:
            engine.submit(prompt, max_new_tokens=4, user_key=user)
        out["rejected"].append((type(info.value).__name__,
                                info.value.retry_after_s))

    running = engine.submit(PROMPT_B[:12], max_new_tokens=6,
                            user_key="carol")
    rejected(PROMPT_C[:5], "carol")                 # carol's limit is 1
    queued = engine.submit([5, 6, 7], max_new_tokens=4, user_key="dave")
    rejected([8, 9], "erin")                        # two queued: full
    queued.cancel()                                 # cancelled in the queue
    tick()
    doomed = engine.submit(list(range(30, 38)), max_new_tokens=12,
                           user_key="frank")
    for _ in range(6):
        tick()
    doomed.cancel()                                 # cancelled mid-decode
    late = engine.submit(list(range(50, 56)), max_new_tokens=16,
                         user_key="gina", deadline_s=2.0)
    drain()
    for handle in (running, queued, doomed, late):
        summary = handle.result(timeout_s=5)
        out["tokens"].append((summary["outcome"], summary["tokens"]))
    if engine.kv_quant == "on":
        for prompt in (PROMPT_B, PROMPT_C):         # churn A out to host
            serve(prompt, "hank")
        serve(PROMPT_A, "alice")                    # host hit
    out["counters"] = (engine.emitted_tokens, engine.steps,
                       engine.prefix_hits, engine.prefix_misses,
                       engine.host_kv_hits, engine.host_kv_promotions)
    return out


def normalized_rows(ledger, order):
    rows = []
    for row in ledger.recent():
        row = dict(row)
        row["requestId"] = order[row["requestId"]]
        row["elapsedS"] = round(row.pop("finishedTs")
                                - row.pop("submittedTs"), 3)
        rows.append(row)
    return rows


def normalized_spans(tracer, order):
    spans = []
    for span in tracer.recent():
        attrs = dict(span["attrs"])
        if "request_id" in attrs:
            attrs["request_id"] = order[attrs["request_id"]]
        spans.append((span["name"], span["kind"], span["durationMs"],
                      span["status"], attrs))
    return spans


def engine_samples(registry, parse):
    return {key: value for key, value in parse(registry.render()).items()
            if key.startswith("tpuhive_generate_")}


def observed(package, kv_quant):
    """Run the schedule on fresh process-wide observability; everything
    the comparison reads."""
    obs = jax_observability if package == "jax" else observability
    parse = (jax_metrics if package == "jax" else metrics).parse_rendered
    obs.get_registry().reset_values()
    obs.get_tracer().clear()
    obs.get_request_ledger().clear()
    clock = FakeClock()
    engine = build(package, kv_quant, clock)
    out = schedule(engine, clock, package)
    # the columns both recorders have, less the wall stamp; the port's
    # own (its start and phases) are held in the tests below
    ticks = [{k: v for k, v in row.items()
              if k not in ("ts", "startTs") + PHASE_COLUMNS}
             for row in engine.flight_recorder.snapshot()]
    totals = {tenant: usage.to_dict()
              for tenant, usage in engine.tenant_meter.totals().items()}
    # a ledger's ids run on across clears: compare them by their order
    ids = [row["requestId"] for row in obs.get_request_ledger().recent()]
    order = {rid: index for index, rid in enumerate(
        sorted(ids, key=lambda rid: int(rid.split("-")[1], 16)))}
    out.update(rows=normalized_rows(obs.get_request_ledger(), order),
               spans=normalized_spans(obs.get_tracer(), order),
               samples=engine_samples(obs.get_registry(), parse),
               ticks=ticks, totals=totals, stats=engine.stats())
    return out


@pytest.mark.parametrize("kv_quant", ["off", "on"])
def test_engine_observability_matches_jax(kv_quant):
    observed("jax", kv_quant)               # warm: every shape compiled
    theirs = observed("jax", kv_quant)
    ours = observed("port", kv_quant)
    assert ours["tokens"] == theirs["tokens"]
    assert ours["rejected"] == theirs["rejected"]
    assert ours["counters"] == theirs["counters"]
    assert ours["rows"] == theirs["rows"]
    assert ours["spans"] == theirs["spans"]
    keys = set(ours["samples"]) | set(theirs["samples"])
    assert {k: ours["samples"].get(k, 0.0) for k in keys} == \
        {k: theirs["samples"].get(k, 0.0) for k in keys}
    assert ours["totals"] == theirs["totals"]
    assert ours["ticks"] == theirs["ticks"]
    # the schedule engaged every path it names
    outcomes = [row["outcome"] for row in ours["rows"]]
    for outcome in ("completed", "cancelled", "timeout", "rejected_queue",
                    "rejected_ratelimit"):
        assert outcome in outcomes, outcome
    assert ours["counters"][2] >= 1                 # a prefix hit
    if kv_quant == "on":
        assert ours["counters"][4] >= 1             # host hits
        host_row = ours["rows"][0]                  # A, after the churn
        assert host_row["hostHitPages"] == 5 and host_row["promoteMs"] >= 0
    assert all(row["prefillCompile"] in (None, "hit") for row in ours["rows"])
    assert sum(tick["compiles"] for tick in ours["ticks"]) == 0
    # conservation: the meter's device-seconds are the engine's busy
    # slot-seconds (one device)
    device_s = sum(t["device_seconds"] for t in ours["totals"].values())
    assert device_s == pytest.approx(ours["stats"]["busySlotSeconds"],
                                     rel=1e-6)
    assert ours["stats"]["meshShape"] == "1x1"
    assert ours["stats"]["numDevices"] == 1


def test_request_ids_and_spans_share_the_ledger_ids():
    observability.get_tracer().clear()
    ledger = observability.get_request_ledger()
    ledger.clear()
    clock = FakeClock()
    engine = build("port", "off", clock)
    handle = engine.submit(PROMPT_A, max_new_tokens=3, user_key="u")
    while engine.has_work():
        clock.advance(0.5)
        engine.step()
    row = ledger.get(handle.request_id).to_dict()
    assert row["outcome"] == "completed"
    assert row["queueMs"] <= row["ttftMs"] <= row["totalMs"]
    spans = observability.get_tracer().recent()
    assert [s["name"] for s in spans] == ["generate.queue",
                                          "generate.prefill",
                                          "generate.decode"]
    assert {s["attrs"]["request_id"] for s in spans} == {handle.request_id}
    assert handle.result(timeout_s=5)["requestId"] == handle.request_id


@pytest.mark.parametrize("kv_quant", ["off", "on"])
def test_engine_without_recorder_or_meter_serves_the_same(kv_quant):
    """The off path: with ``flight_recorder`` and ``tenant_meter`` None the
    engine emits the same tokens and moves the same counters as with them
    installed — and the JAX engine's tokens."""
    runs = []
    for hooks in (True, False):
        clock = FakeClock()
        engine = build("port", kv_quant, clock, hooks=hooks)
        out = schedule(engine, clock, "port")
        runs.append((out["tokens"], out["counters"], engine.step_dispatches,
                     engine.prefill_chunks, engine.prefills))
        if not hooks:
            assert engine.flight_recorder is None
            assert engine.tenant_meter is None
            assert engine.stats()["busySlotSeconds"] is None
            assert engine.busy_slot_seconds == 0.0
    assert runs[1] == runs[0]
    clock = FakeClock()
    jax_out = schedule(build("jax", kv_quant, clock, hooks=False), clock,
                       "jax")
    assert jax_out["tokens"] == runs[1][0]


def decode_until_running(engine, clock, prompt=PROMPT_A, new_tokens=8):
    """Submit ``prompt`` and tick until its decode steps have begun."""
    handle = engine.submit(prompt, max_new_tokens=new_tokens, user_key="u")
    while engine.steps == 0:
        clock.advance(0.25)
        engine.step()
    return handle


def test_phase_columns_tile_a_paged_tick(monkeypatch):
    """On a fake clock moved only inside each phase, every recorded tick's
    phase columns read exactly what its phases spent, and they tile the
    tick: their sum plus the recorder's own bookkeeping (here the busy
    count read in its ``finally``) is ``durationS``."""
    clock = FakeClock()
    engine = build("port", "off", clock)
    costs = dict(admit=0.125, prefill=0.25, dispatch=0.5, wait=1.0,
                 token=0.0625, busy=0.03125)

    def costing(name, fn):
        def wrapped(*args, **kwargs):
            clock.advance(costs[name])
            return fn(*args, **kwargs)
        return wrapped

    class Launched:
        """The step's output, read back only through ``.cpu()``."""

        def __init__(self, tensor):
            self.tensor = tensor

        def cpu(self):
            clock.advance(costs["wait"])
            return self.tensor.cpu()

    run_step = engine._run_step
    monkeypatch.setattr(engine, "_admit", costing("admit", engine._admit))
    monkeypatch.setattr(engine, "_advance_prefills",
                        costing("prefill", engine._advance_prefills))
    monkeypatch.setattr(engine, "_run_step", costing(
        "dispatch", lambda: Launched(run_step())))
    monkeypatch.setattr(engine, "_apply_token_locked", costing(
        "token", engine._apply_token_locked))
    monkeypatch.setattr(engine, "_busy_locked",
                        costing("busy", engine._busy_locked))
    handle = decode_until_running(engine, clock, new_tokens=3)
    while engine.has_work():
        clock.advance(0.25)
        engine.step()
    assert handle.result(timeout_s=5)["outcome"] == "completed"
    rows = engine.flight_recorder.snapshot()
    decoding = [row for row in rows if row["decodeSlots"]]
    # three chunks, the last one's tick decoding the first token
    assert len(rows) == 5 and len(decoding) == 3
    for row in rows:
        stepped = row["decodeSlots"]
        # the admission counts the busy slots once more for each join
        assert row["admitS"] == pytest.approx(
            costs["admit"] + costs["busy"] * row["admitted"])
        assert row["prefillS"] == pytest.approx(costs["prefill"])
        assert row["dispatchS"] == pytest.approx(costs["dispatch"]
                                                 * (stepped > 0))
        assert row["waitS"] == pytest.approx(costs["wait"] * (stepped > 0))
        assert row["applyS"] == pytest.approx(
            (costs["token"] + costs["busy"]) * stepped)
        residual = costs["busy"]                    # the recorder's count
        assert row["durationS"] == pytest.approx(
            sum(row[name] for name in PHASE_COLUMNS) + residual)


def test_tick_start_follows_the_wall_anchor():
    """``startTs`` is the tick's start on the wall clock, read from one
    anchor as a request's wall stamps are: on a fake clock the starts lie
    exactly as far apart as the clock moved between the ticks."""
    clock = FakeClock()
    engine = build("port", "off", clock)
    before = time.time()
    handle = decode_until_running(engine, clock, new_tokens=2)
    after = time.time()
    while engine.has_work():
        clock.advance(0.75)
        engine.step()
    handle.result(timeout_s=5)
    starts = [row["startTs"] for row in engine.flight_recorder.snapshot()]
    assert before <= starts[0] <= after
    steps = [round(b - a, 6) for a, b in zip(starts, starts[1:])]
    assert steps[:2] == [0.25, 0.25] and steps[-1] == 0.75


def test_tick_without_a_recorder_samples_no_boundary(monkeypatch):
    """No recorder, no phase boundary: a decode-only tick calls the clock
    twice, as it did before the recorder had phases (the admission's check
    of the queue for cancels and the stamp of the emitted tokens); with a
    recorder, the same tick samples its start, its end and the four
    boundaries between its phases besides."""
    counts = {}
    for hooks in (False, True):
        calls = []
        clock = FakeClock()
        engine = build("port", "off", clock, hooks=hooks)
        if hooks:
            engine.tenant_meter = None
        decode_until_running(engine, clock)
        monkeypatch.setattr(engine, "clock",
                            lambda: calls.append(1) or clock())
        engine.step()
        counts[hooks] = len(calls)
    assert counts == {False: 2, True: 2 + 6}


def test_compiles_counts_a_cold_library_load_inside_a_tick(monkeypatch):
    """The ``compiles`` column is the kernel libraries ``cuda_build.load``
    built or loaded during the tick: a cold load is counted once, the same
    library loaded again is not."""
    from tensorhive_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "_libraries", {})
    monkeypatch.setattr(cuda_build, "build", lambda names: {})
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: object())
    clock = FakeClock()
    engine = build("port", "off", clock)
    admit = engine._admit

    def admit_and_load():
        cuda_build.load("paged_decode")
        return admit()

    monkeypatch.setattr(engine, "_admit", admit_and_load)
    for _ in range(2):
        engine.step()
    assert [row["compiles"]
            for row in engine.flight_recorder.snapshot()] == [1, 0]


def test_dominance_signal_reads_the_port_engine(port_meter_state):
    meter = accounting.TenantMeter(clock=FakeClock())
    accounting.set_tenant_meter(meter)
    assert accounting.dominance_signal() is None       # no engine published
    clock = FakeClock()
    engine = build("port", "off", clock)
    serving.set_engine(engine)
    assert accounting.dominance_signal() is None       # no queue pressure
    for _ in range(20):
        engine._queue_wait_hist.observe(5.0)           # p95 past the 1 s SLO
    meter.charge_tick({"a": (3.0, 0.0, 0.0), "b": (1.0, 0.0, 0.0)})
    assert accounting.dominance_signal() == pytest.approx(0.75)
