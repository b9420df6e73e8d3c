"""The speculative lane and KV-page tiering on the port's serving mesh,
against the JAX package's meshed engine.

Spawned groups, as in ``tests/test_torch_serving_mesh.py``: one process per
rank on the CPU over gloo, one ``FileStore`` per group under the test's
``tmp_path``, every process joined under ``JOIN_TIMEOUT_S``. The ranks
(``tests/torch_mesh_ranks.py``, no JAX) run the ``tiny`` preset with
JAX-made f32 weights through a list of jobs per group, while the parent
runs JAX's meshed ``SlotEngine`` (the suite's 8 virtual CPU devices) on the
same schedule and compares after every step. Each worker puts a record per
engine it built when the engine is released: its counters, its draft
lane's shape, the host shards it holds, and the promoted pages it held
against what it demoted under the same entry id.

* **Speculative, paged, f32** at (1, 2), (2, 2) and the GQA guard (tp 4
  over 2 KV heads), with the half-depth self-draft and with JAX's ``tiny``
  preset draft carried across (each rank its shard): tokens, outcomes,
  every page-table row, ``kvPagesFree``, ``spec_proposed``/
  ``spec_accepted`` and the draft's dispatches (JAX's ticks) after every
  step; greedy tokens equal ``decode.generate``; every rank's draft lane
  at its own KV heads and the same dispatch count. Under the guard the
  self-draft is guarded (2 KV heads) and the preset draft (4) is not.
* **Speculative, contiguous** at 2 x 2; **speculative with the prefix
  cache and chunked prefill** at 1 x 2 (the mirrors ride ``CHUNK``): the
  same checks, and the prefix hits.
* **Tiering** at (1, 2) and (2, 2), int8 pages, the prefix cache on, the
  lane off, rank 0's copy lane synchronous (the workers' lanes are the
  real threads): tokens, the four host counters, the store's keys and
  ``bytes_used`` (whole pages, as JAX counts them) and free and cached
  pages after every step; on every rank each promoted page byte-identical
  to what that rank demoted; at the end every worker holds exactly the
  entries rank 0's store lists (evictions dropped everywhere), each at
  half a page at tp 2; copy-lane threads ended at release.
* **Tiering and the lane together** at 1 x 2, int8: the tier checks, the
  speculative counters and page tables after every step, and rank 0's
  draft lane within two quantization steps of JAX's at its heads (the
  single-device rule of ``test_torch_speculative.py``).
* **In process**: the store's removal hook (evicted, replaced and
  discarded entries, whole-page ``nbytes``), ``LaneJob.wait``,
  ``HostCopyLane.close`` ending its thread, entry ids through the int32
  payload, and the widened closing flag of a one-rank group.
* **Faults**: a worker's ``verify`` fault at dp 2 x tp 1 through the
  daemon (flagged, fatal on rank 0, the rebuild reaches the worker's
  lane); at tp 2 it fails rank 0 at once and breaks the mesh; a worker's
  ``extract`` or ``inject`` fault at tp 2 is flagged (these bodies hold no
  collective), and the rebuilt engine serves; a worker whose copy of a
  shard fails makes rank 0 recompute the request and count one fallback,
  tokens unchanged.
"""
import dataclasses
import pickle
import queue
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorhive_tpu.models.transformer import PRESETS as JAX_PRESETS
from tensorhive_tpu.models.transformer import TransformerLM as JaxLM
from tensorhive_tpu.parallel import mesh as jax_mesh
from tensorhive_tpu.serving import paging as jax_paging
from tensorhive_tpu.serving import speculative as jax_spec
from tensorhive_tpu.serving.engine import SlotEngine as JaxSlotEngine
from tensorhive_tpu_torch.config import GenerationConfig
from tensorhive_tpu_torch.convert import params_from_jax
from tensorhive_tpu_torch.core.services.generation import build_engine
from tensorhive_tpu_torch.models import decode as port_decode
from tensorhive_tpu_torch.parallel import mesh as port_mesh
from tensorhive_tpu_torch.serving import mesh_worker
from tensorhive_tpu_torch.serving.paging import (
    HostCopyLane,
    HostPageStore,
    LaneJob,
)
from tests import torch_mesh_ranks as ranks

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device CPU platform")

#: a spawned group's whole run, joins included
JOIN_TIMEOUT_S = 150
ENGINE = dict(slots=4, max_len=96, queue_depth=8, page_size=16)
SPEC = dict(speculative="on", kv_quant="off", prefix_cache="off")
#: engine knobs per case name; "self" drafts are half depth (1 of 2
#: layers: mixed accept and rollback), "preset" ones JAX's tiny draft
CASES = {
    "spec_self": dict(ENGINE, **SPEC, draft_layers=1),
    "spec_preset": dict(ENGINE, **SPEC, draft_preset="tiny"),
    "spec_contiguous": dict(ENGINE, speculative="on", paged=False,
                            draft_layers=1),
    "spec_prefix": dict(ENGINE, speculative="on", kv_quant="off",
                        prefix_cache="on", prefill_chunk_tokens=8,
                        prefix_min_tokens=16, draft_layers=1),
    "tier": dict(ranks.TIERED),
    "tier_spec": dict(ranks.TIERED, speculative="on", draft_layers=1),
}
STATE = {"spec_self": "spec", "spec_preset": "spec",
         "spec_contiguous": "spec", "spec_prefix": "spec", "tier": "tier",
         "tier_spec": "tier_spec"}
SCHEDULE = {"spec_prefix": ranks.PREFIX_SCHEDULE, "tier": ranks.TIER_SCHEDULE,
            "tier_spec": ranks.TIER_SCHEDULE}
#: the daemon's tiered engine for the extract and inject faults
TIER_SERVICE = dict(slots=2, max_len=64, page_size=4, kv_pages=12,
                    prefix_min_tokens=4, host_kv_bytes=1 << 20)
TRAFFIC = {"extract": [ranks.TIER_A, list(range(40, 64))],
           "inject": [ranks.TIER_A, list(range(40, 64)),
                      list(range(70, 94)), ranks.TIER_A]}


# -- in process ---------------------------------------------------------------

def page(fill, heads=2):
    """A shard payload: (k, v, k_scale, v_scale) of ``heads`` KV heads."""
    return (np.full((2, 4, heads, 8), fill, np.int8),
            np.full((2, 4, heads, 8), fill, np.int8),
            np.full((2, heads), fill, np.float32),
            np.full((2, heads), fill, np.float32))


def test_store_reports_every_entry_it_lets_go():
    """A mesh controller's store charges whole pages (``nbytes``), files
    entry ids, and reports every entry that leaves it — evicted by the
    budget, replaced by a re-demotion, or discarded — so the other ranks
    drop their shards of it."""
    store = HostPageStore(3 * 1000)
    removed = []
    store.on_remove = removed.append
    for entry_id, key in enumerate((b"a", b"b", b"c"), start=1):
        assert store.put(key, *page(entry_id), nbytes=1000,
                         entry_id=entry_id)
    assert store.bytes_used == 3000 and ranks.store_ids(store) == [1, 2, 3]
    store.get(b"a")                          # b is now least recent
    assert store.put(b"d", *page(4), nbytes=1000, entry_id=4)
    assert [e.entry_id for e in removed] == [2]
    assert store.put(b"a", *page(5), nbytes=1000, entry_id=5)
    assert [e.entry_id for e in removed] == [2, 1]
    assert ranks.store_ids(store) == [3, 4, 5] and store.bytes_used == 3000
    stale = removed[1]
    assert not store.discard(stale)          # no longer filed
    current = store.get(b"a")
    assert current.key == b"a" and store.discard(current)
    assert [e.entry_id for e in removed] == [2, 1, 5]
    assert ranks.store_ids(store) == [3, 4] and store.bytes_used == 2000
    assert store.evictions == 1
    # the single engine's store: the payload's own bytes, id 0, no hook
    plain = HostPageStore(1 << 20)
    assert plain.put(b"x", *page(1))
    assert plain.get(b"x").nbytes == sum(a.nbytes for a in page(1))
    assert ranks.store_ids(plain) == [0]


def test_lane_job_wait_and_lane_close():
    """``wait`` returns once the job ran (or after its timeout, not done);
    ``close`` ends the lane's thread, drops queued jobs and refuses new
    ones."""
    lane = HostCopyLane()
    gate = threading.Event()
    first = lane.submit(gate.wait)
    queued = lane.submit(lambda: "never")
    assert not first.wait(0.05) and lane._worker.is_alive()
    gate.set()
    assert first.wait(5.0) and first.result is True
    assert queued.wait(5.0) and queued.result == "never"
    held = threading.Event()
    running = lane.submit(held.wait)
    dropped = lane.submit(lambda: "dropped")
    time.sleep(0.05)
    closer = threading.Thread(target=lane.close)
    closer.start()
    held.set()
    closer.join(5.0)
    assert running.done and not dropped.done
    assert not lane._worker.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        lane.submit(lambda: None)
    assert LaneJob(lambda: 1).wait(0.01) is False


def test_entry_ids_travel_as_int32_words():
    ids = [1, 2, 2**31 + 5, 2**40 + 7]
    words = mesh_worker.ids_to_words(ids)
    assert words.dtype == np.int32 and words.size == 2 * len(ids)
    payload = np.concatenate([np.arange(3, dtype=np.int32), words])
    assert mesh_worker.words_to_ids(payload[3:]).tolist() == ids


def test_closing_flag_counts_failures_and_missing_shards(tmp_path):
    """The closing all-reduce of two counts, on a one-rank group: ranks
    that failed and ranks that lacked a host shard."""
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1)
    try:
        mesh = port_mesh.ServingMesh(1, 1, 0, torch.device("cpu"), "gloo",
                                     None)
        assert mesh_worker.finish_command(mesh, False) == (0, 0)
        assert mesh_worker.finish_command(mesh, True) == (1, 0)
        assert mesh_worker.finish_command(mesh, False, True) == (0, 1)
    finally:
        torch.distributed.destroy_process_group()
    assert set(mesh_worker.TP_BODIES) < set(mesh_worker.DISPATCHES)
    assert not {mesh_worker.OP_EXTRACT, mesh_worker.OP_INJECT,
                mesh_worker.OP_DROP} & set(mesh_worker.TP_BODIES)


# -- spawned groups -------------------------------------------------------------

def jax_config(kv_heads=None):
    return dataclasses.replace(
        JAX_PRESETS["tiny"], dtype=jnp.float32, use_flash=False, remat=False,
        max_seq_len=128, n_kv_heads=kv_heads)


@pytest.fixture(scope="module")
def jax_params():
    return {kv: JaxLM.init(jax.random.PRNGKey(0), jax_config(kv))
            for kv in (None, 2)}


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def run_job(case, dp, tp, kv_heads=None, **extra):
    job = {"name": f"{case}_{dp}x{tp}", "kind": "run", "dp": dp, "tp": tp,
           "kv_heads": kv_heads, "engine": CASES[case],
           "state": STATE[case],
           "schedule": SCHEDULE.get(case, ranks.SCHEDULE)}
    if case == "spec_preset":
        job["draft"] = "tiny"
    if kv_heads is not None:
        job["name"] += "_gqa"
    job.update(extra)
    return job


class Group:
    """A spawned group of ``world`` ranks running ``jobs``. ``outcomes()``
    waits for it once — every rank joined under ``JOIN_TIMEOUT_S`` — and
    returns rank 0's outcome per job name, the workers' engine records per
    job name and every rank's exit code."""

    def __init__(self, tmp_path, world, jobs, trees):
        context = torch.multiprocessing.get_context("spawn")
        self.jobs = jobs
        self.results = context.Queue()
        self.started = time.monotonic()
        weights = tmp_path / "weights.pkl"
        weights.write_bytes(pickle.dumps(trees))
        self.processes = [
            context.Process(target=ranks.rank_main, args=(
                rank, world, str(tmp_path / "store"), str(weights), jobs,
                self.results))
            for rank in range(world)]
        for process in self.processes:
            process.start()
        self._collected = None

    def outcomes(self):
        if self._collected is None:
            self._collected = self._collect()
        return self._collected

    def _collect(self):
        deadline = self.started + JOIN_TIMEOUT_S
        outcomes, records = {}, {}

        def take(name, outcome):
            assert name != "error", outcome
            if name == "worker":
                records.setdefault(outcome["job"], []).append(outcome)
            else:
                outcomes[name] = outcome

        try:
            while len(outcomes) < len(self.jobs):
                take(*self.results.get(
                    timeout=max(1.0, deadline - time.monotonic())))
            # drain while the ranks exit (a child that put on the queue
            # exits only once its items are read), then what is left
            while (any(p.is_alive() for p in self.processes)
                   and time.monotonic() < deadline):
                try:
                    take(*self.results.get(timeout=0.2))
                except queue.Empty:
                    pass
            for process in self.processes:
                process.join(timeout=max(1.0, deadline - time.monotonic()))
            assert not any(p.is_alive() for p in self.processes), \
                "a rank did not finish inside the join timeout"
            while True:
                try:
                    take(*self.results.get(timeout=0.2))
                except queue.Empty:
                    break
        finally:
            for process in self.processes:
                if process.is_alive():
                    process.kill()
                    process.join(5)
        return outcomes, records, [p.exitcode for p in self.processes]


@pytest.fixture(scope="module", autouse=True)
def groups(tmp_path_factory, jax_params):
    """The two spawned groups, started with the module so their ranks run
    beside the JAX work of the tests. Two ranks: the lane (self and preset
    drafts, prefix and chunks), the tier, both together and a failed copy
    at 1 x 2; the daemon through a worker's verify fault at 2 x 1 and its
    extract and inject faults at 1 x 2 (whose shutdown stops the workers).
    Four ranks: the lane and the tier at 2 x 2, the contiguous lane, the
    GQA guard at 1 x 4, then a verify fault inside the tp body at 2 x 2,
    which ends the group."""
    trees = {kv: numpy_tree(params) for kv, params in jax_params.items()}
    trees["drafts"] = {"tiny": numpy_tree(jax_spec.build_draft(
        jax_params[None], jax_config(), draft_preset="tiny")[0])}
    two = [run_job(case, 1, 2) for case in
           ("spec_self", "spec_preset", "spec_prefix", "tier")]
    two.append(run_job("tier_spec", 1, 2, draft_cache=True))
    two.append(run_job("tier", 1, 2, name="copy_fail_1x2", fail_copy=True))
    # the daemon's shutdown stops the workers: only the last one shuts down
    two.append({"name": "verify_fault_dp", "kind": "service", "dp": 2,
                "tp": 1, "worker_fault": 2, "fault_kind": "verify",
                "instrument": True, "keep_workers": True,
                "generation": dict(slots=2, max_len=48, speculative="on"),
                "config_dir": str(tmp_path_factory.mktemp("verify"))})
    for kind in ("extract", "inject"):
        two.append({"name": f"{kind}_fault", "kind": "service_traffic",
                    "dp": 1, "tp": 2, "worker_fault": 2, "fault_kind": kind,
                    "instrument": True, "keep_workers": kind == "extract",
                    "traffic": TRAFFIC[kind], "after": ranks.TIER_A,
                    "generation": TIER_SERVICE,
                    "config_dir": str(tmp_path_factory.mktemp(kind))})
    four = [run_job(case, 2, 2) for case in
            ("spec_self", "spec_preset", "spec_contiguous", "tier")]
    four += [run_job(case, 1, 4, kv_heads=2)
             for case in ("spec_self", "spec_preset")]
    four.append({"name": "verify_fault_tp", "kind": "fault", "dp": 2,
                 "tp": 2, "worker_fault": 1, "fault_kind": "verify",
                 "engine": CASES["spec_self"]})
    started = {2: Group(tmp_path_factory.mktemp("two"), 2, two, trees),
               4: Group(tmp_path_factory.mktemp("four"), 4, four, trees)}
    yield started
    for group in started.values():
        group.outcomes()


class JaxSyncLane:
    def submit(self, fn, urgent=False):
        job = jax_paging.LaneJob(fn)
        job.run()
        return job


def jax_run(jax_params, case, dp, tp, kv_heads=None):
    """JAX's meshed engine on the case's schedule (a synchronous copy
    lane under the tier): ``(engine, results, trace)``."""
    engine = JaxSlotEngine(jax_params[kv_heads], jax_config(kv_heads),
                           mesh=jax_mesh.serving_mesh(dp=dp, tp=tp),
                           **CASES[case])
    if engine._host_store is not None:
        engine._host_lane = JaxSyncLane()
    results, trace = ranks.run_schedule(
        engine, SCHEDULE.get(case, ranks.SCHEDULE),
        ranks.STATES[STATE[case]])
    return engine, results, trace


@pytest.fixture(scope="module")
def references(jax_params):
    """The port's ``decode.generate`` (held to JAX's in
    test_torch_decode.py), greedy, one request at a time, per schedule."""
    def generate(kv_heads, schedule):
        config = ranks.tiny_config(kv_heads)
        params = params_from_jax(numpy_tree(jax_params[kv_heads]), config,
                                 device="cpu")
        return [port_decode.generate(params, config, [prompt], new,
                                     device="cpu")[0, len(prompt):].tolist()
                for prompt, new, _ in schedule]

    return {(None, "schedule"): generate(None, ranks.SCHEDULE),
            (2, "schedule"): generate(2, ranks.SCHEDULE),
            (None, "prefix"): generate(None, ranks.PREFIX_SCHEDULE)}


def check_lane(outcome, records, jax_engine, results, trace, world,
               reference=None):
    """A lane run against JAX's meshed engine, after every step, and every
    worker's lane against rank 0's."""
    assert outcome["results"] == results
    assert [o for o, _ in results] == ["completed"] * len(results)
    if reference is not None:
        assert [tokens for _, tokens in results] == reference
    assert outcome["trace"] == trace
    stats = outcome["stats"]
    assert stats["speculative"] == "on"
    assert (stats["specProposed"], stats["specAccepted"]) == (
        jax_engine.spec_proposed, jax_engine.spec_accepted)
    assert 0 <= stats["specAccepted"] < stats["specProposed"]
    mine = outcome["record"]
    assert mine["draft_dispatches"] == jax_engine.steps
    assert len(records) == world - 1
    for record in records:
        for key in ("draft_dispatches", "step_dispatches", "prefills",
                    "prefill_chunks", "draft_kv_shape", "draft_kv_bytes",
                    "draft_rules_kv_heads"):
            assert record[key] == mine[key], key
    return mine


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2)])
@pytest.mark.parametrize("draft", ["self", "preset"])
def test_speculative_lane_matches_jax_mesh(dp, tp, draft, groups,
                                           jax_params, references):
    case = f"spec_{draft}"
    jax_engine, results, trace = jax_run(jax_params, case, dp, tp)
    outcomes, records, _ = groups[dp * tp].outcomes()
    name = f"{case}_{dp}x{tp}"
    outcome = outcomes[name]
    mine = check_lane(outcome, records[name], jax_engine, results, trace,
                      dp * tp, references[(None, "schedule")])
    assert outcome["draft_shares_target"] == (draft == "self")
    # every rank holds half the draft lane's KV heads at tp 2
    assert mine["draft_rules_kv_heads"] == "tp"
    assert mine["draft_kv_shape"][3] == 4 // tp
    assert mine["draft_kv_shape"][1] == jax_engine._pool.physical_pages + 1


@pytest.mark.parametrize("draft", ["self", "preset"])
def test_speculative_lane_under_the_gqa_guard(draft, groups, jax_params,
                                              references):
    """tp 4 over a target of 2 KV heads: the target is guarded. The
    self-draft has the target's heads and is guarded too (its KV lane
    whole on every rank); the preset draft has 4 KV heads and is not (one
    per rank)."""
    case = f"spec_{draft}"
    jax_engine, results, trace = jax_run(jax_params, case, 1, 4, kv_heads=2)
    outcomes, records, _ = groups[4].outcomes()
    name = f"{case}_1x4_gqa"
    mine = check_lane(outcomes[name], records[name], jax_engine, results,
                      trace, 4, references[(2, "schedule")])
    if draft == "self":
        assert mine["draft_rules_kv_heads"] is None
        assert mine["draft_kv_shape"][3] == 2
    else:
        assert mine["draft_rules_kv_heads"] == "tp"
        assert mine["draft_kv_shape"][3] == 1


def test_speculative_contiguous_and_prefix_lanes(groups, jax_params,
                                                 references):
    """The contiguous lane at 2 x 2, and the lane beside the prefix cache
    and chunked prefill at 1 x 2: the mirrors ride CHUNK, so a cached page
    carries both lanes' K/V and the hits serve the same tokens."""
    jax_engine, results, trace = jax_run(jax_params, "spec_contiguous", 2, 2)
    outcomes, records, _ = groups[4].outcomes()
    mine = check_lane(outcomes["spec_contiguous_2x2"],
                      records["spec_contiguous_2x2"], jax_engine, results,
                      trace, 4, references[(None, "schedule")])
    assert mine["draft_kv_shape"][1:3] == (4, 96)
    jax_engine, results, trace = jax_run(jax_params, "spec_prefix", 1, 2)
    outcomes, records, _ = groups[2].outcomes()
    outcome = outcomes["spec_prefix_1x2"]
    mine = check_lane(outcome, records["spec_prefix_1x2"], jax_engine,
                      results, trace, 2, references[(None, "prefix")])
    assert mine["prefill_chunks"] > 0 and mine["prefills"] == 0
    jax_stats = jax_engine.stats()
    assert outcome["stats"]["prefixHits"] == jax_stats["prefixHits"] == 3
    assert outcome["stats"]["prefixMisses"] == jax_stats["prefixMisses"]


def check_tier(outcome, records, jax_engine, results, trace, tp):
    """A tier run against JAX's meshed engine, and every rank's shards."""
    assert outcome["results"] == results
    tokens = [tokens for _, tokens in results]
    a_runs = [tokens[i] for i in (0, 1, 4, 5)]
    assert all(run == a_runs[0] for run in a_runs)
    assert outcome["trace"] == trace
    assert outcome["fallbacks"] == 0
    store = jax_engine._host_store
    assert outcome["store_bytes"] == store.bytes_used
    assert jax_engine.host_kv_hits == 1 and jax_engine.host_kv_promotions == 5
    page_bytes = next(iter(store._entries.values())).nbytes
    for record in [outcome["record"]] + records:
        # each rank's promoted pages are the bytes it demoted
        assert record["promoted"] == 5 and "mismatched" not in record
        assert record["lane_alive"] in (None, False)
    for record in records:
        # every worker holds exactly what rank 0's store lists, each
        # entry at its share of the page
        assert record["shard_ids"] == outcome["store_ids"]
        assert record["shard_bytes"] * tp == len(
            outcome["store_ids"]) * page_bytes
        assert set(record["demoted_ids"]) >= set(record["shard_ids"])


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2)])
def test_tiering_matches_jax_mesh(dp, tp, groups, jax_params):
    jax_engine, results, trace = jax_run(jax_params, "tier", dp, tp)
    outcomes, records, _ = groups[dp * tp].outcomes()
    name = f"tier_{dp}x{tp}"
    check_tier(outcomes[name], records[name], jax_engine, results, trace,
               tp)
    check_evictions(outcomes[name], jax_engine)


def check_evictions(outcome, jax_engine):
    """The store evicted 3 of the 11 demoted pages (its budget is 8
    pages), as JAX's did: rank 0 demoted 11 entries and lists 8, which is
    what every worker holds (check_tier)."""
    assert jax_engine._host_store.evictions == 3
    assert jax_engine.host_kv_demotions == 11
    assert len(outcome["record"]["demoted_ids"]) == 11
    assert len(outcome["store_ids"]) == 8


def test_tiering_with_the_lane_matches_jax_mesh(groups, jax_params):
    """Both at 1 x 2 on int8 pages: the tier's checks, and the lane's
    counters and page tables after every step. Promoted pages carry no
    draft K/V in either package; the draft lanes agree all the same."""
    jax_engine, results, trace = jax_run(jax_params, "tier_spec", 1, 2)
    outcomes, records, _ = groups[2].outcomes()
    outcome = outcomes["tier_spec_1x2"]
    check_tier(outcome, records["tier_spec_1x2"], jax_engine, results, trace,
               2)
    check_evictions(outcome, jax_engine)
    assert outcome["stats"]["specProposed"] == jax_engine.spec_proposed
    assert outcome["stats"]["specAccepted"] == jax_engine.spec_accepted
    assert records["tier_spec_1x2"][0]["draft_dispatches"] == \
        outcome["record"]["draft_dispatches"] == jax_engine.steps
    # rank 0's draft lane (its 2 of 4 KV heads) against JAX's, past the
    # trash page and short of the port's drop page: int8 payloads at most
    # two quantization steps apart on at most 1% of the bytes, scales to
    # 1/127 (the single-device rule of test_torch_speculative.py)
    theirs = jax_engine._spec.cache
    pages = theirs.k.shape[1]
    for name, mine in outcome["draft_cache"].items():
        other = np.asarray(getattr(theirs, name))[:, 1:pages]
        mine = mine[:, 1:pages]
        if name.endswith("scale"):
            np.testing.assert_allclose(mine, other[..., :2], rtol=1 / 127,
                                       atol=0)
            continue
        steps = np.abs(mine.astype(np.int32)
                       - other[:, :, :, :2].astype(np.int32))
        assert steps.max() <= 2 and np.mean(steps != 0) <= 0.01, name


def test_failed_shard_copy_recomputes(groups, jax_params):
    """A worker whose first demotion copy fails lacks that shard at the
    host hit: rank 0 recomputes the request (one fallback, no promotion),
    drops the run's entries on every rank, and the tokens are the tier's
    own."""
    _, results, _ = jax_run(jax_params, "tier", 1, 2)
    outcomes, records, _ = groups[2].outcomes()
    outcome = outcomes["copy_fail_1x2"]
    assert outcome["results"] == results
    assert outcome["fallbacks"] == 1
    assert outcome["stats"]["hostHitRate"] is not None
    assert "promoted" not in outcome["record"]
    [record] = records["copy_fail_1x2"]
    assert record["shard_ids"] == outcome["store_ids"]


def test_worker_faults_in_the_tier_are_flagged(groups):
    """A worker's extract or inject fault at tp 2 is flagged (the bodies
    hold no collective): the daemon fails the engine fast, the rebuild's
    BUILD reaches the worker, whose new engine starts with no shard, and
    the rebuilt engine serves the prompt's tokens."""
    outcomes, records, exit_codes = groups[2].outcomes()
    for kind in ("extract", "inject"):
        outcome = outcomes[f"{kind}_fault"]
        assert outcome["errors"] and all(
            "MeshWorkerError" in error for error in outcome["errors"])
        assert outcome["rebuilt"] and outcome["restarts"] == 1
        assert outcome["after"] == outcome["tokens"][0]
        boot, rebuilt = records[f"{kind}_fault"]
        assert len(rebuilt["shard_ids"]) == \
            outcome["stats"]["hostPagesResident"]
        assert boot["lane_alive"] is False and rebuilt["lane_alive"] is False


def test_worker_verify_faults(groups, jax_params):
    """At dp 2 x tp 1 a worker's verify fault is flagged: the daemon fails
    fast and its rebuild reaches the worker's lane, which then serves the
    single engine's tokens. At 2 x 2 the verify is a tp body: rank 0 fails
    at once, the mesh is broken and the worker leaves."""
    single = build_engine(GenerationConfig(preset="tiny", max_len=48,
                                           speculative="on"), device="cpu")
    handle = single.submit([5, 6, 7], max_new_tokens=6)
    single.pump()
    outcomes, records, exit_codes = groups[2].outcomes()
    assert exit_codes == [0, 0]
    service = outcomes["verify_fault_dp"]
    assert "MeshWorkerError" in service["failed_error"]
    assert service["rebuilt"] and service["restarts"] == 1
    assert service["tokens"] == handle.result()["tokens"]
    assert service["stats"]["speculative"] == "on"
    boot, rebuilt = records["verify_fault_dp"]
    assert rebuilt["draft_dispatches"] > 0
    outcomes, _, exit_codes = groups[4].outcomes()
    fault = outcomes["verify_fault_tp"]
    assert fault["error"] is not None and "MeshWorkerError" in fault["error"]
    assert fault["seconds"] < 30 and fault["broken"]
    assert exit_codes[0] == 0 and exit_codes[1] != 0
