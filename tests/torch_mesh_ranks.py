"""Rank processes for tests/test_torch_serving_mesh.py and
tests/test_torch_serving_mesh_lanes.py: one spawned process per rank of a
serving mesh on the CPU (gloo, a ``FileStore`` under the test's
``tmp_path``), running a list of jobs. Rank 0 builds each job's meshed
engine, drives it and puts what it saw on the result queue; the workers
serve it through ``serve_worker`` and, when asked, put one record per
engine they built at the end (counters, the speculative lane's shape, the
host shards they hold, the promoted pages they checked against what they
demoted). This module imports no JAX, so a spawned rank starts in a few
seconds; the tests compare with JAX in the parent."""
from __future__ import annotations

import dataclasses
import datetime
import pickle
import time
import traceback

import torch

from tensorhive_tpu_torch.config import Config, GenerationConfig
from tensorhive_tpu_torch.convert import params_from_jax
from tensorhive_tpu_torch.models.transformer import PRESETS
from tensorhive_tpu_torch.parallel import serving_mesh
from tensorhive_tpu_torch.parallel.mesh import serving_rules, \
    shard_serving_params
from tensorhive_tpu_torch.serving.engine import SlotEngine
from tensorhive_tpu_torch.serving.faults import DeviceLostError
from tensorhive_tpu_torch.serving.mesh_worker import (
    MeshWorkerError,
    serve_worker,
    stop_workers,
)
from tensorhive_tpu_torch.serving.paging import HostCopyLane, LaneJob

#: requests of the schedule, (prompt, max_new_tokens, ticks stepped after
#: the submit): more than the 4 slots, so slots and pages are reused
SCHEDULE = [(list(range(3, 11)), 6, 0), ([5], 9, 1),
            (list(range(1, 18)), 4, 0), (list(range(2, 14)), 7, 1),
            ([9, 8, 7, 6, 5], 8, 0), (list(range(40, 55)), 12, 1)]
#: shared-prefix traffic for the prefix cache: a 40-token prefix prefilled
#: in chunks of 8, then two hits and a shorter partial one
PREFIX = list(range(100, 140))
PREFIX_SCHEDULE = [(PREFIX + [7, 8, 9], 5, 6), (PREFIX + [1, 2], 6, 1),
                   (PREFIX[:24] + [3, 3, 3], 4, 1), (PREFIX + [4], 5, 0)]
#: the host tier's schedule (``None`` ticks: run the request to the end):
#: a miss, an HBM hit, two prompts that churn A's pages out to the host
#: store, a host hit that promotes them, and a device hit again
TIER_A = list(range(3, 27))
TIER_SCHEDULE = [(TIER_A, 6, None), (TIER_A, 6, None),
                 (list(range(40, 64)), 6, None),
                 (list(range(70, 94)), 6, None),
                 (TIER_A, 6, None), (TIER_A, 6, None)]
#: the tier's engine: page 4, 12 pages, int8 pages, and host RAM for 8
#: whole pages of ``tiny`` (1,088 bytes each): the schedule demotes 11, so
#: the store evicts 3 (LRU) and keeps A's 5 for the host hit
TIERED = dict(slots=2, max_len=64, queue_depth=8, page_size=4,
              prefix_cache="on", prefix_min_tokens=4,
              host_kv_bytes=8 * 1088, kv_pages=12)


def tiny_config(kv_heads=None):
    return dataclasses.replace(PRESETS["tiny"], dtype=torch.float32,
                               max_seq_len=128, n_kv_heads=kv_heads)


def page_state(engine):
    """Each slot's page-table row and the free pages (None entries on the
    contiguous layout)."""
    pool = engine._pool
    return (pool.page_table.tolist() if pool is not None else None,
            pool.free_pages if pool is not None else None)


def spec_state(engine):
    """``page_state`` and the speculative counters: proposed, accepted,
    and the draft's dispatches (the port's ``draft_dispatches``; JAX counts
    none, and its ``steps`` — one propose each — stand for them)."""
    return page_state(engine) + (
        engine.spec_proposed, engine.spec_accepted,
        getattr(engine, "draft_dispatches", engine.steps))


def tier_state(engine):
    """The host tier after a step: hits, misses, demotions, promotions,
    the store's keys and bytes, free and cached pages."""
    store = engine._host_store
    stats = engine.stats()
    return ((engine.host_kv_hits, engine.host_kv_misses,
             engine.host_kv_demotions, engine.host_kv_promotions),
            sorted(store._entries), store.bytes_used, stats["kvPagesFree"],
            stats["cachedPages"])


STATES = {"pages": page_state, "spec": spec_state, "tier": tier_state,
          "tier_spec": lambda engine: tier_state(engine)
          + spec_state(engine)[2:]}


def run_schedule(engine, schedule, state=page_state):
    """Submit the requests, stepping as each entry says (``None``: until
    the engine is idle), then drain; after every step record ``state``.
    Returns ``(results, trace)``: (outcome, tokens) per request, and the
    state after each step."""
    trace = []

    def step():
        engine.step()
        trace.append(state(engine))

    handles = []
    for prompt, new, ticks in schedule:
        handles.append(engine.submit(prompt, max_new_tokens=new))
        if ticks is None:
            while engine.has_work():
                step()
        for _ in range(ticks or 0):
            step()
    while engine.has_work():
        step()
    results = [(summary["outcome"], summary["tokens"])
               for summary in (handle.result(timeout_s=30)
                               for handle in handles)]
    return results, trace


class FailOnStep:
    """A worker's fault plan: the ``nth`` dispatch of ``kind`` raises."""

    def __init__(self, nth: int, kind: str = "step") -> None:
        self.nth = nth
        self.kind = kind
        self.steps = 0

    def before_dispatch(self, kind: str) -> None:
        if kind == self.kind:
            self.steps += 1
            if self.steps == self.nth:
                raise DeviceLostError(f"injected worker {kind} fault")


class SyncLane:
    """A copy lane that runs each job as it is submitted, so rank 0's
    copies land on the tick the JAX engine's do."""

    def submit(self, fn, urgent=False):
        job = LaneJob(fn)
        job.run()
        return job


class FailFirstCopy(HostCopyLane):
    """A worker's real copy lane whose first demotion copy fails."""

    def __init__(self) -> None:
        super().__init__()
        self.failed = False

    def submit(self, fn, urgent=False):
        if not self.failed:
            self.failed = True

            def fn():
                raise RuntimeError("injected copy failure")
        return super().submit(fn, urgent)


def _carry_draft(engine, drafts, name):
    """Replace a preset draft's seeded weights by the JAX draft's
    (``drafts[name]``), this rank's shard of them."""
    lane = engine._spec
    full = params_from_jax(drafts[name], lane.draft_config, device="cpu")
    mesh = engine.mesh
    lane.params = shard_serving_params(
        full, serving_rules(lane.draft_config, mesh.tp), mesh.tp_rank,
        mesh.tp)


def _watch_tier(engine, record):
    """Check, on this rank, every promoted page against what this rank
    demoted under the same entry id: a snapshot of its cache pages at each
    extract, held against the pages after each inject."""
    demoted = record.setdefault("demoted_ids", [])
    snapshots = {}

    def snapshot(pages, ids):
        for column, entry_id in enumerate(ids or ()):
            snapshots[entry_id] = [tensor[:, int(pages[column])].clone()
                                   for tensor in engine._cache]
            demoted.append(entry_id)

    def check(pages, ids, missing):
        if missing or not ids:
            return
        for column, entry_id in enumerate(ids):
            now = [tensor[:, int(pages[column])] for tensor in engine._cache]
            record["promoted"] = record.get("promoted", 0) + 1
            if not all(torch.equal(a, b)
                       for a, b in zip(now, snapshots[entry_id])):
                record["mismatched"] = record.get("mismatched", 0) + 1

    if engine.mesh.is_controller:
        extract, inject = (engine._dispatch_page_extract,
                           engine._dispatch_page_inject)

        def dispatch_extract(pages, ids=None):
            snapshot(pages, ids)
            return extract(pages, ids)

        def dispatch_inject(pages, staged, ids=None):
            missing = inject(pages, staged, ids)
            check(pages, ids, missing)
            return missing

        engine._dispatch_page_extract = dispatch_extract
        engine._dispatch_page_inject = dispatch_inject
        return
    extract, inject = engine._extract_shard, engine._inject_shard

    def extract_shard(pages, ids):
        snapshot(pages, ids)
        return extract(pages, ids)

    def inject_shard(pages, ids):
        missing = inject(pages, ids)
        check(pages, ids, missing)
        return missing

    engine._extract_shard = extract_shard
    engine._inject_shard = inject_shard


def store_ids(store):
    """The entry ids a host store lists, sorted."""
    return sorted(entry.entry_id for entry in store._entries.values())


def _record_release(engine, record, results):
    """Wrap ``engine.release`` so the record gets the engine's counters,
    its lane's shape and (worker) the host shards it holds — its copies
    landed first — before they go, and whether its copy lane's thread
    ended after; a worker then puts the record on ``results``."""
    release = engine.release

    def recorded():
        record.update(draft_dispatches=engine.draft_dispatches,
                      step_dispatches=engine.step_dispatches,
                      prefills=engine.prefills,
                      prefill_chunks=engine.prefill_chunks)
        if engine._spec is not None:
            record.update(
                draft_kv_shape=tuple(engine._spec.cache.k.shape),
                draft_kv_bytes=engine._spec.kv_cache_bytes,
                draft_rules_kv_heads=engine._spec._rules.kv_heads)
        if engine._host_store is not None and engine.is_mesh_worker:
            for job, _ in engine._shard_jobs:
                job.wait(5.0)
            engine._adopt_shard_jobs()
            record.update(shard_ids=sorted(engine._host_shards),
                          shard_bytes=engine.host_shard_bytes)
        release()
        lane = engine._host_lane
        record["lane_alive"] = (
            lane._worker is not None and lane._worker.is_alive()
            if isinstance(lane, HostCopyLane) else None)
        if engine.is_mesh_worker:
            results.put(("worker", record))

    engine.release = recorded


def _instrument(engine, job, drafts, results):
    """A built engine as a job asks: the JAX draft's weights carried in,
    rank 0's lane synchronous, a worker's failing copy, the tier's checks
    and the release record (a worker puts it on ``results`` when the engine
    is released)."""
    record = {"job": job.get("name"), "rank": engine.mesh.rank}
    if job.get("draft"):
        _carry_draft(engine, drafts, job["draft"])
    if engine._host_store is not None:
        if engine.mesh.is_controller:
            if job.get("sync_lane", True):
                engine._host_lane = SyncLane()
        elif job.get("fail_copy"):
            engine._host_lane = FailFirstCopy()
        _watch_tier(engine, record)
    _record_release(engine, record, results)
    return record


def _engine(job, params, mesh, drafts=None, results=None):
    engine = SlotEngine(params[job.get("kv_heads")],
                        tiny_config(job.get("kv_heads")), mesh=mesh,
                        device="cpu", **job.get("engine", {}))
    if drafts is not None:
        engine._instrument_record = _instrument(engine, job, drafts,
                                                results)
    return engine


def _generation(job):
    return GenerationConfig(**{"preset": "tiny", "max_len": 64,
                               **job.get("generation", {}),
                               "mesh_dp": job["dp"], "mesh_tp": job["tp"]})


def _with_fault(factory, nth, kind="step"):
    """``factory`` whose engine's ``nth`` dispatch of ``kind`` raises."""
    def build():
        engine = factory()
        engine.fault_plan = FailOnStep(nth, kind)
        return engine
    return build


def _instrumented(factory, job, drafts, results):
    def build():
        engine = factory()
        _instrument(engine, job, drafts, results)
        return engine
    return build


def _builds(jobs, params, meshes, rank, drafts, results):
    """Every BUILD a worker will see, in order: a factory per build (a
    job's ``worker_fault`` goes into its first build on rank 1)."""
    from tensorhive_tpu_torch.core.services.generation import build_engine

    for job in jobs:
        mesh = meshes[job["dp"], job["tp"]]
        if job["kind"] in ("schedule", "fault", "run"):
            factories = [lambda job=job, mesh=mesh: _engine(
                job, params, mesh,
                drafts if job["kind"] == "run" else None, results)]
        else:
            # build_engine, or the daemon's boot build and its rebuild
            factories = [lambda job=job: build_engine(_generation(job),
                                                      device="cpu")] * (
                2 if job["kind"].startswith("service") else 1)
            if job.get("instrument"):
                factories = [_instrumented(factory, job, drafts, results)
                             for factory in factories]
        if job.get("worker_fault") and rank == 1:
            factories[0] = _with_fault(factories[0], job["worker_fault"],
                                       job.get("fault_kind", "step"))
        yield from factories


def _run_job(job, params, mesh, drafts):
    """A lane or tier schedule on rank 0, with its per-step state; the
    engine's own record (promoted pages checked on rank 0, counters) and,
    with the tier, the entry ids its store lists at the end."""
    engine = _engine(job, params, mesh, drafts)
    results, trace = run_schedule(engine, job["schedule"],
                                  STATES[job["state"]])
    out = {"results": results, "trace": trace, "stats": engine.stats(),
           "fallbacks": engine.host_kv_fallbacks}
    if engine._host_store is not None:
        out["store_ids"] = store_ids(engine._host_store)
        out["store_bytes"] = engine._host_store.bytes_used
    if engine._spec is not None:
        out["draft_shares_target"] = engine._spec.shares_target
        if job.get("draft_cache"):
            out["draft_cache"] = {
                name: getattr(engine._spec.cache, name).numpy().copy()
                for name in engine._spec.cache._fields}
    engine.release()
    out["record"] = engine._instrument_record
    return out


def _end_service(service, job):
    """The daemon's shutdown, which stops the workers — or, for a job
    that is not its group's last (``keep_workers``), its engine released
    and unpublished, the workers left serving."""
    from tensorhive_tpu_torch import serving

    if not job.get("keep_workers"):
        service.shutdown()
        return
    engine = service.engine
    if engine is not None:
        engine.release()
        serving.set_engine(None)


def _service_traffic(job, config_root):
    """The daemon on rank 0 driven with ``job["traffic"]`` (each request to
    its end) until a worker's fault fails the engine; the supervisor's
    rebuild then serves ``job["after"]``."""
    from tensorhive_tpu_torch import serving
    from tensorhive_tpu_torch.core.services.generation import \
        GenerationService

    service = GenerationService(config_root, device="cpu")
    first = service.engine
    errors, tokens = [], []
    for prompt in job["traffic"]:
        if service.engine is not first:
            break
        handle = first.submit(prompt, max_new_tokens=6)
        for _ in range(400):
            service.do_run()
            if handle.done or service.engine is not first:
                break
        try:
            tokens.append(handle.result(timeout_s=1)["tokens"])
        except RuntimeError as exc:
            errors.append(str(exc))
    for _ in range(20):
        if service.engine is not None and service.engine is not first:
            break
        service.do_run()
    rebuilt = service.engine
    handle = rebuilt.submit(job["after"], max_new_tokens=6)
    for _ in range(400):
        if handle.done:
            break
        service.do_run()
    out = {"errors": errors, "tokens": tokens,
           "rebuilt": rebuilt is not first,
           "after": handle.result(timeout_s=5)["tokens"],
           "restarts": serving.get_serving_state()["restarts"],
           "stats": rebuilt.stats()}
    _end_service(service, job)
    return out


def _controller_job(job, params, mesh, drafts=None):
    kind = job["kind"]
    if kind == "run":
        return _run_job(job, params, mesh, drafts)
    if kind == "schedule":
        engine = _engine(job, params, mesh)
        results, trace = run_schedule(engine, job.get("schedule", SCHEDULE))
        out = {"results": results, "trace": trace, "stats": engine.stats(),
               "rules_kv_heads": engine._rules.kv_heads,
               "shard_heads": engine._kernel_shard_heads,
               "cache": {name: getattr(engine._cache, name).numpy().copy()
                         for name in engine._cache._fields}}
        engine.release()
        return out
    if kind == "fault":
        engine = _engine(job, params, mesh)
        engine.submit([1, 2, 3, 4], max_new_tokens=4)
        started = time.monotonic()
        try:
            engine.pump()
        except MeshWorkerError as exc:
            return {"error": f"{type(exc).__name__}: {exc}",
                    "seconds": time.monotonic() - started,
                    "broken": mesh.broken}
        return {"error": None}
    from tensorhive_tpu_torch import serving
    from tensorhive_tpu_torch.core.services.generation import (
        GenerationService,
        build_engine,
    )
    from tensorhive_tpu_torch.observability import get_registry, \
        parse_rendered
    if kind == "build_engine":
        engine = build_engine(_generation(job), device="cpu")
        results, _ = run_schedule(engine, SCHEDULE[:3])
        samples = parse_rendered(get_registry().render())
        out = {"stats": engine.stats(), "capacity": engine.capacity,
               "results": results,
               "gauge": samples.get("tpuhive_generate_mesh_devices")}
        engine.release()
        return out
    # kind == "service": the daemon on rank 0, a worker's fault, the
    # supervisor's rebuild reaching the workers; shutdown stops them
    config_root = Config(config_dir=job["config_dir"])
    config_root.generation = _generation(job)
    if kind == "service_traffic":
        return _service_traffic(job, config_root)
    service = GenerationService(config_root, device="cpu")
    first = service.engine
    failed = first.submit([5, 6, 7], max_new_tokens=6)
    for _ in range(20):
        service.do_run()
        if service.engine is not first and service.engine is not None:
            break
    try:
        failed.result(timeout_s=1)
        failed_error = None
    except RuntimeError as exc:
        failed_error = str(exc)
    rebuilt = service.engine
    handle = rebuilt.submit([5, 6, 7], max_new_tokens=6)
    for _ in range(50):
        if handle.done:
            break
        service.do_run()
    out = {"failed_error": failed_error, "rebuilt": rebuilt is not first,
           "tokens": handle.result(timeout_s=5)["tokens"],
           "restarts": serving.get_serving_state()["restarts"],
           "stats": rebuilt.stats()}
    _end_service(service, job)
    return out


def rank_main(rank, world, store, weights, jobs, results):
    """One rank of a ``world``-rank process group running ``jobs``, each
    on the dp x tp mesh it names (every mesh of the group is built up
    front, in one order on every rank); rank 0 puts ``(name, outcome)``
    per job on ``results`` (or ``("error", traceback)``), and a worker
    ``("worker", record)`` per instrumented engine it released.
    ``weights`` is a pickle of the JAX weights (numpy trees) per
    ``kv_heads``, and under ``"drafts"`` JAX's preset drafts by name."""
    torch.set_num_threads(1)
    try:
        torch.distributed.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=60))
        shapes = sorted({(job["dp"], job["tp"]) for job in jobs})
        meshes = {shape: serving_mesh(*shape, device="cpu")
                  for shape in shapes}
        with open(weights, "rb") as file:
            trees = pickle.load(file)
        drafts = trees.pop("drafts", {})
        params = {kv: params_from_jax(tree, tiny_config(kv), device="cpu")
                  for kv, tree in trees.items()}
        control = meshes[shapes[0]]
        if rank:
            builds = _builds(jobs, params, meshes, rank, drafts, results)
            serve_worker(control, lambda: next(builds)())
            return
        for job in jobs:
            results.put((job["name"], _controller_job(
                job, params, meshes[job["dp"], job["tp"]], drafts)))
        if not any(mesh.broken for mesh in meshes.values()):
            stop_workers(control)
    except Exception:
        if rank == 0:
            results.put(("error", traceback.format_exc()))
        raise
