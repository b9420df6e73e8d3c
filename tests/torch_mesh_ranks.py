"""Rank processes for tests/test_torch_serving_mesh.py: one spawned process
per rank of a serving mesh on the CPU (gloo, a ``FileStore`` under the
test's ``tmp_path``), running a list of jobs. Rank 0 builds each job's
meshed engine, drives it and puts what it saw on the result queue; the
workers serve it through ``serve_worker``. This module imports no JAX, so a
spawned rank starts in a few seconds; the test compares with JAX in the
parent."""
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
from tensorhive_tpu_torch.serving.engine import SlotEngine
from tensorhive_tpu_torch.serving.faults import DeviceLostError
from tensorhive_tpu_torch.serving.mesh_worker import (
    MeshWorkerError,
    serve_worker,
    stop_workers,
)

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


def tiny_config(kv_heads=None):
    return dataclasses.replace(PRESETS["tiny"], dtype=torch.float32,
                               max_seq_len=128, n_kv_heads=kv_heads)


def run_schedule(engine, schedule):
    """Submit the requests, stepping as each entry says, then drain; after
    every step record each slot's page-table row and the free pages.
    Returns ``(results, trace)``: (outcome, tokens) per request, and one
    (page_table, kvPagesFree) per step (None entries on the contiguous
    layout)."""
    trace = []

    def step():
        engine.step()
        pool = engine._pool
        trace.append((pool.page_table.tolist() if pool is not None else None,
                      pool.free_pages if pool is not None else None))

    handles = []
    for prompt, new, ticks in schedule:
        handles.append(engine.submit(prompt, max_new_tokens=new))
        for _ in range(ticks):
            step()
    while engine.has_work():
        step()
    results = [(summary["outcome"], summary["tokens"])
               for summary in (handle.result(timeout_s=30)
                               for handle in handles)]
    return results, trace


class FailOnStep:
    """A worker's fault plan: the ``nth`` step dispatch raises."""

    def __init__(self, nth: int) -> None:
        self.nth = nth
        self.steps = 0

    def before_dispatch(self, kind: str) -> None:
        if kind == "step":
            self.steps += 1
            if self.steps == self.nth:
                raise DeviceLostError("injected worker fault")


def _engine(job, params, mesh):
    return SlotEngine(params[job.get("kv_heads")],
                      tiny_config(job.get("kv_heads")), mesh=mesh,
                      device="cpu", **job.get("engine", {}))


def _generation(job):
    return GenerationConfig(**{"preset": "tiny", "max_len": 64,
                               **job.get("generation", {}),
                               "mesh_dp": job["dp"], "mesh_tp": job["tp"]})


def _with_fault(factory, nth):
    """``factory`` whose engine's ``nth`` step dispatch raises."""
    def build():
        engine = factory()
        engine.fault_plan = FailOnStep(nth)
        return engine
    return build


def _builds(jobs, params, meshes, rank):
    """Every BUILD a worker will see, in order: a factory per build (a
    job's ``worker_fault`` goes into its first build on rank 1)."""
    from tensorhive_tpu_torch.core.services.generation import build_engine

    for job in jobs:
        mesh = meshes[job["dp"], job["tp"]]
        if job["kind"] in ("schedule", "fault"):
            factories = [lambda job=job, mesh=mesh: _engine(job, params,
                                                            mesh)]
        else:
            # build_engine, or the daemon's boot build and its rebuild
            factories = [lambda job=job: build_engine(_generation(job),
                                                      device="cpu")] * (
                2 if job["kind"] == "service" else 1)
        if job.get("worker_fault") and rank == 1:
            factories[0] = _with_fault(factories[0], job["worker_fault"])
        yield from factories


def _controller_job(job, params, mesh):
    kind = job["kind"]
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
    service.shutdown()
    return out


def rank_main(rank, world, store, weights, jobs, results):
    """One rank of a ``world``-rank process group running ``jobs``, each
    on the dp x tp mesh it names (every mesh of the group is built up
    front, in one order on every rank); rank 0 puts ``(name, outcome)``
    per job on ``results`` (or ``("error", traceback)``). ``weights`` is a
    pickle of the JAX weights (numpy trees) per ``kv_heads``."""
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
        params = {kv: params_from_jax(tree, tiny_config(kv), device="cpu")
                  for kv, tree in trees.items()}
        control = meshes[shapes[0]]
        if rank:
            builds = _builds(jobs, params, meshes, rank)
            serve_worker(control, lambda: next(builds)())
            return
        for job in jobs:
            results.put((job["name"], _controller_job(
                job, params, meshes[job["dp"], job["tp"]])))
        if not any(mesh.broken for mesh in meshes.values()):
            stop_workers(control)
    except Exception:
        if rank == 0:
            results.put(("error", traceback.format_exc()))
        raise
