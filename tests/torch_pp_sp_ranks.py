"""Rank processes for tests/test_torch_ring.py and
tests/test_torch_train_mesh_pp_sp.py: one spawned process per rank of a
training mesh with sp and pp on the CPU (gloo, a ``FileStore`` under the
test's ``tmp_path``), running a list of jobs in one process group. A mesh
shape is a dict of axis sizes; every shape the jobs name is built up
front, in one order on every rank. Each rank puts ``(job name, rank,
outcome)`` on the result queue per job (``("error", rank, traceback)``
when a job raises). This module imports no JAX; the tests compare with
JAX in the parent."""
from __future__ import annotations

import dataclasses
import datetime
import pickle
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from tensorhive_tpu_torch import train
from tensorhive_tpu_torch.convert import params_from_jax
from tensorhive_tpu_torch.models import encoder
from tensorhive_tpu_torch.models.transformer import TransformerLM
from tensorhive_tpu_torch.parallel import ring as ring_module
from tensorhive_tpu_torch.parallel.mesh import (
    AXES,
    DEFAULT_RULES,
    shard_train_params,
    train_mesh,
)
from tensorhive_tpu_torch.parallel.train_parallel import assemble_train_tree
from tests.torch_train_ranks import (
    model_config,
    numpy_tree,
    rows_of,
    state_bytes,
    whole_state,
)


def shape_key(axes: dict) -> tuple:
    """A mesh shape as a hashable (pp, dp, fsdp, tp, sp) tuple."""
    return tuple(int(axes.get(axis, 1)) for axis in AXES)


def stage_params(whole, config, mesh):
    """This rank's shard of whole params: its blocks of every leaf and
    only its pp stage's layers."""
    layers = mesh.stage_layers(config.n_layers)
    staged = dict(whole, blocks=[whole["blocks"][i] for i in layers])
    return shard_train_params(staged, DEFAULT_RULES, mesh)


def seq_block(array: np.ndarray, mesh, dim: int = 1) -> torch.Tensor:
    """This rank's sp block of a whole [B, S, ...] array, as a tensor."""
    block = array.shape[dim] // mesh.sp
    index = [slice(None)] * array.ndim
    index[dim] = slice(mesh.sp_rank * block, (mesh.sp_rank + 1) * block)
    return torch.from_numpy(np.ascontiguousarray(array[tuple(index)]))


# -- ring jobs -----------------------------------------------------------------

class Spy:
    """Counts the ring's kernel calls (forward and backward, by causal
    flag) and records the shapes each hop moves."""

    def __init__(self) -> None:
        self.calls = {"fwd_causal": 0, "fwd_full": 0, "bwd_causal": 0,
                      "bwd_full": 0}
        self.moved = []
        self._real = (ring_module.flash_attention,
                      ring_module.flash_attention_backward,
                      ring_module.ring_shift)

        def forward(*args, causal=True, **kwargs):
            self.calls["fwd_causal" if causal else "fwd_full"] += 1
            return self._real[0](*args, causal=causal, **kwargs)

        def backward(*args, causal=True, **kwargs):
            self.calls["bwd_causal" if causal else "bwd_full"] += 1
            return self._real[1](*args, causal=causal, **kwargs)

        def shift(tensor, group, size):
            self.moved.append((tuple(tensor.shape), str(tensor.dtype)))
            return self._real[2](tensor, group, size)

        ring_module.flash_attention = forward
        ring_module.flash_attention_backward = backward
        ring_module.ring_shift = shift

    def close(self) -> None:
        (ring_module.flash_attention, ring_module.flash_attention_backward,
         ring_module.ring_shift) = self._real


def job_ring(job, inputs, mesh, rank):
    """Ring attention over this rank's blocks of q, k, v; with ``grad``,
    the gradients of ``sum(out * do)`` (``do`` given) or of
    ``sum(out.float() ** 2)``. Returns the rank's blocks of the output and
    gradients (f32 numpy), its kernel calls and the shapes its hops
    moved."""
    dtype = getattr(torch, job.get("dtype", "float32"))
    q, k, v = (seq_block(inputs[job["inputs"]][name], mesh).to(dtype)
               for name in "qkv")
    spy = Spy()
    try:
        if job.get("grad"):
            q, k, v = (t.requires_grad_() for t in (q, k, v))
        out = ring_module.ring_attention(q, k, v, mesh, causal=job["causal"])
        result = {"out": out.detach().float().numpy(), "dtype": str(
            out.dtype)}
        if job.get("grad"):
            if "do" in inputs[job["inputs"]]:
                do = seq_block(inputs[job["inputs"]]["do"], mesh).to(dtype)
                objective = torch.sum(out * do)
            else:
                objective = torch.sum(out.float() ** 2)
            grads = torch.autograd.grad(objective, (q, k, v))
            result["grads"] = [g.float().numpy() for g in grads]
            result["grad_dtypes"] = [str(g.dtype) for g in grads]
    finally:
        spy.close()
    result["calls"], result["moved"] = spy.calls, spy.moved
    return result


# -- training jobs ---------------------------------------------------------------

def config_of(job):
    """The job's f32 model config (``tests/torch_train_ranks.py``'s, remat
    off) with its ``knobs``."""
    return dataclasses.replace(model_config(job["config"]),
                               **job.get("knobs", {}))


def loss_fn_of(job):
    return (encoder.mlm_loss_packed if job.get("loss") == "mlm"
            else TransformerLM.loss)


def job_grads(job, inputs, mesh, rank):
    """Loss and gradients on the mesh from JAX-made whole weights (each
    rank's shard and stage cut here): every rank's loss, rank 0's
    gradient tree assembled whole, each rank's layer count."""
    config = config_of(job)
    whole = params_from_jax(inputs[job["weights"]], config, "cpu",
                            param_dtype=torch.float32)
    params = stage_params(whole, config, mesh)
    live = train.tree_map(lambda t: t.detach().requires_grad_(), params)
    tokens = rows_of(inputs[job["tokens"]], mesh)
    loss = loss_fn_of(job)(live, tokens, config, mesh)
    grads = torch.autograd.grad(loss, train.tree_leaves(live))
    whole_grads = assemble_train_tree(train._unflatten(live, list(grads)),
                                      mesh)
    # the gradients of the leaves every stage holds whole (embedding, head,
    # final norm), as this rank has them: the same on every rank
    shared = {key: float(torch.sum(torch.abs(leaf.double())))
              for key, leaf in whole_grads.items() if key != "blocks"
              for leaf in train.tree_leaves(leaf)}
    result = {"loss": float(loss), "layers": len(params["blocks"]),
              "shared": shared}
    if rank == 0:
        result["grads"] = numpy_tree(whole_grads)
    return result


def job_step(job, inputs, mesh, rank):
    """One ``make_train_step`` step on the mesh from JAX-made weights:
    metrics, and (rank 0) the whole state after it."""
    config = config_of(job)
    tc = train.TrainConfig(**job["train"])
    whole = params_from_jax(inputs[job["weights"]], config, "cpu",
                            param_dtype=torch.float32)
    params = stage_params(whole, config, mesh)
    opt_state = train.make_optimizer(tc).init(params)
    step = train.make_train_step(config, tc, mesh, loss_fn=loss_fn_of(job))
    params, opt_state, out = step(params, opt_state,
                                  rows_of(inputs[job["tokens"]], mesh))
    result = {"metrics": {key: float(value) for key, value in out.items()},
              "whole": whole_state(params, opt_state, mesh)}
    if rank:
        del result["whole"]
    return result


def job_loop(job, inputs, mesh, rank):
    config = config_of(job)
    tc = train.TrainConfig(**job["train"])
    metrics = train.train_loop(config, tc, mesh=mesh, num_steps=job["steps"],
                               log_every=0, device="cpu")
    return {"loss": metrics["loss"], "grad_norm": metrics["grad_norm"]}


def job_checkpoint(job, inputs, meshes, rank):
    """Init on mesh A from a seed (its bytes against the specs' share, its
    stage's layers only), two steps, save; restore on each other mesh and
    (rank 0) on one device into ``abstract_train_state`` templates; the
    whole trees before and after, then one step on each restored state."""
    config = config_of(job)
    tc = train.TrainConfig(**job["train"])
    mesh_a = meshes[shape_key(job["save"])]
    params, opt_state = train.init_train_state(
        config, tc, torch.Generator().manual_seed(5), mesh=mesh_a)
    held, expected = state_bytes(params, opt_state, config, mesh_a)
    out = {"held": held, "expected": expected,
           "layers": len(params["blocks"])}
    step = train.make_train_step(config, tc, mesh_a)
    tokens = rows_of(inputs[job["tokens"]], mesh_a)
    for _ in range(2):
        params, opt_state, _ = step(params, opt_state, tokens)
    train.save_checkpoint(job["path"], 7, params, opt_state, mesh=mesh_a)
    out.update(saved=whole_state(params, opt_state, mesh_a), restored={},
               losses={}, count=opt_state["count"],
               files=sorted(f"{p.parent.name}/{p.name}"
                            for p in Path(job["path"]).glob("*/*")))
    for shape in job["restore"]:
        mesh = meshes[shape_key(shape)]
        params_like, opt_like = train.abstract_train_state(config, tc, mesh)
        restored_step, params_r, opt_r = train.restore_checkpoint(
            job["path"], params_like, opt_like, mesh=mesh)
        assert restored_step == 7 and opt_r["count"] == opt_state["count"]
        held_r, expected_r = state_bytes(params_r, opt_r, config, mesh)
        assert held_r == expected_r, (held_r, expected_r)
        out["restored"][str(shape)] = whole_state(params_r, opt_r, mesh)
        _, _, metrics = train.make_train_step(config, tc, mesh)(
            params_r, opt_r, rows_of(inputs[job["tokens"]], mesh))
        out["losses"][str(shape)] = float(metrics["loss"])
    if rank == 0:
        _, whole_p, whole_opt = train.restore_checkpoint(
            job["path"], *train.abstract_train_state(config, tc),
            device="cpu")
        out["restored"]["single"] = {
            "params": numpy_tree(whole_p), "mu": numpy_tree(whole_opt["mu"]),
            "nu": numpy_tree(whole_opt["nu"])}
    # the same seed on one device draws the same global params
    single, _ = train.init_train_state(
        config, tc, torch.Generator().manual_seed(5), device="cpu")
    again, _ = train.init_train_state(
        config, tc, torch.Generator().manual_seed(5), mesh=mesh_a)
    out["init_equal"] = all(
        torch.equal(a, b) for a, b in zip(
            train.tree_leaves(single),
            train.tree_leaves(assemble_train_tree(again, mesh_a))))
    if rank:
        return {key: out[key] for key in ("held", "expected", "layers",
                                          "init_equal")}
    return out


#: job kind -> its function; tests/torch_lora_ranks.py adds LoRA's
JOBS = {"ring": job_ring, "grads": job_grads, "step": job_step,
        "loop": job_loop, "checkpoint": job_checkpoint}


def job_meshes(job):
    """The mesh shapes a job names: its ``mesh``, else its ``meshes``, else
    the one it saves on and those it restores on."""
    if "mesh" in job:
        return [job["mesh"]]
    return job.get("meshes") or [job["save"], *job["restore"]]


def rank_main(rank, world, store, inputs_path, jobs, results):
    """One rank of a ``world``-rank gloo group running ``jobs``."""
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=60))
        shapes = sorted({shape_key(shape) for job in jobs
                         for shape in job_meshes(job)})
        meshes = {key: train_mesh(**dict(zip(AXES, key)), device="cpu")
                  for key in shapes}
        with open(inputs_path, "rb") as file:
            inputs = pickle.load(file)
        for job in jobs:
            # a job on one mesh gets it; one that saves and restores, all
            where = (meshes[shape_key(job["mesh"])] if "mesh" in job
                     else meshes)
            outcome = JOBS[job["kind"]](job, inputs, where, rank)
            results.put((job["name"], rank, outcome))
    except Exception:
        results.put(("error", rank, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class FakeDist:
    """What ``train_mesh`` asks of ``torch.distributed``, for one rank of
    a ``world``-rank group: ``new_group`` records each group's members (the
    layout checks of the tests, in one process)."""

    def __init__(self, rank, world):
        self.rank, self.world, self.groups = rank, world, []

    def is_available(self):
        return True

    def is_initialized(self):
        return True

    def get_world_size(self):
        return self.world

    def get_rank(self):
        return self.rank

    def new_group(self, members):
        self.groups.append(list(members))
        return tuple(members)

    @property
    def group(self):
        return type("group", (), {"WORLD": None})


def built_mesh(monkeypatch, rank, world=8, **axes):
    """``train_mesh(**axes)`` as rank ``rank`` of ``world`` builds it, on
    a ``FakeDist``: (the mesh, the fake with the groups it made)."""
    from tensorhive_tpu_torch.parallel import mesh as port_mesh

    fake = FakeDist(rank, world)
    monkeypatch.setattr(port_mesh, "dist", fake)
    monkeypatch.setattr(port_mesh, "_TRAIN_MESHES", {})
    return port_mesh.train_mesh(device="cpu", **axes), fake


class Group:
    """A spawned group of ``world`` ranks running ``jobs`` (started at
    once, so the ranks run beside the parent's JAX work; ``target`` is the
    rank function, ``rank_main`` by default). ``outcomes()``
    waits for them once — every rank joined under ``timeout_s`` from the
    start, or the test fails — and returns {job name: {rank: outcome}}."""

    def __init__(self, tmp_path, world, jobs, inputs, timeout_s,
                 target=None):
        context = torch.multiprocessing.get_context("spawn")
        self.world, self.jobs, self.timeout_s = world, jobs, timeout_s
        self.results = context.Queue()
        self.started = time.monotonic()
        # the inputs go by file: arguments past the spawn pipe's buffer
        # would make each start() wait for its child's imports
        path = tmp_path / "inputs.pkl"
        path.write_bytes(pickle.dumps(inputs))
        self.processes = [
            context.Process(target=target or rank_main, args=(
                rank, world, str(tmp_path / "store"), str(path), jobs,
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
        deadline = self.started + self.timeout_s
        outcomes = {}
        try:
            for _ in range(len(self.jobs) * self.world):
                name, rank, outcome = self.results.get(
                    timeout=max(1.0, deadline - time.monotonic()))
                assert name != "error", f"rank {rank}:\n{outcome}"
                outcomes.setdefault(name, {})[rank] = outcome
            for process in self.processes:
                process.join(timeout=max(1.0, deadline - time.monotonic()))
            assert not any(p.is_alive() for p in self.processes), \
                "a rank did not finish inside the join timeout"
            assert all(p.exitcode == 0 for p in self.processes)
        finally:
            for process in self.processes:
                if process.is_alive():
                    process.kill()
                    process.join(5)
        return outcomes
