"""Rank processes for tests/test_torch_lora_mesh.py: LoRA's jobs on a
training mesh, run by ``tests/torch_pp_sp_ranks.py``'s rank loop (one
spawned process per rank, gloo on the CPU). The base weights and the
adapters come from JAX (numpy trees); each rank cuts its shard of the base
and its stage's layers of both. This module imports no JAX."""
from __future__ import annotations

import functools
from pathlib import Path

import torch

from tensorhive_tpu_torch import train
from tensorhive_tpu_torch.convert import lora_from_jax, params_from_jax
from tensorhive_tpu_torch.models import lora
from tensorhive_tpu_torch.parallel.train_parallel import (
    assemble_train_tree,
    sharded_global_norm,
)
from tests import torch_pp_sp_ranks as pp_sp_ranks
from tests.torch_pp_sp_ranks import config_of, shape_key, stage_params
from tests.torch_train_ranks import numpy_tree, rows_of, whole_state


def stage_adapters(adapters, mesh):
    """A pp rank's stage's layers of a whole adapter tree (the adapters
    are whole on every rank)."""
    layers = mesh.stage_layers(len(adapters["blocks"]))
    return {"blocks": [adapters["blocks"][i] for i in layers]}


def setup(job, inputs, mesh):
    """(config, train config, LoRA config, the rank's base shard, its
    adapters, its rows of the batch)."""
    config = config_of(job)
    whole = params_from_jax(inputs["base"], config, "cpu",
                            param_dtype=torch.float32)
    adapters = stage_adapters(lora_from_jax(inputs["adapters"], "cpu"), mesh)
    return (config, train.TrainConfig(**job["train"]),
            lora.LoraConfig(**job["lora"]), stage_params(whole, config, mesh),
            adapters, rows_of(inputs["tokens"], mesh))


def job_lora_step(job, inputs, mesh, rank):
    """The adapters' loss, gradients and global norm on the mesh, then
    ``steps`` steps of ``make_train_step`` over them: every rank's metrics,
    whether its base shard stayed bitwise as it was, and (rank 0) the
    gradients and the adapters, ``mu`` and ``nu`` after the steps, whole."""
    config, tc, lora_config, base, adapters, tokens = setup(job, inputs,
                                                            mesh)
    before = train.tree_map(torch.clone, base)
    loss_fn = functools.partial(lora.lora_loss, base_params=base,
                                lora_config=lora_config)
    live = train.tree_map(lambda t: t.detach().requires_grad_(), adapters)
    loss = loss_fn(live, tokens, config, mesh)
    grads = list(torch.autograd.grad(loss, train.tree_leaves(live)))
    norm = sharded_global_norm(grads, train.leaf_paths(live), mesh)
    out = {"loss": loss.item(), "grad_norm": norm.item(), "metrics": []}
    whole_grads = numpy_tree(assemble_train_tree(
        train._unflatten(live, grads), mesh))
    step = train.make_train_step(config, tc, mesh, loss_fn=loss_fn)
    opt_state = train.make_optimizer(tc).init(adapters)
    for _ in range(job["steps"]):
        adapters, opt_state, metrics = step(adapters, opt_state, tokens)
        out["metrics"].append({key: float(value)
                               for key, value in metrics.items()})
    out["base_unchanged"] = all(
        torch.equal(a, b) and not a.requires_grad for a, b in zip(
            train.tree_leaves(base), train.tree_leaves(before)))
    state = whole_state(adapters, opt_state, mesh)
    if rank == 0:
        out.update(grads=whole_grads, whole=state)
    return out


def job_lora_init(job, inputs, meshes, rank):
    """``init_lora`` from one seed on each mesh's shards, assembled, against
    the same seed on one device's whole base; and on the ``meta`` device
    (restore templates) at each mesh's local shapes."""
    config = config_of(job)
    lora_config = lora.LoraConfig(**job["lora"])
    whole = params_from_jax(inputs["base"], config, "cpu",
                            param_dtype=torch.float32)
    single = lora.init_lora(whole, lora_config,
                            torch.Generator().manual_seed(3))
    equal = {}
    for shape in job["meshes"]:
        mesh = meshes[shape_key(shape)]
        drawn = lora.init_lora(stage_params(whole, config, mesh),
                               lora_config, torch.Generator().manual_seed(3),
                               mesh=mesh)
        like = lora.init_lora(train.abstract_train_state(
            config, train.TrainConfig(), mesh)[0], lora_config, mesh=mesh)
        shapes = [tuple(t.shape) for t in train.tree_leaves(drawn)]
        assert shapes == [tuple(t.shape) for t in train.tree_leaves(like)]
        assert all(t.is_meta for t in train.tree_leaves(like))
        equal[str(shape)] = all(torch.equal(a, b) for a, b in zip(
            train.tree_leaves(single),
            train.tree_leaves(assemble_train_tree(drawn, mesh))))
    return equal


def job_lora_checkpoint(job, inputs, meshes, rank):
    """Adapters from JAX, ``steps`` LoRA steps on the ``save`` mesh, a
    checkpoint; restored into ``init_lora`` templates on the ``meta``
    device on each ``restore`` mesh and (rank 0) on one device, whole
    trees before and after, then one step on each restored mesh."""
    config = config_of(job)
    tc = train.TrainConfig(**job["train"])
    lora_config = lora.LoraConfig(**job["lora"])
    whole = params_from_jax(inputs["base"], config, "cpu",
                            param_dtype=torch.float32)
    adapters_whole = lora_from_jax(inputs["adapters"], "cpu")

    def run(mesh):
        base = stage_params(whole, config, mesh)
        step = train.make_train_step(
            config, tc, mesh, loss_fn=functools.partial(
                lora.lora_loss, base_params=base, lora_config=lora_config))
        return base, step

    def templates(mesh):
        abstract = train.abstract_train_state(config, tc, mesh)[0]
        like = lora.init_lora(abstract, lora_config, mesh=mesh)
        return like, train.make_optimizer(tc).init(like)

    mesh_a = meshes[shape_key(job["save"])]
    _, step = run(mesh_a)
    adapters = stage_adapters(adapters_whole, mesh_a)
    opt_state = train.make_optimizer(tc).init(adapters)
    tokens = rows_of(inputs["tokens"], mesh_a)
    for _ in range(job["steps"]):
        adapters, opt_state, _ = step(adapters, opt_state, tokens)
    train.save_checkpoint(job["path"], 7, adapters, opt_state, mesh=mesh_a)
    out = {"saved": whole_state(adapters, opt_state, mesh_a),
           "count": opt_state["count"], "restored": {}, "losses": {},
           "files": sorted(f"{p.parent.name}/{p.name}"
                           for p in Path(job["path"]).glob("*/*"))}
    for shape in job["restore"]:
        mesh = meshes[shape_key(shape)]
        restored_step, adapters_r, opt_r = train.restore_checkpoint(
            job["path"], *templates(mesh), mesh=mesh)
        assert restored_step == 7 and opt_r["count"] == opt_state["count"]
        out["restored"][str(shape)] = whole_state(adapters_r, opt_r, mesh)
        _, step_r = run(mesh)
        _, _, metrics = step_r(adapters_r, opt_r,
                               rows_of(inputs["tokens"], mesh))
        out["losses"][str(shape)] = float(metrics["loss"])
    if rank == 0:
        like = lora.init_lora(train.abstract_train_state(config, tc)[0],
                              lora_config)
        _, adapters_s, opt_s = train.restore_checkpoint(
            job["path"], like, train.make_optimizer(tc).init(like),
            device="cpu")
        out["restored"]["single"] = {
            "params": numpy_tree(adapters_s), "mu": numpy_tree(opt_s["mu"]),
            "nu": numpy_tree(opt_s["nu"])}
    return out if rank == 0 else {"count": out["count"]}


JOBS = {"lora_step": job_lora_step, "lora_init": job_lora_init,
        "lora_checkpoint": job_lora_checkpoint}


def rank_main(*args):
    """``tests/torch_pp_sp_ranks.py``'s rank loop with LoRA's jobs."""
    pp_sp_ranks.JOBS.update(JOBS)
    pp_sp_ranks.rank_main(*args)
