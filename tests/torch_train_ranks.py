"""Rank processes for tests/test_torch_train_mesh.py: one spawned process
per rank of a training mesh on the CPU (gloo, a ``FileStore`` under the
test's ``tmp_path``), running a list of jobs in one process group. Every
mesh shape the jobs name is built up front, in one order on every rank.
Each rank puts ``(job name, rank, outcome)`` on the result queue per job
(``("error", rank, traceback)`` when a job raises). This module imports no
JAX, so a spawned rank starts in a few seconds; the tests compare with JAX
in the parent."""
from __future__ import annotations

import dataclasses
import datetime
import pickle
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from tensorhive_tpu_torch import data, train
from tensorhive_tpu_torch.convert import params_from_jax
from tensorhive_tpu_torch.models import encoder
from tensorhive_tpu_torch.models import transformer
from tensorhive_tpu_torch.models.transformer import (
    PRESETS,
    TransformerConfig,
    TransformerLM,
)
from tensorhive_tpu_torch.parallel.mesh import (
    DEFAULT_RULES,
    share_bytes,
    shard_train_params,
    train_mesh,
)
from tensorhive_tpu_torch.parallel.train_parallel import (
    assemble_train_tree,
)

#: the model configurations of the jobs, f32 (the JAX tests' widths)
CONFIGS = {
    # test_sharded_train_step_runs_and_matches_single_device,
    # test_chunked_ce_on_sharded_mesh
    "c1": dict(vocab_size=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
               max_seq_len=128),
    # test_grad_accumulation_on_mesh, the two-process step
    "c2": dict(vocab_size=128, d_model=32, n_heads=2, n_layers=1, d_ff=64,
               max_seq_len=64),
}


def model_config(name: str, **knobs) -> TransformerConfig:
    if name in CONFIGS:
        base = TransformerConfig(**CONFIGS[name])
    elif name == "encoder":
        base = encoder.ENCODER_PRESETS["tiny"]
    else:
        base = PRESETS[name]
    return dataclasses.replace(base, dtype=torch.float32, remat=False,
                               **knobs)


def numpy_tree(tree):
    return train.tree_map(lambda t: t.detach().numpy().copy(), tree)


def rows_of(batch: np.ndarray, mesh) -> torch.Tensor:
    """This rank's rows of a global batch."""
    rows = batch.shape[0] // mesh.data_size
    return torch.from_numpy(
        batch[mesh.data_rank * rows:(mesh.data_rank + 1) * rows].copy())


def state_bytes(params, opt_state, config, mesh):
    """(bytes this rank holds of params, mu and nu, bytes its specs give
    it): the spec share of the whole tree (``meta``), three times."""
    held = sum(leaf.numel() * leaf.element_size()
               for tree in (params, opt_state["mu"], opt_state["nu"])
               for leaf in train.tree_leaves(tree))
    whole = TransformerLM.init(config, device="meta",
                               param_dtype=torch.float32)
    return held, 3 * share_bytes(whole, mesh, DEFAULT_RULES)


def whole_state(params, opt_state, mesh):
    """Params, mu and nu assembled over the mesh, as numpy (every rank
    assembles; rank 0 reports)."""
    return {key: numpy_tree(assemble_train_tree(tree, mesh))
            for key, tree in (("params", params), ("mu", opt_state["mu"]),
                              ("nu", opt_state["nu"]))}


def job_step(job, inputs, mesh, rank):
    """``steps`` steps of ``make_train_step`` on the mesh from JAX-made
    weights: metrics per step, the rank's ``w_in`` block and state bytes,
    and (rank 0) the whole state after the steps."""
    config = model_config(job["config"], **job.get("knobs", {}))
    tc = train.TrainConfig(**job["train"])
    if job.get("chunk"):
        transformer._chunk_threshold_bytes = lambda device: 0
    whole = params_from_jax(inputs[job["weights"]], config, "cpu",
                            param_dtype=torch.float32)
    params = shard_train_params(whole, DEFAULT_RULES, mesh)
    opt_state = train.make_optimizer(tc).init(params)
    loss_fn = (encoder.mlm_loss_packed if job.get("loss") == "mlm"
               else TransformerLM.loss)
    step = train.make_train_step(config, tc, mesh, loss_fn=loss_fn)
    tokens = rows_of(inputs[job["tokens"]], mesh)
    apply_err = None
    if job.get("loss") != "mlm":
        # the logits of the rank's rows, assembled over tp, against one
        # device's on the same rows
        with torch.no_grad():
            ours = TransformerLM.apply(params, tokens[:, :-1], config,
                                       mesh=mesh)
            theirs = TransformerLM.apply(whole, tokens[:, :-1], config)
        apply_err = float((ours - theirs).abs().max())
    metrics = []
    for _ in range(job.get("steps", 1)):
        params, opt_state, out = step(params, opt_state, tokens)
        metrics.append({key: float(value) for key, value in out.items()})
    held, expected = state_bytes(params, opt_state, config, mesh)
    result = {"metrics": metrics, "apply_err": apply_err, "w_in": tuple(
        params["blocks"][0]["w_in"].shape), "held": held,
        "expected": expected, "whole": whole_state(params, opt_state, mesh)}
    if rank:
        del result["whole"]
    return result


class Recorder:
    """A telemetry emitter that records what it is sampled with."""

    def __init__(self) -> None:
        self.samples = []

    def sample(self, **fields):
        self.samples.append(fields)


def job_loop(job, inputs, mesh, rank):
    config = model_config(job["config"])
    tc = train.TrainConfig(**job["train"])
    telemetry = Recorder()
    metrics = train.train_loop(config, tc, mesh=mesh, num_steps=job["steps"],
                               log_every=0, telemetry=telemetry,
                               sync_every=1, device="cpu")
    return {"loss": metrics["loss"], "grad_norm": metrics["grad_norm"],
            "samples": len(telemetry.samples)}


def job_checkpoint(job, inputs, meshes, rank):
    """Init on mesh A from a seed, save; restore on each other mesh into
    ``abstract_train_state`` templates; the whole trees before and after,
    then one step on each restored state."""
    config = model_config(job["config"])
    tc = train.TrainConfig(**job["train"])
    mesh_a = meshes[tuple(job["save"])]
    params, opt_state = train.init_train_state(
        config, tc, torch.Generator().manual_seed(5), mesh=mesh_a)
    step = train.make_train_step(config, tc, mesh_a)
    tokens = rows_of(inputs[job["tokens"]], mesh_a)
    for _ in range(2):
        params, opt_state, _ = step(params, opt_state, tokens)
    train.save_checkpoint(job["path"], 7, params, opt_state, mesh=mesh_a)
    out = {"saved": whole_state(params, opt_state, mesh_a),
           "count": opt_state["count"], "restored": {}, "losses": {},
           "files": sorted(f"{p.parent.name}/{p.name}"
                           for p in Path(job["path"]).glob("*/*"))}
    for shape in job["restore"]:
        mesh = meshes[tuple(shape)]
        params_like, opt_like = train.abstract_train_state(config, tc, mesh)
        assert all(leaf.is_meta for leaf in train.tree_leaves(params_like))
        restored_step, params_r, opt_r = train.restore_checkpoint(
            job["path"], params_like, opt_like, mesh=mesh)
        assert restored_step == 7 and opt_r["count"] == opt_state["count"]
        held, expected = state_bytes(params_r, opt_r, config, mesh)
        assert held == expected, (held, expected)
        out["restored"][str(shape)] = whole_state(params_r, opt_r, mesh)
        _, _, metrics = train.make_train_step(config, tc, mesh)(
            params_r, opt_r, rows_of(inputs[job["tokens"]], mesh))
        out["losses"][str(shape)] = float(metrics["loss"])
    # across formats: the mesh's files into whole (single-device)
    # templates, and a single-device file restored on a mesh
    single_path = str(Path(job["path"]).with_name("single"))
    saved = out["saved"]
    if rank == 0:
        _, whole_r, whole_opt = train.restore_checkpoint(
            job["path"], *train.abstract_train_state(config, tc),
            device="cpu")
        out["whole_restore"] = all(
            np.array_equal(got.numpy(), want)
            for tree, key in ((whole_r, "params"), (whole_opt["mu"], "mu"),
                              (whole_opt["nu"], "nu"))
            for got, want in zip(train.tree_leaves(tree),
                                 train.tree_leaves(saved[key])))
        train.save_checkpoint(single_path, 7, train.tree_map(
            torch.from_numpy, saved["params"]), {
                "count": opt_state["count"],
                "mu": train.tree_map(torch.from_numpy, saved["mu"]),
                "nu": train.tree_map(torch.from_numpy, saved["nu"])})
    dist.barrier()
    mesh = meshes[tuple(job["restore"][0])]
    _, params_s, opt_s = train.restore_checkpoint(
        single_path, *train.abstract_train_state(config, tc, mesh),
        mesh=mesh)
    out["from_single"] = whole_state(params_s, opt_s, mesh)
    # the same seed on one device draws the same global params
    single, _ = train.init_train_state(
        config, tc, torch.Generator().manual_seed(5), device="cpu")
    again, _ = train.init_train_state(
        config, tc, torch.Generator().manual_seed(5), mesh=mesh_a)
    out["init_equal"] = all(
        torch.equal(a, b) for a, b in zip(
            train.tree_leaves(single),
            train.tree_leaves(assemble_train_tree(again, mesh_a))))
    return out if rank == 0 else {"count": out["count"]}


def job_data(job, inputs, mesh, rank):
    """The two-process step's counterpart: each data rank reads its own
    rows of ``batch_at(0)`` through ``prefetch_to_device``; every tp rank
    of a data shard must read the same rows."""
    config = model_config(job["config"])
    tc = train.TrainConfig(**job["train"])
    dataset = data.TokenDataset(data.DataConfig(
        pattern=job["pattern"], seq_len=tc.seq_len,
        batch_size=tc.batch_size, vocab_size=config.vocab_size))
    tokens = next(data.prefetch_to_device(dataset, 0, 1, device="cpu",
                                          mesh=mesh))
    expected = torch.from_numpy(dataset.batch_at(0))
    rows = tc.batch_size // mesh.data_size
    own = torch.equal(tokens, expected[mesh.data_rank * rows:
                                       (mesh.data_rank + 1) * rows])
    # the tp ranks of a shard agree: the sum over the tp group is tp x
    # this rank's rows exactly when they all hold the same rows
    total = tokens.to(torch.float64)
    if mesh.tp_group is not None:
        dist.all_reduce(total, group=mesh.tp_group)
    same = torch.equal(total, tokens.to(torch.float64) * mesh.tp)
    whole = params_from_jax(inputs[job["weights"]], config, "cpu",
                            param_dtype=torch.float32)
    params = shard_train_params(whole, DEFAULT_RULES, mesh)
    _, _, metrics = train.make_train_step(config, tc, mesh)(
        params, train.make_optimizer(tc).init(params), tokens)
    return {"loss": float(metrics["loss"]), "own_rows": own,
            "tp_same_rows": same}


JOBS = {"step": job_step, "loop": job_loop, "data": job_data}


def rank_main(rank, world, store, inputs_path, jobs, results):
    """One rank of a ``world``-rank gloo group running ``jobs``."""
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=60))
        shapes = sorted({tuple(shape) for job in jobs
                         for shape in ([job["mesh"]] if "mesh" in job
                                       else [job["save"], *job["restore"]])})
        meshes = {shape: train_mesh(*shape, device="cpu")
                  for shape in shapes}
        with open(inputs_path, "rb") as file:
            inputs = pickle.load(file)
        threshold = transformer._chunk_threshold_bytes
        for job in jobs:
            if job["kind"] == "checkpoint":
                outcome = job_checkpoint(job, inputs, meshes, rank)
            else:
                outcome = JOBS[job["kind"]](job, inputs,
                                            meshes[tuple(job["mesh"])], rank)
            transformer._chunk_threshold_bytes = threshold
            results.put((job["name"], rank, outcome))
    except Exception:
        results.put(("error", rank, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
