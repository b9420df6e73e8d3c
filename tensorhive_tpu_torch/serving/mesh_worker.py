"""The serving mesh's control protocol and its worker loop.

A meshed engine runs one process per rank (``parallel/mesh.py``). Rank 0
is the controller: it owns every piece of host state — the queue, the
``PagePool``, the prefix cache, the ledger, the recorder, the daemon and
its supervisor — and samples. Ranks 1..n-1 are workers: each holds its
weight shard and cache shard and runs :func:`serve_worker`, which loops
on the controller's commands:

* ``BUILD`` — build this rank's shard engine with the worker's factory
  (what the controller's meshed ``SlotEngine`` sends when it is built, so
  a supervisor's rebuild reaches the workers too);
* a dispatch (``PREFILL``, ``CHUNK``, ``STEP``) — run the same device body
  as the controller, on this rank's shards, with the controller's
  operands (tokens, positions, page-table rows, head tokens, slot, real
  length, chunk offset); the body's tp collectives pair with the
  controller's. An engine with the speculative lane runs the lane's
  prefill mirror right after the target's prefill or chunk, in the same
  command;
* the speculative lane's two bodies: ``PROPOSE`` (the draft's catch-up
  window, its lengths, positions, limits and the page table: the
  catch-up and the k proposals) and ``VERIFY`` (the verify window,
  positions, limits and the page table: the batched target pass). Only
  the controller samples and accepts; a worker computes the same bodies,
  whose collectives pair with the controller's, and drops their outputs;
* the host tier's three: ``EXTRACT`` (page ids and the controller's entry
  ids: gather this rank's shard of the pages and copy it down on the
  rank's own copy lane), ``INJECT`` (page ids and entry ids: stage this
  rank's shards of the entries and scatter them into the pages) and
  ``DROP`` (entry ids the controller's store let go: forget this rank's
  shards of them). These hold no collective;
* ``RELEASE`` — drop the shard engine's device state (the controller's
  ``SlotEngine.release``); ``PING`` — nothing (an idle controller's
  heartbeat, inside the process group's timeout); ``STOP`` — leave.

A command is a fixed int64 header broadcast from rank 0 on the control
device (host memory under gloo, the card under NCCL) and, when it carries
operands, one int32 payload of the length the header names. Engine shapes
are static, so both sides know every payload's layout; entry ids are
int64, two int32 words each (:func:`ids_to_words`). After each command but
``STOP`` every rank adds its flags to one all_reduce of two int32 counts
(:func:`finish_command`): ranks that FAILED the command, and ranks that
lacked a host shard an ``INJECT`` named (a copy that failed or did not
land in time: not a fault — the controller recomputes the pages). A
worker that fails surfaces on the controller at that command as
:class:`MeshWorkerError`: a worker whose failure leaves the tp collectives
in step (a build, a host-tier command, or any body at tp 1) reports its
flag and keeps serving; one that failed inside a tp body
(:data:`TP_BODIES`) leaves the loop and the process, which closes its
connections, so the controller's pending collective fails at once instead
of waiting out the group's timeout.
"""
from __future__ import annotations

import gc
import logging
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import ServingMesh

log = logging.getLogger(__name__)

OP_STOP, OP_BUILD, OP_RELEASE, OP_PING = 0, 1, 2, 3
OP_PREFILL, OP_CHUNK, OP_STEP = 4, 5, 6
OP_PROPOSE, OP_VERIFY = 7, 8
OP_EXTRACT, OP_INJECT, OP_DROP = 9, 10, 11
#: commands the worker's engine serves (``SlotEngine._serve_dispatch``)
DISPATCHES = (OP_PREFILL, OP_CHUNK, OP_STEP, OP_PROPOSE, OP_VERIFY,
              OP_EXTRACT, OP_INJECT, OP_DROP)
#: dispatches whose body holds tp collectives: a rank that fails one part
#: way leaves the collectives out of step
TP_BODIES = (OP_PREFILL, OP_CHUNK, OP_STEP, OP_PROPOSE, OP_VERIFY)
#: header: op, up to five arguments, payload length, spare
HEADER_LEN = 8


class MeshWorkerError(RuntimeError):
    """A worker rank failed a command, or the mesh cannot run one (a peer
    gone, a dispatch that failed part way). Fatal to the serving engine:
    the supervisor fails fast and rebuilds."""


def send_command(mesh: ServingMesh, op: int, args: Sequence[int] = (),
                 payload: Sequence[np.ndarray] = ()) -> None:
    """(controller) Broadcast one command and its int32 operands."""
    header = torch.zeros(HEADER_LEN, dtype=torch.int64)
    header[0] = op
    for index, value in enumerate(args):
        header[1 + index] = int(value)
    flat = (np.concatenate([np.asarray(part, np.int32).ravel()
                            for part in payload])
            if payload else np.zeros(0, np.int32))
    header[HEADER_LEN - 2] = flat.size
    dist.broadcast(header.to(mesh.control_device), src=0)
    if flat.size:
        dist.broadcast(torch.from_numpy(flat).to(mesh.control_device), src=0)


def recv_command(mesh: ServingMesh) -> Tuple[int, Tuple[int, ...],
                                             np.ndarray]:
    """(worker) The next command: ``(op, args, payload)``."""
    header = torch.zeros(HEADER_LEN, dtype=torch.int64,
                         device=mesh.control_device)
    dist.broadcast(header, src=0)
    values = header.cpu().tolist()
    size = values[HEADER_LEN - 2]
    payload = np.zeros(0, np.int32)
    if size:
        buffer = torch.zeros(size, dtype=torch.int32,
                             device=mesh.control_device)
        dist.broadcast(buffer, src=0)
        payload = buffer.cpu().numpy()
    return values[0], tuple(values[1:HEADER_LEN - 2]), payload


def ids_to_words(ids: Sequence[int]) -> np.ndarray:
    """Entry ids (int64) as the int32 words a payload carries: two each."""
    return np.asarray(ids, np.int64).view(np.int32)


def words_to_ids(words: np.ndarray) -> np.ndarray:
    """The inverse of :func:`ids_to_words`."""
    return np.ascontiguousarray(words, np.int32).view(np.int64)


def finish_command(mesh: ServingMesh, failed: bool,
                   missing: bool = False) -> Tuple[int, int]:
    """Every rank's flags, summed over the mesh: ``(failed, missing)``,
    the number of ranks that failed the command and the number that
    lacked a host shard it named."""
    flags = torch.tensor([int(bool(failed)), int(bool(missing))],
                         dtype=torch.int32, device=mesh.control_device)
    dist.all_reduce(flags)
    failed_ranks, missing_ranks = flags.cpu().tolist()
    return failed_ranks, missing_ranks


def stop_workers(mesh: ServingMesh) -> None:
    """(controller) End the workers' :func:`serve_worker` loops: the mesh
    is done. Sends ``STOP`` (no reply) unless the mesh is broken already;
    the mesh refuses every later command."""
    if not mesh.is_controller or mesh.broken:
        return
    send_command(mesh, OP_STOP)
    mesh.broken = "stopped"


def serve_worker(mesh: ServingMesh, engine_factory: Callable[[], object],
                 fault_plan: Optional[object] = None) -> None:
    """Serve the controller's commands on a worker rank until ``STOP``.

    ``engine_factory`` builds this rank's meshed ``SlotEngine`` (the same
    configuration as the controller's, e.g. ``build_engine`` on the same
    serving config; a worker's engine is never warmed or driven itself —
    the controller's warmup reaches it as dispatches); its mesh may be any
    mesh of this rank over the same process group as ``mesh``, which
    carries the commands. ``fault_plan`` is installed on each engine built
    (tests inject a worker's failure so). Raises after a body failed inside
    a tensor-parallel dispatch: the collectives are out of step with the
    controller's, so the rank leaves. ``STOP`` releases the engine, which
    ends its copy lane's thread."""
    if mesh.is_controller:
        raise ValueError("serve_worker runs on ranks 1..n-1; rank 0 is the "
                         "controller and serves through its SlotEngine")
    engine = None
    while True:
        op, args, payload = recv_command(mesh)
        if op == OP_STOP:
            if engine is not None:
                engine.release()
            return
        failed = missing = False
        try:
            if op == OP_BUILD:
                if engine is not None:
                    engine.release()
                engine = None
                gc.collect()
                engine = engine_factory()
                built_on = getattr(engine, "mesh", None)
                if built_on is None or built_on.rank != mesh.rank:
                    raise ValueError("the worker's factory built an engine "
                                     "off this rank's serving mesh")
                if fault_plan is not None:
                    engine.fault_plan = fault_plan
            elif op == OP_RELEASE:
                if engine is not None:
                    engine.release()
                engine = None
                gc.collect()
                if torch.cuda.is_available() and torch.cuda.is_initialized():
                    torch.cuda.empty_cache()
            elif op in DISPATCHES:
                if engine is None:
                    raise RuntimeError("dispatch before BUILD")
                missing = bool(engine._serve_dispatch(op, args, payload))
            elif op != OP_PING:
                raise ValueError(f"unknown serving-mesh command {op}")
        except Exception:
            log.exception("serving-mesh worker rank %d failed command %d",
                          mesh.rank, op)
            if op in TP_BODIES and engine is not None \
                    and engine.mesh.tp > 1:
                # close this rank's connections now, so the controller's
                # pending collective fails at once
                engine.mesh.broken = (f"worker rank {mesh.rank} failed "
                                      f"command {op}")
                dist.destroy_process_group()
                raise
            failed = True
        finish_command(mesh, failed, missing)
