"""Launch-topology templates of GPU hosts — the counterpart of
``tensorhive_tpu/core/templates.py``: a template takes a placement (ordered
host/card assignments) and returns one task descriptor per process
(command, env, params).

The chip binding is ``CUDA_VISIBLE_DEVICES`` where JAX binds
``TPU_VISIBLE_CHIPS``, and the TPU launchers (``jax``, ``multislice``,
``torch-xla``) give way to one for ``torch.distributed``:

* ``torchrun``   — ``MASTER_ADDR`` (placement 0), ``MASTER_PORT`` (12355),
                   ``NODE_RANK`` and ``WORLD_SIZE`` per process: the env of
                   ``torch-xla`` without ``PJRT_DEVICE``.
* ``tf-config``  — ``TF_CONFIG`` JSON with ports assigned per host from
                   2222.
* ``tf-cluster`` — TF1 ClusterSpec params ``--ps_hosts``/
                   ``--worker_hosts``/``--job_name``/``--task_index``.
* ``plain``      — no distributed wiring, just the per-process binding.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List, Optional, Sequence

TF_BASE_PORT = 2222
TORCH_MASTER_PORT = 12355
#: the per-process card binding
CHIP_ENV_VAR = "CUDA_VISIBLE_DEVICES"


class ValidationError(ValueError):
    """A template request that cannot be rendered (the JAX package's
    ``ValidationError``)."""


@dataclasses.dataclass
class Placement:
    """One process slot: a host and the cards the process may use."""

    hostname: str
    address: str = ""            # routable address; defaults to hostname
    chips: Optional[List[int]] = None

    def __post_init__(self) -> None:
        if not self.address:
            self.address = self.hostname


@dataclasses.dataclass
class TaskSpec:
    """Renderer output: one process to spawn."""

    hostname: str
    command: str
    env: Dict[str, str] = dataclasses.field(default_factory=dict)
    params: Dict[str, str] = dataclasses.field(default_factory=dict)


Renderer = Callable[[str, Sequence[Placement], Dict], List[TaskSpec]]
_TEMPLATES: Dict[str, Renderer] = {}


def register_template(name: str):
    def decorate(fn: Renderer) -> Renderer:
        _TEMPLATES[name] = fn
        return fn
    return decorate


def template_names() -> List[str]:
    return sorted(_TEMPLATES)


def render_template(
    name: str,
    command: str,
    placements: Sequence[Placement],
    options: Optional[Dict] = None,
) -> List[TaskSpec]:
    try:
        renderer = _TEMPLATES[name]
    except KeyError:
        raise ValidationError(
            f"unknown template {name!r}; available: {template_names()}"
        )
    if not placements:
        raise ValidationError("template needs at least one placement")
    return renderer(command, list(placements), dict(options or {}))


def _chip_env(placement: Placement) -> Dict[str, str]:
    """Per-process card binding: ``CUDA_VISIBLE_DEVICES=<i,j,...>``."""
    if placement.chips is None:
        return {}
    return {CHIP_ENV_VAR: ",".join(str(c) for c in placement.chips)}


def _assign_ports(placements: Sequence[Placement], base_port: int) -> List[str]:
    """'addr:port' per placement; processes sharing a host get consecutive
    ports from base_port."""
    next_port: Dict[str, int] = {}
    addresses = []
    for placement in placements:
        port = next_port.get(placement.address, base_port)
        next_port[placement.address] = port + 1
        addresses.append(f"{placement.address}:{port}")
    return addresses


@register_template("plain")
def _plain(command, placements, options) -> List[TaskSpec]:
    return [
        TaskSpec(hostname=p.hostname, command=command, env=_chip_env(p))
        for p in placements
    ]


@register_template("torchrun")
def _torchrun(command, placements, options) -> List[TaskSpec]:
    """``torch.distributed`` env per process (what ``torchrun`` and
    ``init_process_group("env://")`` read): placement 0 is the master."""
    port = int(options.get("master_port", TORCH_MASTER_PORT))
    master = placements[0].address
    specs = []
    for rank, placement in enumerate(placements):
        env = {
            "MASTER_ADDR": master,
            "MASTER_PORT": str(port),
            "NODE_RANK": str(rank),
            "WORLD_SIZE": str(len(placements)),
            **_chip_env(placement),
        }
        specs.append(TaskSpec(placement.hostname, command, env=env))
    return specs


@register_template("tf-config")
def _tf_config(command, placements, options) -> List[TaskSpec]:
    """TF_CONFIG: ports assigned per host from 2222; an all-worker
    cluster whose worker 0 acts as chief."""
    base_port = int(options.get("base_port", TF_BASE_PORT))
    addresses = _assign_ports(placements, base_port)
    cluster = {"worker": addresses}
    specs = []
    for index, placement in enumerate(placements):
        tf_config = json.dumps({
            "cluster": cluster,
            "task": {"type": "worker", "index": index},
        })
        specs.append(TaskSpec(
            placement.hostname, command,
            env={"TF_CONFIG": tf_config, **_chip_env(placement)},
        ))
    return specs


@register_template("tf-cluster")
def _tf_cluster(command, placements, options) -> List[TaskSpec]:
    """TF1 ClusterSpec params; the first options['num_ps'] placements
    become parameter servers."""
    num_ps = int(options.get("num_ps", 0))
    if num_ps >= len(placements):
        raise ValidationError("num_ps must leave at least one worker")
    base_port = int(options.get("base_port", TF_BASE_PORT))
    addresses = _assign_ports(placements, base_port)
    ps_hosts = ",".join(addresses[:num_ps])
    worker_hosts = ",".join(addresses[num_ps:])
    specs = []
    for index, placement in enumerate(placements):
        is_ps = index < num_ps
        params = {
            "--ps_hosts": ps_hosts,
            "--worker_hosts": worker_hosts,
            "--job_name": "ps" if is_ps else "worker",
            "--task_index": str(index if is_ps else index - num_ps),
        }
        specs.append(TaskSpec(placement.hostname, command,
                              env=_chip_env(placement), params=params))
    return specs
