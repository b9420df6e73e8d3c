"""A run from start to result: the environment, the cell's spec, its
traffic driver, the guard, the metrics and the line."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from . import env
from . import spec as specs
from .arith import Shape
from .record import emit


@dataclass
class Context:
    """What a traffic driver is handed."""
    args: Any
    spec: specs.Spec
    started: float
    device: Any
    shape: Shape

    @property
    def seed(self) -> int:
        return self.args.seed

    @property
    def seconds(self) -> float:
        return self.args.seconds


def log(context: Context, message: str) -> None:
    """Progress on standard error, seconds since the run began."""
    import time

    env.log(f"{time.perf_counter() - context.started:8.2f} s  {message}")


def run(args, started: float) -> int:
    env.prepare()
    spec = specs.load(args.workload, dry=args.dry_run)
    if not args.dry_run:
        env.require_devices(spec.cell["chips"])
    try:
        import torch
        import tensorhive_tpu_torch  # noqa: F401  (the system under test)
    except ImportError as error:
        env.fail(f"the program cannot be loaded: {error}")
    if args.dry_run:
        # the rehearsal's tiny operators: one thread each (the tests run
        # several rehearsals side by side)
        torch.set_num_threads(1)
    device = torch.device("cpu" if args.dry_run else "cuda")
    context = Context(args, spec, started, device, Shape.of(spec.config))
    result = specs.traffic_driver(spec).run(context)
    loaded = env.forbidden_loaded()
    if loaded:
        env.fail(f"the process loaded {', '.join(loaded)}; the benchmark "
                 "measures the port alone", code=3)
    entries = spec.per_layer if args.trace else spec.end_to_end
    metrics = specs.read_metrics(spec, entries, result)
    info = {"platform": "cpu" if args.dry_run else "gpu",
            "kind": ("cpu" if args.dry_run
                     else torch.cuda.get_device_name(0)),
            "count": spec.cell["chips"],
            "memory_peak_bytes": int(result.memory_peak_bytes)}
    if args.trace:
        profile = result.profile
        info["busy_s"] = profile.busy_s if profile else 0.0
        info["window_s"] = profile.window_s if profile else 0.0
    emit(result, metrics, info, bool(args.trace))
    return 0
