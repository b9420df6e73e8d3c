"""The process around a run: cache directories inside the checkout, the
device check, and the guard against the JAX package being loaded."""
from __future__ import annotations

import os
import sys
from pathlib import Path

#: the checkout's root (the benchmark runs from it)
ROOT = Path(__file__).resolve().parents[2]
#: every cache the run may fill, at fixed paths inside the checkout (the
#: port's own kernel libraries go to build/tensorhive_tpu_torch/)
CACHE_ROOT = ROOT / "build" / "portbench"

#: top-level module names that must not be loaded in the process that
#: prints the result (compared whole: the port's name begins with the JAX
#: package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tensorhive_tpu")


def prepare() -> None:
    """Point every cache at a fixed directory inside the checkout and keep
    libraries from loading JAX on their own."""
    for variable, sub in (("TRITON_CACHE_DIR", "triton"),
                          ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                          ("CUDA_CACHE_PATH", "cuda_cache")):
        path = CACHE_ROOT / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[variable] = str(path)
    os.environ["USE_FLAX"] = "0"
    # kineto finalizes CUPTI after each session: a traced run that retries
    # its span starts with the card's clock synchronized afresh
    os.environ.setdefault("TEARDOWN_CUPTI", "1")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def forbidden_loaded() -> list:
    """The forbidden top-level names present in ``sys.modules``."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def require_devices(chips: int) -> None:
    """Exit without a result when the cell's cards are not there."""
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is available; the benchmark measures the card")
    if torch.cuda.device_count() < chips:
        fail(f"the cell needs {chips} CUDA devices, "
             f"{torch.cuda.device_count()} are visible")


def fail(message: str, code: int = 2) -> None:
    """End the run with ``message`` on standard error and no result."""
    print(f"portbench: {message}", file=sys.stderr, flush=True)
    raise SystemExit(code)


def log(message: str) -> None:
    print(f"portbench: {message}", file=sys.stderr, flush=True)
