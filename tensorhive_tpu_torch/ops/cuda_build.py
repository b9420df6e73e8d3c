"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with
a plain C interface and loaded with ``ctypes`` — no PyTorch headers, so a
build takes seconds, not minutes. Libraries land in
``build/tensorhive_tpu_torch/`` at the root of the checkout, named by a
hash of the sources and flags: a changed source builds anew, an unchanged
one is reused. Nothing is compiled when a module is imported; the first
launch (or ``build``) compiles. ``load_count`` counts the libraries this
process has built or loaded: the serving engine's flight recorder diffs it
per tick (its ``compiles`` column).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parent.parent.parent / "build"
             / "tensorhive_tpu_torch")
KERNELS = ("flash_fwd", "flash_bwd", "paged_decode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libraries: Dict[str, ctypes.CDLL] = {}
#: libraries built or loaded by ``load`` in this process
_loads = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [str(Path(home) / "bin" / "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for candidate in candidates:
        if candidate and os.access(candidate, os.X_OK):
            return candidate
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                       "built from csrc/ at first use")


def toolkit_tool(name: str) -> str:
    """A binary of the CUDA toolkit that holds ``nvcc`` (e.g. ``cuobjdump``)."""
    return str(Path(_nvcc()).parent / name)


def library_path(name: str) -> Path:
    if name not in KERNELS:
        raise ValueError(f"unknown kernel library {name!r}")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for source in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        digest.update(source.name.encode())
        digest.update(source.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together. Returns each library's
    ``ptxas`` report (registers, shared memory, spills); raises with the
    compiler output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started: List[Tuple[str, Path, Path, subprocess.Popen]] = []
    reports: Dict[str, str] = {}
    for name in names:
        target = library_path(name)
        log = target.with_suffix(".log")
        if target.exists():
            reports[name] = log.read_text() if log.exists() else ""
            continue
        partial = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        command = [_nvcc(), *NVCC_FLAGS, "-o", str(partial),
                   str(CSRC / f"{name}.cu")]
        started.append((name, target, partial, subprocess.Popen(
            command, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    for name, target, partial, process in started:
        output, _ = process.communicate()
        if process.returncode != 0:
            failures.append(f"{name}: nvcc exit {process.returncode}\n{output}")
            continue
        target.with_suffix(".log").write_text(output)
        os.replace(partial, target)
        reports[name] = output
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name`` (built first when missing)."""
    global _loads
    library = _libraries.get(name)
    if library is None:
        build([name])
        library = ctypes.CDLL(str(library_path(name)))
        _libraries[name] = library
        _loads += 1
    return library


def load_count() -> int:
    """Libraries ``load`` has built or loaded in this process so far."""
    return _loads


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
