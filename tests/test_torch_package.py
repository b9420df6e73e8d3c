"""Package rules of the port: it imports neither JAX nor anything of the
JAX package, its entry points refuse to run without CUDA unless the CPU
is asked for by name, and serving knobs it cannot serve yet are refused
with "not yet ported"."""
import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tensorhive_tpu_torch import resolve_device, train
from tensorhive_tpu_torch.config import GenerationConfig
from tensorhive_tpu_torch.core.services.generation import build_engine
from tensorhive_tpu_torch.models import decode, encoder
from tensorhive_tpu_torch.models.transformer import PRESETS, TransformerLM
from tensorhive_tpu_torch.serving.engine import SlotEngine

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "tensorhive_tpu_torch"
TINY = dataclasses.replace(PRESETS["tiny"], dtype=torch.float32)


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_reference_package_import():
    files = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for module in imported_modules(path):
            root = module.split(".")[0]
            assert root not in ("jax", "jaxlib", "tensorhive_tpu", "flax",
                                "optax", "orbax"), (path, module)


def test_imports_with_jax_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['tensorhive_tpu'] = None\n"
            "import tensorhive_tpu_torch\n"
            "import tensorhive_tpu_torch.core.services.generation\n"
            "import tensorhive_tpu_torch.convert\n"
            "import tensorhive_tpu_torch.train\n"
            "import tensorhive_tpu_torch.data\n"
            "import tensorhive_tpu_torch.models.encoder\n"
            "import tensorhive_tpu_torch.models.lora\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_engine(GenerationConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        TransformerLM(TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        TransformerLM.init(TINY)
    params = TransformerLM.init(TINY, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        SlotEngine(params, TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        decode.generate(params, TINY, [[1, 2]], 2)
    train_config = train.TrainConfig(batch_size=2, seq_len=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.init_train_state(TINY, train_config)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.train_loop(TINY, train_config, num_steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.synthetic_batch(torch.Generator(), train_config, 512)
    with pytest.raises(RuntimeError, match="CUDA"):
        encoder.init_encoder(preset="tiny")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("knob,value", [
    ("prefix_cache", "on"), ("speculative", "on"), ("host_kv_bytes", 1 << 20),
    ("mesh_dp", 2), ("mesh_tp", 2), ("paged", False)])
def test_unported_knobs_are_refused(knob, value):
    generation = GenerationConfig(preset="tiny", max_len=64, **{knob: value})
    with pytest.raises(ValueError, match="not yet ported") as info:
        build_engine(generation, device="cpu")
    assert knob in str(info.value)


def test_auto_knobs_resolve_off():
    engine = SlotEngine(TransformerLM.init(TINY, device="cpu"), TINY, slots=2,
                        max_len=64, device="cpu")
    stats = engine.stats()
    assert stats["prefixCache"] == "off" and stats["speculative"] == "off"
    assert stats["kvQuant"] == "on" and stats["pagedKernel"] == "cuda"
