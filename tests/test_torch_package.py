"""Package rules of the port: it imports neither JAX nor anything of the
JAX package (the serving daemon and its observability included), its entry
points — the daemon and the telemetry emitter among them — refuse to run
without CUDA unless the CPU is asked for by name, serving knobs it cannot
serve yet are refused with "not yet ported", and ``auto`` knobs resolve as
in JAX."""
import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tensorhive_tpu_torch import resolve_device, train
from tensorhive_tpu_torch.config import Config, GenerationConfig
from tensorhive_tpu_torch.core.services.generation import (
    GenerationService,
    build_engine,
)
from tensorhive_tpu_torch.models import decode, encoder
from tensorhive_tpu_torch.models.transformer import PRESETS, TransformerLM
from tensorhive_tpu_torch.serving.engine import SlotEngine
from tensorhive_tpu_torch.telemetry import TelemetryEmitter

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
            "import tensorhive_tpu_torch.core.services.base\n"
            "import tensorhive_tpu_torch.observability.accounting\n"
            "import tensorhive_tpu_torch.observability.profiling\n"
            "import tensorhive_tpu_torch.observability.requests\n"
            "import tensorhive_tpu_torch.observability.tracing\n"
            "import tensorhive_tpu_torch.serving.flight_recorder\n"
            "import tensorhive_tpu_torch.telemetry\n"
            "import tensorhive_tpu_torch.utils.threading\n"
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


def test_daemon_and_emitter_need_cuda_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    config = Config(config_dir=tmp_path)
    config.generation = GenerationConfig(max_len=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        GenerationService(config)
    with pytest.raises(RuntimeError, match="CUDA"):
        TelemetryEmitter(metrics_dir=str(tmp_path))
    service = GenerationService(config, device="cpu")
    try:
        assert service.engine.device == torch.device("cpu")
    finally:
        service.shutdown()
    emitter = TelemetryEmitter(metrics_dir=str(tmp_path), device="cpu")
    assert emitter.devices == [torch.device("cpu")]


@pytest.mark.parametrize("knob", ["mesh_dp", "mesh_tp"])
def test_daemon_refuses_the_serving_mesh(knob, tmp_path):
    """The daemon builds through ``build_engine``: the mesh knobs are
    refused there too, not swallowed as a checkpoint failure."""
    config = Config(config_dir=tmp_path)
    config.generation = GenerationConfig(max_len=64, **{knob: 2})
    with pytest.raises(ValueError, match="not yet ported"):
        GenerationService(config, device="cpu")


@pytest.mark.parametrize("knob,value", [("mesh_dp", 2), ("mesh_tp", 2)])
def test_unported_knobs_are_refused(knob, value):
    generation = GenerationConfig(preset="tiny", max_len=64, **{knob: value})
    with pytest.raises(ValueError, match="not yet ported") as info:
        build_engine(generation, device="cpu")
    assert knob in str(info.value)


def test_host_kv_tier_builds_and_serves():
    """KV tiering, once refused, is served: ``build_engine`` builds a
    tiered engine (store and lane, no copy stream on the CPU), warms the
    tier's path and the engine answers a request."""
    engine = build_engine(GenerationConfig(preset="tiny", max_len=64,
                                           host_kv_bytes=1 << 20),
                          device="cpu")
    assert engine._host_store is not None and engine._copy_stream is None
    handle = engine.submit(list(range(1, 40)), max_new_tokens=5)
    engine.pump()
    summary = handle.result(timeout_s=5)
    assert summary["outcome"] == "completed" and len(summary["tokens"]) == 5
    stats = engine.stats()
    assert stats["hostKvBytes"] == 1 << 20 and stats["hostHitRate"] == 0.0
    assert stats["kvPagesFree"] + stats["cachedPages"] == (
        stats["kvPagesTotal"])


def test_speculative_on_builds_and_serves():
    """The speculative lane, once refused, is served: ``build_engine``
    warms a propose and a verify and the engine answers a request."""
    engine = build_engine(GenerationConfig(preset="tiny", max_len=64,
                                           speculative="on", draft_layers=1),
                          device="cpu")
    handle = engine.submit([1, 2, 3], max_new_tokens=5)
    engine.pump()
    summary = handle.result(timeout_s=5)
    assert summary["outcome"] == "completed" and len(summary["tokens"]) == 5
    stats = engine.stats()
    assert stats["speculative"] == "on" and stats["specTokens"] == 4
    assert stats["specProposed"] > 0 and stats["kvPagesFree"] == (
        stats["kvPagesTotal"] - stats["cachedPages"])


def test_auto_knobs_resolve_off():
    """``auto`` resolves as in JAX: the prefix cache on for the paged layout
    and off for the contiguous one (int8 pages likewise), and the
    speculative lane off on the CPU (on where the engine runs on the
    card)."""
    params = TransformerLM.init(TINY, device="cpu")
    stats = SlotEngine(params, TINY, slots=2, max_len=64,
                       device="cpu").stats()
    assert stats["prefixCache"] == "on" and stats["speculative"] == "off"
    assert stats["kvQuant"] == "on" and stats["pagedKernel"] == "cuda"
    assert stats["prefillChunkTokens"] == 256 and stats["cachedPages"] == 0
    stats = SlotEngine(params, TINY, slots=2, max_len=64, paged=False,
                       device="cpu").stats()
    assert stats["prefixCache"] == "off" and stats["speculative"] == "off"
    assert stats["kvQuant"] == "off" and stats["pagedKernel"] is None
    assert stats["kvPagesTotal"] is None and stats["cachedPages"] is None
