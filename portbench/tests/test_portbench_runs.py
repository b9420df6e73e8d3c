"""Whole runs of the harness on the CPU: every cell's tiny rehearsal
prints a well-formed line; the guards refuse what they must; ``correct``
comes out false under each planted fault and under the control."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [entry["name"] for entry in BENCHMARK["workloads"]]


def run(*args, cwd=ROOT, timeout=240, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--seed", "3000000017",
         "--seconds", "2", *args], cwd=cwd, capture_output=True, text=True,
        timeout=timeout, env=env)


def result(process):
    assert process.returncode == 0, process.stderr[-3000:]
    return json.loads(process.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_dry_run_prints_a_well_formed_line(cell, trace):
    line = result(run("--workload", cell, "--trace", str(trace),
                      "--dry-run"))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    for name, check in line["checks"].items():
        assert check["value"] <= check["limit"], name
    names = {m["name"]: m for m in BENCHMARK["end_to_end"]}
    if trace == 0:
        wanted = {m for m, entry in names.items()
                  if cell in entry.get("workloads", [cell])}
        assert set(line["metrics"]) == wanted
    for name, metric in line["metrics"].items():
        assert isinstance(metric["value"], float)
        assert metric["unit"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])


@pytest.mark.parametrize("cell, fault", [
    ("mistral-7b.decode", "token"), ("mistral-7b.decode", "state"),
    ("internlm2-1.8b.train", "half_batch"), ("internlm2-1.8b.train", "state"),
    ("internlm2-1.8b.long", "state"),
])
def test_a_planted_fault_is_not_correct(cell, fault):
    line = result(run("--workload", cell, "--trace", "0", "--dry-run",
                      "--fault", fault))
    assert line["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    line = result(run("--workload", cell, "--trace", "0", "--dry-run",
                      "--control", "fp8"))
    assert line["correct"] is False


def test_no_card_means_no_result():
    process = run("--workload", CELLS[0], "--trace", "0")
    if process.returncode == 0 and process.stdout.strip():
        pytest.skip("a CUDA card is present")
    assert process.stdout.strip() == ""
    assert "CUDA" in process.stderr


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    process = run("--workload", CELLS[0], "--trace", "0", "--dry-run",
                  cwd=tmp_path)
    assert process.returncode != 0
    assert process.stdout.strip() == ""


def test_a_loaded_jax_package_means_no_result(tmp_path):
    """The guard compares top-level names whole: a stand-in module named
    ``tensorhive_tpu`` (the JAX package's name) loaded before the run
    stops it; the port's own ``tensorhive_tpu_torch`` does not."""
    (tmp_path / "tensorhive_tpu.py").write_text("")
    (tmp_path / "sitecustomize.py").write_text("import tensorhive_tpu\n")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    process = run("--workload", CELLS[0], "--trace", "0", "--dry-run",
                  env=env)
    assert process.returncode == 3
    assert process.stdout.strip() == ""
    assert "tensorhive_tpu" in process.stderr


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; import portbench.reference.model, "
            "portbench.reference.optim; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    process = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
    loaded = set(json.loads(process.stdout.replace("'", '"')))
    assert not loaded & {"tensorhive_tpu_torch", "tensorhive_tpu", "jax",
                         "jaxlib", "flax"}
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        text = path.read_text()
        assert "tensorhive" not in text.replace("tensorhive_tpu_torch", "")
        assert "import tensorhive" not in text and "from tensorhive" not in text


@pytest.mark.cuda
def test_the_reference_on_the_card_matches_the_cpu():
    import torch

    from portbench.harness import arith, weights
    from portbench.reference import model

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    shape = arith.Shape(hidden=256, intermediate=512, layers=2, heads=4,
                        kv_heads=2, vocab=1000)
    model.exact_f32()
    out = {}
    for device in ("cpu", "cuda"):
        device = torch.device(device)
        embed = weights.embedding(shape, 1, torch.device("cpu"),
                                  torch.float32).to(device)
        blocks = [{k: (v if isinstance(v, dict) else v.to(device))
                   for k, v in weights.layer(shape, 1, i, torch.device("cpu"),
                                             torch.float32).items()}
                  for i in range(2)]
        for block in blocks:
            for norm in ("attn_norm", "mlp_norm"):
                block[norm] = {"scale": block[norm]["scale"].to(device)}
        head = weights.head(shape, 1, torch.device("cpu"),
                            torch.float32).to(device)
        out[device.type] = model.read_logits(
            [list(range(300))], [range(299)], embed, lambda i: blocks[i], 2,
            torch.ones(256, device=device), head, 4, 2, 1e6, 1e-6)[0].cpu()
    assert torch.allclose(out["cpu"], out["cuda"], atol=1e-4, rtol=1e-4)
