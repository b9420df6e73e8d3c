"""A configuration, a cell and a per-layer metric added as files are found
by name, with no file of the benchmark edited."""
import filecmp
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def test_added_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "tensorhive_tpu_torch", tmp_path / "tensorhive_tpu_torch")
    home = tmp_path / "portbench"
    config = json.loads((home / "configs" / "mistral-7b.json").read_text())
    config["hidden_size"] = 96
    (home / "configs" / "another-model.json").write_text(json.dumps(config))
    cell = json.loads((home / "cells" / "mistral-7b.chat.json").read_text())
    cell["config"] = "another-model"
    (home / "cells" / "another-model.chat.json").write_text(json.dumps(cell))
    (home / "metrics" / "ticks_in_window.another.py").write_text(
        "def read(run):\n    return float(len(run.ticks))\n")
    benchmark = json.loads((ROOT / "BENCHMARK.json").read_text())
    benchmark["configs"].append({
        "name": "another-model", "source": "https://example.org/config.json",
        "file": "portbench/configs/another-model.json", "reduced": [],
        "why": "a test's model"})
    benchmark["workloads"].append({
        "name": "another-model.chat", "config": "another-model",
        "traffic": "chat", "chips": 1, "why": "a test's cell"})
    benchmark["per_layer"].append({
        "name": "ticks_in_window.another", "unit": "ticks",
        "better": "higher", "source": "program_counter", "layer": "scheduler",
        "moves": "ttft_p90_s", "workloads": ["another-model.chat"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(benchmark))
    process = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "another-model.chat", "--seed", "5", "--seconds", "2", "--trace",
         "1", "--dry-run"], cwd=tmp_path, capture_output=True, text=True,
        timeout=240)
    assert process.returncode == 0, process.stderr[-3000:]
    line = json.loads(process.stdout.strip().splitlines()[-1])
    assert line["metrics"]["ticks_in_window.another"]["value"] > 0
    assert "prefix_hit_rate.chat" not in line["metrics"]
    # every file the benchmark had is unchanged
    compare = filecmp.dircmp(ROOT / "portbench", home,
                             ignore=["__pycache__"])

    def same(node):
        assert not node.diff_files and not node.left_only
        for child in node.subdirs.values():
            same(child)
    same(compare)
