"""The chat cell, kept out of BENCHMARK.json until its tail holds still
(PERF.md, Open questions): its entries join a copy of the benchmark here,
and its rehearsal runs through the same checks as the listed cells'."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
#: the entries that would list the cell
WORKLOAD = {"name": "mistral-7b.chat", "config": "mistral-7b", "traffic": "chat", "chips": 1, "why": "open-loop chat sessions on 64 slots, 4 shared 1-2k system prompts, 1-4 turns: chunked prefill on int8 pages and the prefix cache do the work"}
TTFT = {"name": "ttft_p90_s", "unit": "s", "better": "lower", "bound": 0.25, "source": "host_clock", "workloads": ["mistral-7b.chat"]}
PER_LAYER = [
    {"name": "prefix_hit_rate.chat", "unit": "%", "better": "higher", "source": "program_counter", "layer": "scheduler and prefix cache", "moves": "ttft_p90_s", "workloads": ["mistral-7b.chat"]},
    {"name": "chunk_tick_ms.chat", "unit": "ms", "better": "lower", "source": "program_span", "layer": "model step, prefill", "moves": "ttft_p90_s", "workloads": ["mistral-7b.chat"]},
    {"name": "idle_share.chat", "unit": "%", "better": "lower", "source": "device_trace", "layer": "device", "moves": "ttft_p90_s", "workloads": ["mistral-7b.chat"]}]


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    root = tmp_path_factory.mktemp("chat")
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "tensorhive_tpu_torch", root / "tensorhive_tpu_torch")
    benchmark = json.loads((ROOT / "BENCHMARK.json").read_text())
    benchmark["workloads"].append(WORKLOAD)
    benchmark["end_to_end"].append(TTFT)
    for metric in benchmark["end_to_end"]:
        if metric["name"] == "itl_p95_ms":
            metric["workloads"].append(WORKLOAD["name"])
    benchmark["per_layer"] += PER_LAYER
    (root / "BENCHMARK.json").write_text(json.dumps(benchmark))
    return root


def run(root, *args):
    process = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", WORKLOAD["name"],
         "--seed", "3000000017", "--seconds", "2", "--dry-run", *args],
        cwd=root, capture_output=True, text=True, timeout=240)
    assert process.returncode == 0, process.stderr[-3000:]
    return json.loads(process.stdout.strip().splitlines()[-1])


def test_the_chat_rehearsal_reports_its_metrics(checkout):
    line = run(checkout, "--trace", "0")
    assert line["correct"] is True
    assert set(line["metrics"]) == {"ttft_p90_s", "itl_p95_ms", "setup_s"}
    traced = run(checkout, "--trace", "1")
    assert traced["correct"] is True
    assert {"prefix_hit_rate.chat", "chunk_tick_ms.chat"} <= set(
        traced["metrics"])


@pytest.mark.parametrize("args", [("--fault", "token"), ("--fault", "state"),
                                  ("--control", "fp8")])
def test_chat_faults_and_control_are_not_correct(checkout, args):
    assert run(checkout, "--trace", "0", *args)["correct"] is False
