"""The port's GPU host plane against the JAX package's TPU one.

* The schema-v1 parser: the same documents (the JAX monitor tests' set)
  through ``parse_probe_output`` of both packages give the same samples
  (the port's chips add the card's ``name``), and both refuse the same
  garbage.
* ``GpuMonitor`` against ``TpuMonitor`` on the JAX package's fake cluster
  (its transports answer the probe marker with a rendered schema-v1
  document): the same per-host subtrees, health and warnings, but the
  device fields — the subtree key (``GPU``), the card's uid (``:gpu:``) and
  name, and the warning for a host without driver counters.
* The native GPU probe (built with ``g++`` from ``native/probe.cpp``) and
  the inline Python probe on a fake device directory (``nvidia0``,
  ``nvidia1``, ``nvidia10``, ``nvidiactl``, ``nvidia-uvm``), with a process
  holding ``nvidia10`` and ``nvidiactl`` open, a fake NVML library (built
  with ``g++``: two cards, minor numbers 0 and 10) and a drop-file
  directory: the same document but the CPU and memory counters, which
  move between the two runs; without NVML both list the nodes.
* Every template's ``TaskSpec``s against JAX's: ``plain``, ``tf-config``
  and ``tf-cluster`` the same with ``CUDA_VISIBLE_DEVICES`` for
  ``TPU_VISIBLE_CHIPS``; ``torchrun`` is ``torch-xla``'s without
  ``PJRT_DEVICE``.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from tensorhive_tpu.config import HostConfig as JaxHostConfig
from tensorhive_tpu.core import templates as jax_templates
from tensorhive_tpu.core.managers.infrastructure import InfrastructureManager
from tensorhive_tpu.core.monitors import probe as jax_probe
from tensorhive_tpu.core.monitors.tpu import TpuMonitor
from tensorhive_tpu.core.transport.base import (
    TransportManager,
    register_backend,
)
from tensorhive_tpu.core.transport.fake import FakeCluster, FakeTransport
from tensorhive_tpu.utils.exceptions import TelemetryError as JaxTelemetryError
from tensorhive_tpu_torch.config import Config, HostConfig
from tensorhive_tpu_torch.core import templates
from tensorhive_tpu_torch.core.monitors import GpuMonitor
from tensorhive_tpu_torch.core.monitors import probe
from tensorhive_tpu_torch.core.monitors.gpu import host_warnings

DOCUMENTS = [
    # noise before the line
    'Welcome to the VM!\n{"v":1,"chips":[{"index":0,"dev":"/dev/accel0",'
    '"pids":[7]}],"procs":{"7":{"user":"a","cmd":"python"}},"cpu":{},'
    '"mem":{},"metrics":{}}\n',
    # stale drop file
    '{"v":1,"chips":[{"index":0,"dev":"d","pids":[]}],"procs":{},"cpu":{},'
    '"mem":{},"metrics":{"0":{"hbm_used_bytes":5,"hbm_total_bytes":10,'
    '"duty_cycle_pct":50.0,"age_s":999.0}}}',
    # counters over drop files, per field
    '{"v":1,"chips":[{"index":0,"dev":"d","pids":[9]},'
    '{"index":1,"dev":"e","pids":[]},{"index":2,"dev":"f","pids":[]}],'
    '"procs":{},"cpu":{"total":1000,"idle":800,"ncpu":8},'
    '"mem":{"total_kb":16,"avail_kb":8},'
    '"metrics":{"0":{"hbm_used_bytes":5,"duty_cycle_pct":50.0,"age_s":1.0},'
    '"1":{"hbm_used_bytes":7,"age_s":1.0},'
    '"2":{"hbm_used_bytes":11,"hbm_total_bytes":100,"age_s":1.0}},'
    '"sysfs_metrics":{"0":{"hbm_used_bytes":999,"hbm_total_bytes":1000,'
    '"duty_cycle_pct":88.0},"2":{"duty_cycle_pct":60.0}},'
    '"sysfs_status":"ok","restricted":3}',
    # no metrics source
    '{"v":1,"chips":[{"index":0,"dev":"d","pids":[3]}],"procs":{},'
    '"cpu":{},"mem":{},"metrics":{}}',
]
GARBAGE = ["not json at all", '{"v": 99}',
           '{"v":1,"chips":[{"dev":"no index"}]}']


def as_dict(sample, drop=()):
    out = dataclasses.asdict(sample)
    for chip in out["chips"]:
        for key in drop:
            chip.pop(key)
    return out


@pytest.mark.parametrize("text", DOCUMENTS)
def test_parsers_agree(text):
    ours = probe.parse_probe_output(text)
    theirs = jax_probe.parse_probe_output(text)
    assert as_dict(ours, drop=("name",)) == as_dict(theirs)
    assert all(chip.name == "" for chip in ours.chips)


@pytest.mark.parametrize("text", GARBAGE)
def test_parsers_refuse_the_same_garbage(text):
    with pytest.raises(JaxTelemetryError):
        jax_probe.parse_probe_output(text)
    with pytest.raises(probe.TelemetryError):
        probe.parse_probe_output(text)


def test_probe_command_carries_marker_and_fallback():
    command = probe.probe_command()
    assert probe.PROBE_MARKER == jax_probe.PROBE_MARKER
    assert probe.PROBE_MARKER in command and "python3 -c" in command
    assert ".tpuhive/bin/tpuhive-gpu-probe" in command
    assert '--metrics-dir "$HOME/.tpuhive/metrics"' in command


# -- the monitors on the fake cluster -------------------------------------------

HOSTS = {"vm-0": 4, "vm-1": 4, "cpubox": 0}
#: the JAX warning -> the port's
WARNING_KEYS = {"sysfs_absent": "driver_counters_absent"}


@pytest.fixture()
def fleet(config):
    """The JAX fake cluster with three hosts (one without cards), its
    transport manager, and the port's Config with the same host fields."""
    cluster = FakeCluster()
    register_backend("fake", lambda host, user=None, config=None:
                     FakeTransport(host, cluster, user))
    port_config = Config()
    for name, chips in HOSTS.items():
        fields = dict(name=name, accelerator_type="h100-80gb" if chips else "",
                      topology="1x4" if chips else "", slice_name="pool-a")
        config.hosts[name] = JaxHostConfig(user="hive", backend="fake",
                                           chips=chips, **fields)
        port_config.hosts[name] = HostConfig(**fields)
        cluster.add_host(name, chips=chips)
    config.ssh.breaker_cooldown_s = 0.0
    manager = TransportManager(config)
    yield cluster, manager, config, port_config
    manager.close()


def device_free(subtree):
    """A card subtree without its device fields, keyed by index."""
    return {chip["index"]: {key: value for key, value in chip.items()
                            if key not in ("uid", "name")}
            for chip in subtree.values()}


def snapshots(cluster, manager, port_config, rounds):
    """Both monitors over ``rounds`` (each a function that changes the
    cluster before a round): the infra snapshot of each after every
    round."""
    ours, theirs = InfrastructureManager(list(HOSTS)), \
        InfrastructureManager(list(HOSTS))
    gpu, tpu = GpuMonitor(port_config), TpuMonitor()
    out = []
    for change in rounds:
        change(cluster)
        gpu.update(manager, ours)
        tpu.update(manager, theirs)
        out.append((ours.infrastructure, theirs.infrastructure))
    return out


def test_gpu_monitor_matches_tpu_monitor(fleet):
    cluster, manager, _, port_config = fleet

    def busy(cluster):
        cluster.host("vm-0").chips[1].update(
            hbm_used_bytes=8 * 2**30, hbm_total_bytes=16 * 2**30,
            duty_cycle_pct=87.5)
        cluster.start_process("vm-0", user="alice",
                              command="python train.py", chip_ids=[1])
        cluster.host("vm-1").sysfs_status = "absent"

    def dark(cluster):
        cluster.host("vm-1").reachable = False

    def back(cluster):
        cluster.host("vm-1").reachable = True
        cluster.host("vm-1").sysfs_status = "ok"

    for ours, theirs in snapshots(cluster, manager, port_config,
                                  [busy, dark, back]):
        assert set(ours) == set(theirs) == set(HOSTS)
        for host in HOSTS:
            assert ("GPU" in ours[host]) == ("TPU" in theirs[host])
            if "GPU" in ours[host]:
                assert device_free(ours[host]["GPU"]) == \
                    device_free(theirs[host]["TPU"])
                for uid, chip in ours[host]["GPU"].items():
                    assert uid == f"{host}:gpu:{chip['index']}"
                    assert chip["name"] == f"h100-80gb {chip['index']}"
            assert ours[host]["HEALTH"]["state"] == \
                theirs[host]["HEALTH"]["state"]
            assert [w["key"] for w in ours[host]["WARNINGS"]] == [
                WARNING_KEYS[w["key"]] for w in theirs[host]["WARNINGS"]]
    first_ours, _ = snapshots(cluster, manager, port_config,
                              [lambda c: None])[0]
    busy_card = first_ours["vm-0"]["GPU"]["vm-0:gpu:1"]
    assert busy_card["duty_cycle_pct"] == 87.5
    assert busy_card["processes"][0]["user"] == "alice"
    assert [w["key"] for w in first_ours["vm-1"]["WARNINGS"]] == []


def test_agent_hosts_are_skipped_as_in_jax(fleet):
    cluster, manager, config, port_config = fleet
    port_config.hosts["vm-1"].agent = True
    config.hosts["vm-1"].agent = True
    ours = InfrastructureManager(list(HOSTS))
    theirs = InfrastructureManager(list(HOSTS))
    gpu, tpu = GpuMonitor(port_config), TpuMonitor()
    assert gpu.agent_hosts(ours) == tpu.agent_hosts(theirs) == {"vm-1"}
    gpu.update(manager, ours)
    tpu.update(manager, theirs)
    assert "GPU" not in ours.infrastructure["vm-1"]
    assert "TPU" not in theirs.infrastructure["vm-1"]


# -- the probes on a fake device directory --------------------------------------

#: a fake NVML: two cards, minor numbers 0 and 10; the second reports no
#: utilization (NVML_ERROR_NOT_SUPPORTED) and no memory in use
FAKE_NVML = r"""
#include <cstdio>
struct Memory { unsigned long long total, free, used; };
struct Utilization { unsigned int gpu, memory; };
static const unsigned kMinor[] = {0, 10};
extern "C" {
int nvmlInit_v2() { return 0; }
int nvmlShutdown() { return 0; }
int nvmlDeviceGetCount_v2(unsigned* n) { *n = 2; return 0; }
int nvmlDeviceGetHandleByIndex_v2(unsigned i, void** h) {
  if (i >= 2) return 2;
  *h = reinterpret_cast<void*>(static_cast<unsigned long>(i) + 1);
  return 0;
}
static unsigned card(void* h) {
  return static_cast<unsigned>(reinterpret_cast<unsigned long>(h) - 1);
}
int nvmlDeviceGetMinorNumber(void* h, unsigned* m) {
  *m = kMinor[card(h)];
  return 0;
}
int nvmlDeviceGetName(void*, char* buf, unsigned len) {
  std::snprintf(buf, len, "NVIDIA H100 80GB HBM3");
  return 0;
}
int nvmlDeviceGetMemoryInfo(void* h, Memory* m) {
  m->total = 85520809984ULL;
  m->used = card(h) ? 0 : 1626341376ULL;
  m->free = m->total - m->used;
  return 0;
}
int nvmlDeviceGetUtilizationRates(void* h, Utilization* u) {
  if (card(h)) return 3;
  u->gpu = 37;
  u->memory = 5;
  return 0;
}
}
"""


@pytest.fixture(scope="module")
def fake_nvml(tmp_path_factory):
    where = tmp_path_factory.mktemp("nvml")
    (where / "fake_nvml.cpp").write_text(FAKE_NVML)
    library = where / "libfake-nvml.so"
    subprocess.run(["g++", "-shared", "-fPIC", "-O1", "-o", str(library),
                    str(where / "fake_nvml.cpp")], check=True, timeout=120)
    return library


@pytest.fixture()
def fake_host(tmp_path, fake_nvml):
    """A device directory (nvidia1 is a node the driver does not list, as
    a container's /dev may hold), a process holding card 1's node and the
    control node open, the fake NVML and a drop-file directory."""
    dev = tmp_path / "dev"
    dev.mkdir()
    for name in ("nvidia0", "nvidia1", "nvidia10", "nvidiactl",
                 "nvidia-uvm", "nvidia-caps"):
        (dev / name).write_text("")
    metrics = tmp_path / "metrics"
    metrics.mkdir()
    (metrics / "train-1.json").write_text(json.dumps(
        {"1": {"hbm_used_bytes": 5, "hbm_total_bytes": 10,
               "duty_cycle_pct": 12.5}}))
    holder = subprocess.Popen(
        [sys.executable, "-c",
         "import sys, time\n"
         "a = open(sys.argv[1]); b = open(sys.argv[2])\n"
         "print('open', flush=True)\n"
         "time.sleep(120)\n",
         str(dev / "nvidia10"), str(dev / "nvidiactl")],
        stdout=subprocess.PIPE, text=True)
    assert holder.stdout.readline().strip() == "open"
    try:
        yield {"dev": dev, "nvml": fake_nvml, "metrics": metrics,
               "pid": holder.pid}
    finally:
        holder.kill()
        holder.wait(10)


def run_json(argv, env):
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout)


def both_probes(env_overrides):
    """(native, inline) documents under the same seams, given as the
    environment (the native probe's flags are held to it below)."""
    env = dict(os.environ, **env_overrides)
    return (run_json([str(probe.build_native_probe())], env),
            run_json([sys.executable, "-c", probe.PYTHON_PROBE_SOURCE], env))


def comparable(doc):
    """A probe document without the counters that move between runs."""
    doc = dict(doc)
    doc.pop("cpu"), doc.pop("mem")
    for metrics in doc["metrics"].values():
        assert metrics.pop("age_s") >= 0.0
    return doc


def test_native_and_inline_gpu_probes_agree(fake_host):
    binary = probe.build_native_probe()
    assert binary == probe.native_probe_path() and binary.exists()
    seams = {"dev": "TPUHIVE_DEV_DIR", "nvml": "TPUHIVE_NVML_LIB",
             "metrics": "TPUHIVE_METRICS_DIR"}
    native, inline = both_probes({env: str(fake_host[key])
                                  for key, env in seams.items()})
    flags = run_json([str(binary), "--dev-dir", str(fake_host["dev"]),
                      "--nvml-lib", str(fake_host["nvml"]), "--metrics-dir",
                      str(fake_host["metrics"])], dict(os.environ))
    assert comparable(native) == comparable(inline) == comparable(flags)
    dev, pid = fake_host["dev"], fake_host["pid"]
    assert native["chips"] == [
        {"index": 0, "dev": str(dev / "nvidia0"),
         "name": "NVIDIA H100 80GB HBM3", "pids": []},
        {"index": 1, "dev": str(dev / "nvidia10"),
         "name": "NVIDIA H100 80GB HBM3", "pids": [pid]}]
    assert native["sysfs_metrics"] == {
        "0": {"hbm_used_bytes": 1626341376, "hbm_total_bytes": 85520809984,
              "duty_cycle_pct": 37},
        "1": {"hbm_used_bytes": 0, "hbm_total_bytes": 85520809984}}
    assert native["sysfs_status"] == "ok"
    assert "time.sleep" in native["procs"][str(pid)]["cmd"]
    card = probe.parse_probe_output(json.dumps(native)).chips[1]
    # the driver's counters over the drop file, per field: utilization
    # from the drop file, which the driver does not report for this card
    assert (card.hbm_used_bytes, card.duty_cycle_pct,
            card.metrics_source) == (0, 12.5, "sysfs")


def test_probes_without_nvml_list_the_nodes(fake_host, tmp_path):
    """No NVML: the cards are the nodes in the order of N (nvidiactl and
    nvidia-uvm are none), without counters (the monitor's warning)."""
    native, inline = both_probes({
        "TPUHIVE_DEV_DIR": str(fake_host["dev"]),
        "TPUHIVE_NVML_LIB": str(tmp_path / "no-such-lib.so"),
        "TPUHIVE_METRICS_DIR": str(tmp_path / "none")})
    assert comparable(native) == comparable(inline)
    dev = fake_host["dev"]
    assert [(c["index"], c["dev"], c["pids"]) for c in native["chips"]] == [
        (0, str(dev / "nvidia0"), []), (1, str(dev / "nvidia1"), []),
        (2, str(dev / "nvidia10"), [fake_host["pid"]])]
    assert native["sysfs_metrics"] == {}
    assert native["sysfs_status"] == "absent"
    sample = probe.parse_probe_output(json.dumps(native))
    assert [w["key"] for w in host_warnings("h", sample)] == [
        "driver_counters_absent"]


def test_probes_without_cards(tmp_path):
    """No card node and no NVML: no chips and no /proc scan."""
    native, inline = both_probes({
        "TPUHIVE_DEV_DIR": str(tmp_path),
        "TPUHIVE_NVML_LIB": str(tmp_path / "no-such-lib.so"),
        "TPUHIVE_METRICS_DIR": str(tmp_path / "none")})
    for doc in (native, inline):
        assert doc["chips"] == [] and doc["sysfs_metrics"] == {}
        assert doc["sysfs_status"] == "absent" and doc["restricted"] == 0
        assert doc["cpu"]["ncpu"] >= 1 and doc["mem"]["total_kb"] > 0
    sample = probe.parse_probe_output(json.dumps(native))
    assert host_warnings("h", sample) == []


# -- templates ------------------------------------------------------------------

def placements(module, chips_each):
    return [module.Placement(hostname=f"vm-{i // 2}", chips=chips)
            for i, chips in enumerate(chips_each)]


def renamed(env):
    return {("CUDA_VISIBLE_DEVICES" if key == "TPU_VISIBLE_CHIPS" else key):
            value for key, value in env.items() if key != "PJRT_DEVICE"}


@pytest.mark.parametrize("ours,theirs,options", [
    ("plain", "plain", {}),
    ("tf-config", "tf-config", {"base_port": 3000}),
    ("tf-cluster", "tf-cluster", {"num_ps": 1}),
    ("torchrun", "torch-xla", {"master_port": 29500}),
])
def test_templates_match_jax(ours, theirs, options):
    chips_each = [[0], [1, 2], None, [3]]
    got = templates.render_template(ours, "python train.py",
                                    placements(templates, chips_each),
                                    options)
    want = jax_templates.render_template(
        theirs, "python train.py", placements(jax_templates, chips_each),
        options)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert (a.hostname, a.command, a.params) == \
            (b.hostname, b.command, b.params)
        assert a.env == renamed(b.env)
    assert "PJRT_DEVICE" not in got[0].env
    assert got[1].env.get("CUDA_VISIBLE_DEVICES") == "1,2"
    assert "CUDA_VISIBLE_DEVICES" not in got[2].env


def test_template_registry_and_refusals():
    assert templates.template_names() == ["plain", "tf-cluster", "tf-config",
                                          "torchrun"]
    for call in (lambda: templates.render_template("jax", "c", placements(
                     templates, [[0]])),
                 lambda: templates.render_template("plain", "c", []),
                 lambda: templates.render_template(
                     "tf-cluster", "c", placements(templates, [[0]]),
                     {"num_ps": 1})):
        with pytest.raises(templates.ValidationError):
            call()


def test_torchrun_env_binds_one_card():
    spec = templates.render_template("torchrun", "python3 -c pass", [
        templates.Placement("vm-0", chips=[0])])[0]
    assert spec.env == {"MASTER_ADDR": "vm-0", "MASTER_PORT": "12355",
                        "NODE_RANK": "0", "WORLD_SIZE": "1",
                        "CUDA_VISIBLE_DEVICES": "0"}
    proc = subprocess.run(
        [sys.executable, "-c", "import os; print(os.environ["
         "'CUDA_VISIBLE_DEVICES'], os.environ['WORLD_SIZE'])"],
        env=dict(os.environ, **spec.env), capture_output=True, text=True,
        timeout=60)
    assert proc.stdout.split() == ["0", "1"]
