"""The port's serving mesh against the JAX package's.

In process: ``serving_rules``, ``best_mesh_shape`` and the cache specs
equal JAX's over a grid of shapes; each rank's ``shard_serving_params``
slice equals, byte for byte, the shard JAX's ``tree_shardings`` puts on the
device at (dp_rank, tp_rank) of its ``serving_mesh`` (the suite's 8-device
CPU platform, tests/conftest.py); the divisibility errors; and
``serving_mesh`` refusing a missing or wrong-size process group.

Spawned groups: one process per rank on the CPU over gloo, one
``FileStore`` per group under the test's ``tmp_path``, every process
joined under ``JOIN_TIMEOUT_S`` (a hung collective fails the test). The
ranks (``tests/torch_mesh_ranks.py``, no JAX) run the ``tiny`` preset with
JAX-made f32 weights through a list of jobs per group while the parent
runs JAX's meshed ``SlotEngine`` on the same schedule — more requests than
slots, so slots and pages are reused — and ``decode.generate`` runs each
request alone:

* (dp, tp) in {(2, 1), (1, 2), (2, 2)}, f32 pages: tokens, outcomes, every
  page-table row and ``kvPagesFree`` after every step identical to JAX's,
  tokens identical to ``decode.generate``; int8 pages: tokens, tables and
  free pages identical, rank 0's pages within one quantization step of
  JAX's at its heads (JAX's and PyTorch's matmuls sum in different orders,
  and the partial sums of tp differ again; ROADMAP C) and scales within
  1e-5 relative;
* the GQA guard at tp 4 over 2 KV heads, whole-prompt and chunked;
* the contiguous layout at 2 x 2; prefix hits with chunked prefill at 1 x 2;
* ``build_engine`` at dp 2: capacity and pages equal JAX's ``build_engine``,
  ``stats()`` and the ``tpuhive_generate_mesh_devices`` gauge;
* the daemon on rank 0: a worker's fault surfaces as a fatal fault, the
  supervisor's rebuild reaches the worker, the rebuilt engine serves the
  single engine's tokens; at tp 2 a worker that raises inside a body fails
  rank 0 at once.
"""
import dataclasses
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorhive_tpu.models.transformer import PRESETS as JAX_PRESETS
from tensorhive_tpu.models.transformer import TransformerLM as JaxLM
from tensorhive_tpu.parallel import mesh as jax_mesh
from tensorhive_tpu.serving.engine import SlotEngine as JaxSlotEngine
from tensorhive_tpu_torch.config import Config, GenerationConfig
from tensorhive_tpu_torch.convert import params_from_jax
from tensorhive_tpu_torch.core.services.generation import (
    GenerationService,
    build_engine,
)
from tensorhive_tpu_torch.models import decode as port_decode
from tensorhive_tpu_torch.parallel import mesh as port_mesh
from tensorhive_tpu_torch.serving.engine import SlotEngine
from tests import torch_mesh_ranks as ranks

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device CPU platform")

#: a spawned group's whole run, joins included
JOIN_TIMEOUT_S = 120
ENGINE = dict(slots=4, max_len=96, queue_depth=8, page_size=16)
JOBS = {
    "f32": dict(kv_quant="off", prefix_cache="off"),
    "int8": dict(kv_quant="on", prefix_cache="off"),
    "prefix": dict(kv_quant="off", prefix_cache="on", prefill_chunk_tokens=8,
                   prefix_min_tokens=16),
    "contiguous": dict(paged=False),
}


def jax_config(kv_heads=None):
    return dataclasses.replace(
        JAX_PRESETS["tiny"], dtype=jnp.float32, use_flash=False, remat=False,
        max_seq_len=128, n_kv_heads=kv_heads)


@pytest.fixture(scope="module")
def jax_params():
    return {kv: JaxLM.init(jax.random.PRNGKey(0), jax_config(kv))
            for kv in (None, 2)}


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def schedule_job(name, dp, tp, kv_heads=None):
    return {"name": f"{name}_{dp}x{tp}", "kind": "schedule", "dp": dp,
            "tp": tp, "kv_heads": kv_heads, "engine": {**ENGINE, **JOBS[name]},
            "schedule": (ranks.PREFIX_SCHEDULE if name == "prefix"
                         else ranks.SCHEDULE)}


class Group:
    """A spawned group of ``world`` ranks running ``jobs`` (each on the
    mesh it names). ``outcomes()`` waits for it once — every rank joined
    under ``JOIN_TIMEOUT_S`` — and returns rank 0's outcome per job name
    and every rank's exit code."""

    def __init__(self, tmp_path, world, jobs, trees):
        context = torch.multiprocessing.get_context("spawn")
        self.jobs = jobs
        self.results = context.Queue()
        self.started = time.monotonic()
        # the weights go by file: arguments past the spawn pipe's buffer
        # would make each start() wait for its child's imports
        weights = tmp_path / "weights.pkl"
        weights.write_bytes(pickle.dumps(trees))
        self.processes = [
            context.Process(target=ranks.rank_main, args=(
                rank, world, str(tmp_path / "store"), str(weights), jobs,
                self.results))
            for rank in range(world)]
        for process in self.processes:
            process.start()
        self._collected = None

    def outcomes(self):
        if self._collected is None:
            self._collected = self._collect()
        return self._collected

    def _collect(self):
        deadline = self.started + JOIN_TIMEOUT_S
        outcomes = {}
        try:
            while len(outcomes) < len(self.jobs):
                name, outcome = self.results.get(
                    timeout=max(1.0, deadline - time.monotonic()))
                assert name != "error", outcome
                outcomes[name] = outcome
            for process in self.processes:
                process.join(timeout=max(1.0, deadline - time.monotonic()))
            assert not any(p.is_alive() for p in self.processes), \
                "a rank did not finish inside the join timeout"
        finally:
            for process in self.processes:
                if process.is_alive():
                    process.kill()
                    process.join(5)
        return outcomes, [p.exitcode for p in self.processes]


@pytest.fixture(scope="module", autouse=True)
def groups(tmp_path_factory, jax_params):
    """The two spawned groups, started with the module so their ranks run
    beside the JAX work of the tests. Two ranks: dp 2 and tp 2 schedules,
    prefix hits at 1 x 2, build_engine at dp 2, the daemon at dp 2 (its
    shutdown stops the workers). Four ranks: 2 x 2 schedules and the
    contiguous layout, the GQA guard at 1 x 4, then a worker's failure at
    2 x 2, which ends the group."""
    trees = {kv: numpy_tree(params) for kv, params in jax_params.items()}
    two = [schedule_job(name, dp, tp)
           for dp, tp, names in ((2, 1, ("f32", "int8")),
                                 (1, 2, ("f32", "int8", "prefix")))
           for name in names]
    two += [{"name": "build", "kind": "build_engine", "dp": 2, "tp": 1,
             "generation": dict(slots=2, max_len=48)},
            {"name": "service", "kind": "service", "dp": 2, "tp": 1,
             "worker_fault": 2,
             "config_dir": str(tmp_path_factory.mktemp("confdir"))}]
    four = [schedule_job(name, 2, 2)
            for name in ("f32", "int8", "contiguous")]
    four += [schedule_job(name, 1, 4, kv_heads=2)
             for name in ("f32", "prefix")]
    four += [{"name": "fault", "kind": "fault", "dp": 2, "tp": 2,
              "worker_fault": 1, "engine": {**ENGINE, **JOBS["f32"]}}]
    started = {2: Group(tmp_path_factory.mktemp("two"), 2, two, trees),
               4: Group(tmp_path_factory.mktemp("four"), 4, four, trees)}
    yield started
    for group in started.values():
        group.outcomes()


def jax_schedule(params, config, dp, tp, name):
    engine = JaxSlotEngine(params, config,
                           mesh=jax_mesh.serving_mesh(dp=dp, tp=tp),
                           **ENGINE, **JOBS[name])
    schedule = ranks.PREFIX_SCHEDULE if name == "prefix" else ranks.SCHEDULE
    results, trace = ranks.run_schedule(engine, schedule)
    return engine, results, trace


def generate_tokens(params, kv_heads, schedule):
    """The port's ``decode.generate`` (held to JAX's in
    test_torch_decode.py), greedy, one request at a time."""
    config = ranks.tiny_config(kv_heads)
    params = params_from_jax(numpy_tree(params), config, device="cpu")
    return [port_decode.generate(params, config, [prompt], new,
                                 device="cpu")[0, len(prompt):].tolist()
            for prompt, new, _ in schedule]


def check_schedule(outcome, engine, results, trace, dp, tp, name,
                   reference=None):
    """Rank 0's run of one job against JAX's meshed engine."""
    assert outcome["results"] == results
    assert [o for o, _ in results] == ["completed"] * len(results)
    if reference is not None:
        assert [tokens for _, tokens in results] == reference
    if name == "contiguous":
        return
    assert outcome["trace"] == trace
    stats = outcome["stats"]
    assert stats["meshShape"] == f"{dp}x{tp}"
    assert stats["numDevices"] == dp * tp
    assert stats["kvPagesFree"] + (stats["cachedPages"] or 0) == \
        stats["kvPagesTotal"] == engine._pool.num_pages
    if name != "int8":
        return
    heads = outcome["cache"]["k"].shape[3]
    for key in ("k", "v"):
        ours = outcome["cache"][key][:, dp:].astype(np.int32)
        theirs = np.asarray(getattr(engine._cache, key))[:, dp:, :, :heads]
        assert np.abs(ours - theirs.astype(np.int32)).max() <= 1
    for key in ("k_scale", "v_scale"):
        np.testing.assert_allclose(
            outcome["cache"][key][:, dp:],
            np.asarray(getattr(engine._cache, key))[:, dp:, :heads],
            rtol=1e-5, atol=0)


# -- rules, specs, shards ---------------------------------------------------

@pytest.mark.parametrize("tp", [1, 2, 3, 4, 8])
def test_serving_rules_and_specs_match_jax(tp):
    for heads in (4, 8, 12, 32):
        for kv_heads in (1, 2, 4, 8):
            if heads % kv_heads:
                continue
            for d_ff in (176, 100, 11008):
                for vocab in (512, 1000, 32000):
                    config = type("Shape", (), {
                        "n_heads": heads, "kv_heads": kv_heads,
                        "d_ff": d_ff, "vocab_size": vocab})()
                    ours = port_mesh.serving_rules(config, tp)
                    theirs = jax_mesh.serving_rules(config, tp)
                    assert dataclasses.asdict(ours) == \
                        dataclasses.asdict(theirs)
                    assert port_mesh.serving_cache_spec(ours) == tuple(
                        jax_mesh.serving_cache_spec(theirs))
                    assert port_mesh.serving_scale_spec(ours) == tuple(
                        jax_mesh.serving_scale_spec(theirs))
                    assert ours.spec("embed", "heads") == tuple(
                        theirs.spec("embed", "heads"))


def test_best_mesh_shape_matches_jax():
    for n in (1, 2, 3, 4, 6, 8, 12, 16, 32, 64):
        for seq_parallel in (False, True):
            for kv_heads in (None, 1, 2, 3, 8):
                assert port_mesh.best_mesh_shape(
                    n, seq_parallel=seq_parallel, kv_heads=kv_heads) == \
                    jax_mesh.best_mesh_shape(
                        n, seq_parallel=seq_parallel, kv_heads=kv_heads)


@pytest.mark.parametrize("dp,tp,kv_heads", [
    (2, 1, None), (1, 2, None), (2, 2, None), (2, 4, None), (1, 4, 2)])
def test_param_shards_equal_jax_shards_bytewise(dp, tp, kv_heads,
                                                jax_params):
    """Rank r's shard equals JAX's shard on the device at (r // tp,
    r % tp) of its serving mesh, leaf for leaf, byte for byte (the GQA
    guard's K/V whole on every rank)."""
    config = jax_config(kv_heads)
    params = jax_params[kv_heads]
    mesh = jax_mesh.serving_mesh(dp=dp, tp=tp)
    rules = jax_mesh.serving_rules(config, tp)
    placed = jax.device_put(params,
                            jax_mesh.tree_shardings(mesh, params, rules))
    full = params_from_jax(numpy_tree(params), ranks.tiny_config(kv_heads),
                           device="cpu")
    port_rules = port_mesh.serving_rules(ranks.tiny_config(kv_heads), tp)
    jax_leaves = jax.tree_util.tree_leaves_with_path(placed)
    for rank in range(dp * tp):
        device = mesh.devices[0, rank // tp, 0, rank % tp, 0]
        shard = port_mesh.shard_serving_params(full, port_rules, rank % tp,
                                               tp)
        ours = dict(jax.tree_util.tree_leaves_with_path(shard))
        assert len(ours) == len(jax_leaves)
        for path, leaf in jax_leaves:
            data = next(s.data for s in leaf.addressable_shards
                        if s.device == device)
            theirs = np.asarray(data)
            mine = ours[path].numpy()
            assert mine.shape == theirs.shape, path
            assert mine.tobytes() == theirs.tobytes(), path


def test_divisibility_errors(jax_params):
    """The pool's dp divisibility, refused as JAX refuses it — before any
    collective, so a mesh object without a process group suffices."""
    mesh = port_mesh.ServingMesh(dp=2, tp=1, rank=0,
                                 device=torch.device("cpu"), backend="gloo",
                                 tp_group=None)
    params = params_from_jax(numpy_tree(jax_params[None]),
                             ranks.tiny_config(), device="cpu")
    jax_config_ = jax_config()
    for knobs in (dict(slots=3, paged=False), dict(slots=4, kv_pages=7)):
        with pytest.raises(ValueError, match="divisible by mesh") as info:
            SlotEngine(params, ranks.tiny_config(), mesh=mesh, device="cpu",
                       max_len=96, **knobs)
        with pytest.raises(ValueError, match="divisible by mesh") as jax_info:
            JaxSlotEngine(jax_params[None], jax_config_, max_len=96,
                          mesh=jax_mesh.serving_mesh(dp=2, tp=1), **knobs)
        assert str(info.value) == str(jax_info.value)


def test_serving_mesh_refuses_missing_or_wrong_size_group(tmp_path):
    """A mesh config never falls back to fewer ranks: no process group,
    or one of another size, is refused — by ``serving_mesh``,
    ``build_engine`` and the daemon alike."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="none is initialised"):
        port_mesh.serving_mesh(1, 2, device="cpu")
    with pytest.raises(ValueError, match="none is initialised"):
        build_engine(GenerationConfig(max_len=64, mesh_dp=2), device="cpu")
    config = Config(config_dir=tmp_path)
    config.generation = GenerationConfig(max_len=64, mesh_tp=2)
    with pytest.raises(ValueError, match="none is initialised"):
        GenerationService(config, device="cpu")
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1)
    try:
        with pytest.raises(ValueError, match="needs 2 ranks, the process "
                                             "group has 1"):
            port_mesh.serving_mesh(2, 1, device="cpu")
        with pytest.raises(ValueError, match="needs 4 ranks"):
            build_engine(GenerationConfig(max_len=64, mesh_dp=2, mesh_tp=2),
                         device="cpu")
        with pytest.raises(ValueError, match=">= 1"):
            port_mesh.serving_mesh(0, 1, device="cpu")
    finally:
        torch.distributed.destroy_process_group()


# -- spawned groups -----------------------------------------------------------

@pytest.fixture(scope="module")
def references(jax_params):
    """decode.generate's greedy tokens per schedule, MHA and GQA."""
    return {(kv, name): generate_tokens(jax_params[kv], kv, schedule)
            for kv in (None, 2)
            for name, schedule in (("schedule", ranks.SCHEDULE),
                                   ("prefix", ranks.PREFIX_SCHEDULE))}


@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2), (2, 2)])
def test_meshed_engine_matches_jax_mesh(dp, tp, groups, jax_params,
                                        references):
    """f32 and int8 pages at each shape, the contiguous layout at 2 x 2 and
    prefix hits with chunked prefill at 1 x 2."""
    names = ["f32", "int8"] + {(2, 2): ["contiguous"], (1, 2): ["prefix"]
                               }.get((dp, tp), [])
    expected = {name: jax_schedule(jax_params[None], jax_config(), dp, tp,
                                   name) for name in names}
    outcomes, _ = groups[dp * tp].outcomes()
    for name in names:
        reference = None
        if name in ("f32", "contiguous"):
            reference = references[(None, "schedule")]
        elif name == "prefix":
            reference = references[(None, "prefix")]
        check_schedule(outcomes[f"{name}_{dp}x{tp}"], *expected[name], dp,
                       tp, name, reference)
    if "prefix" in names:
        stats = outcomes[f"prefix_{dp}x{tp}"]["stats"]
        jax_stats = expected["prefix"][0].stats()
        assert stats["prefixHits"] == jax_stats["prefixHits"] == 3
        assert stats["prefixMisses"] == jax_stats["prefixMisses"]
    for name in ("f32", "int8"):
        assert outcomes[f"{name}_{dp}x{tp}"]["shard_heads"] == (tp > 1)


def test_gqa_guard_matches_jax(groups, jax_params, references):
    """tp 4 over 2 KV heads: K/V and the cache whole on every rank, the
    attention on all heads; whole-prompt and chunked prefill."""
    outcomes, _ = groups[4].outcomes()
    for name in ("f32", "prefix"):
        outcome = outcomes[f"{name}_1x4"]
        check_schedule(outcome, *jax_schedule(jax_params[2], jax_config(2),
                                              1, 4, name), 1, 4, name,
                       references[(2, "schedule" if name == "f32"
                                   else "prefix")])
        assert outcome["rules_kv_heads"] is None
        assert outcome["shard_heads"] is False
        assert outcome["cache"]["k"].shape[3] == 2


def test_build_engine_and_daemon_at_dp2(groups, config):
    """``build_engine`` at dp 2 holds JAX's capacity and page pool; stats
    and the gauge say 2x1. Then the daemon on rank 0: the worker's second
    step fails, the supervisor fails fast, releases, and its rebuild's
    BUILD reaches the worker; the rebuilt engine serves the single
    engine's tokens, and the daemon's shutdown stops the worker."""
    from tensorhive_tpu.core.services.generation import build_engine as \
        jax_build_engine

    config.generation.enabled = True
    config.generation.slots = 2
    config.generation.max_len = 48
    config.generation.use_flash = False
    config.generation.mesh_dp = 2
    jax_engine = jax_build_engine(config)
    single = build_engine(GenerationConfig(preset="tiny", max_len=64),
                          device="cpu")
    handle = single.submit([5, 6, 7], max_new_tokens=6)
    single.pump()
    single_tokens = handle.result()["tokens"]
    outcomes, exit_codes = groups[2].outcomes()
    assert exit_codes == [0, 0]
    build = outcomes["build"]
    assert build["capacity"] == jax_engine.capacity == 4
    assert build["stats"]["kvPagesTotal"] == jax_engine._pool.num_pages
    assert build["stats"]["meshShape"] == "2x1"
    assert build["stats"]["numDevices"] == 2 and build["gauge"] == 2.0
    assert [o for o, _ in build["results"]] == ["completed"] * 3
    service = outcomes["service"]
    assert "MeshWorkerError" in service["failed_error"]
    assert service["rebuilt"] and service["restarts"] == 1
    assert service["tokens"] == single_tokens
    assert service["stats"]["meshShape"] == "2x1"


def test_worker_failure_inside_a_tp_body_fails_rank0(groups):
    """At 2 x 2 a worker that raises inside a body leaves (its collectives
    are out of step): rank 0 gets MeshWorkerError at once, not after the
    group's timeout, and the mesh refuses further use."""
    outcomes, exit_codes = groups[4].outcomes()
    fault = outcomes["fault"]
    assert fault["error"] is not None and "MeshWorkerError" in fault["error"]
    assert fault["seconds"] < 30 and fault["broken"]
    assert exit_codes[0] == 0 and exit_codes[1] != 0
