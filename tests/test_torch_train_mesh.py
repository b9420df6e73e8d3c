"""The port's training mesh against the JAX package's sharded training.

In process: ``mesh_sizes`` and the rank layout equal JAX's ``make_mesh``
(rank ``r`` sits where device ``r`` sits), each rank's
``shard_train_params`` block equals, byte for byte, the shard JAX's
``tree_shardings`` puts on that device, the refusals (axes that do not
divide, no process group), and the layout of meshes with sp or pp.

One spawned group of 8 ranks on the CPU over gloo (``FileStore`` under
``tmp_path``; rank code in ``tests/torch_train_ranks.py``, no JAX) runs
every job while the parent runs JAX on the suite's 8 CPU devices
(tests/conftest.py). Weights come from JAX's ``init_train_state`` under the
same mesh, carried across with ``params_from_jax`` and cut with
``shard_train_params``. f32 on both sides; tolerances:

* (i) JAX's ``test_sharded_train_step_runs_and_matches_single_device``
  configs at dp 2 x fsdp 4 and fsdp 2 x tp 4: loss and grad norm within
  1e-5 relative of JAX's mesh step, the gathered params after the step (lr
  0 at the first step) within 1e-5 per element, and Adam's first moment
  (0.1 x the clipped gradient, so each rank's gradient blocks) within
  1e-5 of its largest element per leaf; each rank's ``w_in`` block and
  state bytes exactly its spec's share.
* (ii) accumulation at dp 2 x fsdp 2 x tp 2 against JAX (1e-5) and its
  divisibility errors; (iii) chunked CE on the mesh against unchunked and
  JAX (1e-5); (iv) ``train_loop`` on the mesh, the same metrics on every
  rank, the single device's loss within 1e-4 after two Adam updates (an
  element whose gradient is rounding noise moves by up to a learning rate
  either way), telemetry sampled on rank 0 only; (v) a checkpoint written
  at dp 2 x fsdp 4 restored at dp 2 x fsdp 2 x tp 2 and fsdp 4 x tp 2 into
  ``abstract_train_state`` templates, bitwise, then a step; (vi) the MLM
  step against JAX's ``mlm_loss_packed`` under the same mesh (1e-5);
  (vii) each data rank's ``host_batch_at`` rows through
  ``prefetch_to_device`` against JAX's global step (1e-5), with a tp 2
  case whose tp ranks must read the same rows; (viii) the grad norm at
  fsdp 4 x tp 2 against the single device's (1e-5), where counting the
  tp-replicated norm scales twice would be seen.
"""
import dataclasses
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorhive_tpu import data as jax_data
from tensorhive_tpu import train as jax_train
from tensorhive_tpu.models import encoder as jax_encoder
from tensorhive_tpu.models.transformer import PRESETS as JAX_PRESETS
from tensorhive_tpu.models.transformer import TransformerConfig as JaxConfig
from tensorhive_tpu.models.transformer import TransformerLM as JaxLM
from tensorhive_tpu.parallel import mesh as jax_mesh
from tensorhive_tpu_torch import data, train
from tensorhive_tpu_torch.convert import params_from_jax
from tensorhive_tpu_torch.models.transformer import TransformerLM
from tensorhive_tpu_torch.parallel import mesh as port_mesh
from tests import torch_pp_sp_ranks as pp_sp_ranks
from tests import torch_train_ranks as ranks

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device CPU platform")

WORLD = 8
#: the spawned group's whole run, joins included
JOIN_TIMEOUT_S = 300
TOL = 1e-5

TC1 = dict(batch_size=8, seq_len=64, warmup_steps=1, total_steps=10)
TC_ACCUM = dict(batch_size=8, seq_len=32, warmup_steps=1, total_steps=10,
                grad_accum_steps=2)
TC_DATA = dict(batch_size=8, seq_len=32, warmup_steps=1, total_steps=5)
TC_SMALL = dict(batch_size=8, seq_len=16, warmup_steps=1, total_steps=10)

#: JAX states initialised under a mesh before the ranks start (their
#: weights go to the ranks): name -> (config, mesh axes, train config)
JAX_STATES = {
    "i_dp2_fsdp4": ("c1", dict(dp=2, fsdp=4), TC1),
    "i_fsdp2_tp4": ("c1", dict(fsdp=2, tp=4), TC1),
    "ii_accum": ("c2", dict(dp=2, fsdp=2, tp=2), TC_ACCUM),
    "vi_mlm": ("encoder", dict(dp=2, fsdp=2, tp=2), TC_SMALL),
    "vii_data": ("c2", dict(dp=2, fsdp=4), TC_DATA),
}
SHAPES = {"i_dp2_fsdp4": (2, 4, 1), "i_fsdp2_tp4": (1, 2, 4)}


def jax_config(name, **knobs):
    if name in ranks.CONFIGS:
        base = JaxConfig(**ranks.CONFIGS[name])
    elif name == "encoder":
        base = jax_encoder.ENCODER_PRESETS["tiny"]
    else:
        base = JAX_PRESETS[name]
    return dataclasses.replace(base, dtype=jnp.float32, use_flash=False,
                               remat=False, **knobs)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_mu(opt_state):
    """Adam's first moment in optax's chain state."""
    return next(node.mu for node in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda n: hasattr(n, "mu")) if hasattr(node, "mu"))


def mlm_batch(seed=3):
    """A packed [8, 3, 16] MLM batch of the tiny encoder, from numpy."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 511, (8, 16), dtype=np.int32)
    mask = rng.random((8, 16)) < 0.3
    inputs = np.where(mask, 511, tokens).astype(np.int32)
    return np.stack([inputs, tokens, mask.astype(np.int32)], axis=1)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX states, the inputs every job reads, and the spawned group,
    started with the module so its ranks run beside the JAX work."""
    states = {}
    for name, (config, axes, tc) in JAX_STATES.items():
        mesh = jax_mesh.make_mesh(**axes)
        params, opt = jax_train.init_train_state(
            jax.random.PRNGKey(0), jax_config(config), jax_train.TrainConfig(
                **tc), mesh)
        states[name] = (mesh, params, opt)
    shards = tmp_path_factory.mktemp("shards")
    pattern = data.fake_shards(shards, num_shards=2, tokens_per_shard=2048,
                               vocab_size=128)
    rng = np.random.default_rng(11)
    inputs = {name: numpy_tree(params)
              for name, (_, params, _) in states.items()}
    inputs.update(
        c1_tokens=np.asarray(jax_train.synthetic_batch(
            jax.random.PRNGKey(7), jax_train.TrainConfig(**TC1), 128)),
        c2_tokens=rng.integers(0, 128, (8, 33), dtype=np.int32),
        tiny_tokens=rng.integers(0, 512, (8, 17), dtype=np.int32),
        mlm=mlm_batch())
    ckpt = tmp_path_factory.mktemp("ckpt") / "run"
    jobs = [
        {"name": name, "kind": "step", "mesh": SHAPES[name], "config": "c1",
         "train": TC1, "weights": name, "tokens": "c1_tokens"}
        for name in SHAPES]
    jobs += [
        {"name": "iii_chunked", "kind": "step", "mesh": (2, 4, 1),
         "config": "c1", "knobs": dict(loss_chunk_tokens=64), "chunk": True,
         "train": TC1, "weights": "i_dp2_fsdp4", "tokens": "c1_tokens"},
        {"name": "ii_accum", "kind": "step", "mesh": (2, 2, 2),
         "config": "c2", "train": TC_ACCUM, "weights": "ii_accum",
         "tokens": "c2_tokens"},
        {"name": "iv_loop", "kind": "loop", "mesh": (2, 2, 2), "config": "c2",
         "train": TC_DATA, "steps": 3},
        {"name": "v_checkpoint", "kind": "checkpoint", "config": "tiny",
         "train": dict(TC_SMALL, learning_rate=1e-2), "save": (2, 4, 1),
         "restore": [(2, 2, 2), (1, 4, 2)], "tokens": "tiny_tokens",
         "path": str(ckpt)},
        {"name": "vi_mlm", "kind": "step", "mesh": (2, 2, 2),
         "config": "encoder", "loss": "mlm", "train": TC_SMALL,
         "weights": "vi_mlm", "tokens": "mlm"},
        {"name": "vii_data_dp2_fsdp4", "kind": "data", "mesh": (2, 4, 1),
         "config": "c2", "train": TC_DATA, "weights": "vii_data",
         "pattern": pattern},
        {"name": "vii_data_tp2", "kind": "data", "mesh": (2, 2, 2),
         "config": "c2", "train": TC_DATA, "weights": "vii_data",
         "pattern": pattern},
        {"name": "viii_norm", "kind": "step", "mesh": (1, 4, 2),
         "config": "c1", "train": TC1, "weights": "i_dp2_fsdp4",
         "tokens": "c1_tokens"},
    ]
    group = Group(tmp_path_factory.mktemp("group"), jobs, inputs)
    yield {"states": states, "inputs": inputs, "pattern": pattern,
           "group": group, "results": {}}
    group.outcomes()


class Group:
    """The spawned ranks. ``outcomes()`` waits for them once (every rank
    joined under ``JOIN_TIMEOUT_S``) and returns {job name: {rank:
    outcome}}."""

    def __init__(self, tmp_path, jobs, inputs):
        context = torch.multiprocessing.get_context("spawn")
        self.jobs = jobs
        self.results = context.Queue()
        self.started = time.monotonic()
        # the inputs go by file: arguments past the spawn pipe's buffer
        # would make each start() wait for its child's imports
        path = tmp_path / "inputs.pkl"
        path.write_bytes(pickle.dumps(inputs))
        self.processes = [
            context.Process(target=ranks.rank_main, args=(
                rank, WORLD, str(tmp_path / "store"), str(path), jobs,
                self.results))
            for rank in range(WORLD)]
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
            for _ in range(len(self.jobs) * WORLD):
                name, rank, outcome = self.results.get(
                    timeout=max(1.0, deadline - time.monotonic()))
                assert name != "error", f"rank {rank}:\n{outcome}"
                outcomes.setdefault(name, {})[rank] = outcome
            for process in self.processes:
                process.join(timeout=max(1.0, deadline - time.monotonic()))
            assert not any(p.is_alive() for p in self.processes), \
                "a rank did not finish inside the join timeout"
            assert all(p.exitcode == 0 for p in self.processes)
        finally:
            for process in self.processes:
                if process.is_alive():
                    process.kill()
                    process.join(5)
        return outcomes


def jax_step(world, name, loss_fn=None, tokens=None):
    """One JAX mesh step of a state made in the fixture (once per name:
    the step donates its buffers): metrics, params and mu as numpy."""
    cache = world["results"]
    if name not in cache:
        config, _, tc = JAX_STATES[name]
        mesh, params, opt = world["states"][name]
        kwargs = {} if loss_fn is None else {"loss_fn": loss_fn}
        step = jax_train.make_train_step(jax_config(config),
                                         jax_train.TrainConfig(**tc), mesh,
                                         **kwargs)
        params, opt, metrics = step(params, opt, jnp.asarray(tokens))
        cache[name] = ({key: float(value) for key, value in metrics.items()},
                       numpy_tree(params), numpy_tree(jax_mu(opt)))
    return cache[name]


def job(world, name):
    return world["group"].outcomes()[name]


def leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def assert_metrics(got, want, keys=("loss", "grad_norm")):
    for key in keys:
        np.testing.assert_allclose(got[key], want[key], rtol=TOL, atol=0,
                                   err_msg=key)


def assert_same_on_every_rank(outcome):
    first = outcome[0]["metrics"]
    assert all(outcome[rank]["metrics"] == first for rank in outcome)


def assert_state_matches(ours, want_params, want_mu):
    """Whole params per element (1e-5), and Adam's mu per leaf within 1e-5
    of the leaf's largest element."""
    for got, want in zip(leaves(ours["params"]), leaves(want_params)):
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    for got, want in zip(leaves(ours["mu"]), leaves(want_mu)):
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= TOL * scale


# -- in process ----------------------------------------------------------------

MESHES = [dict(dp=2, fsdp=4), dict(fsdp=2, tp=4), dict(dp=2, fsdp=2, tp=2),
          dict(fsdp=4, tp=2), dict(dp=8), dict(fsdp=-1, tp=2),
          dict(dp=2, fsdp=-1)]


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: "_".join(
    f"{k}{v}" for k, v in a.items()))
def test_layout_and_shards_match_jax(axes):
    """mesh_sizes = make_mesh's shape; rank r sits where device r sits;
    each rank's blocks are JAX's shards on that device, byte for byte."""
    mesh = jax_mesh.make_mesh(**axes)
    sizes = port_mesh.mesh_sizes(WORLD, **axes)
    assert sizes == dict(mesh.shape)
    config = jax_config("c1")
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda k: JaxLM.init(k, config), key)
    params = jax.jit(lambda k: JaxLM.init(k, config),
                     out_shardings=jax_mesh.tree_shardings(mesh, shapes))(key)
    whole = params_from_jax(numpy_tree(params), ranks.model_config("c1"),
                            "cpu", param_dtype=torch.float32)
    positions = {device.id: index for index, device in
                 np.ndenumerate(mesh.devices)}
    for rank, device in enumerate(jax.devices()):
        ours = port_mesh.TrainMesh(sizes["dp"], sizes["fsdp"], sizes["tp"],
                                   rank=rank)
        position = dict(zip(mesh.axis_names, positions[device.id]))
        assert ours.coords == {axis: position[axis]
                               for axis in ("dp", "fsdp", "tp")}
        shard = port_mesh.shard_train_params(whole, port_mesh.DEFAULT_RULES,
                                             ours)
        for got, want in zip(train.tree_leaves(shard), leaves(params)):
            theirs = next(s.data for s in want.addressable_shards
                          if s.device == device)
            assert np.array_equal(got.numpy(), np.asarray(theirs))


def test_refusals(monkeypatch):
    """sp and pp build meshes with JAX's layout (rank r where make_mesh
    puts device r); no process group, a size that is not the group's, and
    axes that do not divide are refused."""
    for axes in (dict(fsdp=-1, sp=2), dict(fsdp=-1, pp=2)):
        layout = jax_mesh.make_mesh(**axes)
        where = {device.id: dict(zip(layout.axis_names, index))
                 for index, device in np.ndenumerate(layout.devices)}
        with monkeypatch.context() as patch:
            for rank, device in enumerate(jax.devices()):
                mesh, _ = pp_sp_ranks.built_mesh(patch, rank, WORLD, **axes)
                assert mesh.position == where[device.id], (axes, rank)
    with pytest.raises(ValueError, match="initialised"):
        port_mesh.train_mesh(fsdp=2, device="cpu")
    with pytest.raises(ValueError, match="needs 8 ranks"):
        port_mesh.mesh_sizes(4, dp=2, fsdp=4)
    with pytest.raises(ValueError, match="at most one"):
        port_mesh.mesh_sizes(8, dp=-1, fsdp=-1)
    config = ranks.model_config("c2")
    tc = train.TrainConfig(**TC_ACCUM)
    cases = [((1, 1, 4), "n_heads"), ((1, 1, 3), "n_heads"),
             ((1, 3, 1), "d_model"), ((8, 1, 1), "batch_size"),
             ((1, 2, 2), None)]
    for (dp, fsdp, tp), what in cases:
        mesh = port_mesh.TrainMesh(dp, fsdp, tp)
        if what is None:
            train.make_train_step(config, tc, mesh)
            continue
        with pytest.raises(ValueError, match=what):
            train.make_train_step(config, tc, mesh)
    gqa = dataclasses.replace(ranks.model_config("tiny"), n_kv_heads=2)
    with pytest.raises(ValueError, match="kv_heads"):
        train.init_train_state(gqa, tc, mesh=port_mesh.TrainMesh(1, 1, 4))
    with pytest.raises(ValueError, match="wq axis 1"):
        port_mesh.shard_train_leaf(torch.zeros(4, 6), "wq",
                                   port_mesh.TrainMesh(1, 1, 4))


# -- the spawned group ---------------------------------------------------------

@pytest.mark.parametrize("name", list(SHAPES))
def test_sharded_step_matches_jax(world, name):
    """(i) one step on the mesh against JAX's mesh step."""
    metrics, params, mu = jax_step(world, name,
                                   tokens=world["inputs"]["c1_tokens"])
    outcome = job(world, name)
    assert_same_on_every_rank(outcome)
    assert_metrics(outcome[0]["metrics"][0], metrics)
    assert_state_matches(outcome[0]["whole"], params, mu)
    dp, fsdp, tp = SHAPES[name]
    for rank in outcome:
        assert outcome[rank]["apply_err"] <= TOL
        assert outcome[rank]["w_in"] == (64 // fsdp, 128 // tp)
        assert outcome[rank]["held"] == outcome[rank]["expected"]
    assert outcome[0]["w_in"][0] * outcome[0]["w_in"][1] < 64 * 128


def test_grad_accumulation_on_mesh(world):
    """(ii) two microbatches of each rank's two rows at dp 2 x fsdp 2 x
    tp 2 against JAX; the divisibility errors."""
    metrics, params, mu = jax_step(world, "ii_accum",
                                   tokens=world["inputs"]["c2_tokens"])
    outcome = job(world, "ii_accum")
    assert_same_on_every_rank(outcome)
    assert_metrics(outcome[0]["metrics"][0], metrics)
    assert_state_matches(outcome[0]["whole"], params, mu)
    config = ranks.model_config("c2")
    with pytest.raises(ValueError, match="divisible"):
        train.make_train_step(config, train.TrainConfig(
            **dict(TC_ACCUM, grad_accum_steps=3)),
            port_mesh.TrainMesh(2, 2, 2))
    with pytest.raises(ValueError, match="grad_accum_steps"):
        train.make_train_step(config, train.TrainConfig(
            **dict(TC_ACCUM, grad_accum_steps=4)),
            port_mesh.TrainMesh(2, 2, 2))


def test_chunked_ce_on_mesh(world):
    """(iii) the chunked CE (chunks of 64 of each rank's 128 tokens, over
    its vocab columns) against the unchunked mesh step and JAX."""
    metrics, _, _ = jax_step(world, "i_dp2_fsdp4",
                             tokens=world["inputs"]["c1_tokens"])
    chunked = job(world, "iii_chunked")
    whole = job(world, "i_dp2_fsdp4")
    assert_same_on_every_rank(chunked)
    assert_metrics(chunked[0]["metrics"][0], metrics)
    assert_metrics(chunked[0]["metrics"][0], whole[0]["metrics"][0])
    for got, want in zip(leaves(chunked[0]["whole"]["mu"]),
                         leaves(whole[0]["whole"]["mu"])):
        np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max())


def test_train_loop_on_mesh(world):
    """(iv) train_loop at dp 2 x fsdp 2 x tp 2 from a seed: finite, the
    same on every rank, the single device's loop within 1e-4; telemetry
    sampled once per window on rank 0 and nowhere else."""
    outcome = job(world, "iv_loop")
    first = outcome[0]
    assert np.isfinite(first["loss"]) and np.isfinite(first["grad_norm"])
    assert all(outcome[rank]["loss"] == first["loss"]
               and outcome[rank]["grad_norm"] == first["grad_norm"]
               for rank in outcome)
    assert [outcome[rank]["samples"] for rank in sorted(outcome)] == \
        [3] + [0] * (WORLD - 1)
    single = train.train_loop(ranks.model_config("c2"),
                              train.TrainConfig(**TC_DATA), num_steps=3,
                              log_every=0, device="cpu")
    np.testing.assert_allclose(first["loss"], single["loss"], rtol=1e-4)


def test_checkpoint_restores_across_mesh_shapes(world):
    """(v) written at dp 2 x fsdp 4 (one file per owning rank: dp rank 0,
    4 of them), restored bitwise into abstract templates at dp 2 x fsdp 2
    x tp 2 and fsdp 4 x tp 2, each of which then trains; restored into
    whole templates without a mesh, and a single-device file restored on
    the mesh, bitwise too; a seed draws the same global params on any
    mesh."""
    outcome = job(world, "v_checkpoint")[0]
    assert outcome["files"] == [
        f"step_0000000007.ranks/fsdp{f}_tp0_of_4x1.pt" for f in range(4)]
    assert outcome["count"] == 2 and outcome["init_equal"]
    assert outcome["whole_restore"]
    restored_trees = dict(outcome["restored"], single=outcome["from_single"])
    for shape, restored in restored_trees.items():
        for key in ("params", "mu", "nu"):
            for got, want in zip(leaves(restored[key]),
                                 leaves(outcome["saved"][key])):
                assert np.array_equal(got, want), (shape, key)
        assert shape == "single" or np.isfinite(outcome["losses"][shape])


def test_mlm_on_mesh(world):
    """(vi) the MLM step (mask count summed over the data ranks) against
    JAX's mlm_loss_packed under the same mesh."""
    metrics, params, mu = jax_step(world, "vi_mlm",
                                   loss_fn=jax_encoder.mlm_loss_packed,
                                   tokens=world["inputs"]["mlm"])
    outcome = job(world, "vi_mlm")
    assert_same_on_every_rank(outcome)
    assert_metrics(outcome[0]["metrics"][0], metrics)
    assert_state_matches(outcome[0]["whole"], params, mu)


@pytest.mark.parametrize("name", ["vii_data_dp2_fsdp4", "vii_data_tp2"])
def test_host_rows_per_data_rank(world, name):
    """(vii) every rank reads its data shard's rows of batch_at(0) from
    the fake shards; every tp rank of a shard the same rows; the loss is
    JAX's global step's on the same shards."""
    dataset = jax_data.TokenDataset(jax_data.DataConfig(
        pattern=world["pattern"], seq_len=32, batch_size=8, vocab_size=128))
    metrics, _, _ = jax_step(world, "vii_data",
                             tokens=np.asarray(dataset.batch_at(0)))
    outcome = job(world, name)
    for rank in outcome:
        assert outcome[rank]["own_rows"] and outcome[rank]["tp_same_rows"]
        np.testing.assert_allclose(outcome[rank]["loss"], metrics["loss"],
                                   rtol=TOL)


def test_grad_norm_counts_replicated_leaves_once(world):
    """(viii) the grad norm at fsdp 4 x tp 2 against one device's; the
    norm scales (replicated over tp) carry enough of it that counting
    them on both tp ranks would move it past the tolerance."""
    config = ranks.model_config("c1")
    params = params_from_jax(world["inputs"]["i_dp2_fsdp4"], config, "cpu",
                             param_dtype=torch.float32)
    live = train.tree_map(lambda t: t.requires_grad_(), params)
    loss = TransformerLM.loss(live, torch.from_numpy(
        world["inputs"]["c1_tokens"].copy()), config)
    grads = torch.autograd.grad(loss, train.tree_leaves(live))
    names = train.leaf_names(live)
    total = sum(float((g.double() ** 2).sum()) for g in grads)
    scales = sum(float((g.double() ** 2).sum())
                 for g, n in zip(grads, names) if n == "scale")
    doubled = np.sqrt(total + scales)
    assert doubled / np.sqrt(total) - 1 > 10 * TOL
    outcome = job(world, "viii_norm")
    assert_same_on_every_rank(outcome)
    np.testing.assert_allclose(outcome[0]["metrics"][0]["grad_norm"],
                               np.sqrt(total), rtol=TOL)
    np.testing.assert_allclose(outcome[0]["metrics"][0]["loss"],
                               loss.item(), rtol=TOL)
