"""The port's training mesh with sequence and pipeline parallelism against
the JAX package's.

In process: the rank layout of ``train_mesh`` equals JAX's ``make_mesh``
for shapes with sp and pp (rank ``r`` sits where device ``r`` sits, and
each process group holds the ranks that differ along its axis alone, made
through a stand-in for ``torch.distributed``); every sp, tp and pp rank of
a data shard shares its ``data_rank``; the validation errors with JAX's
words (``test_compute.py:902``).

One spawned group of 8 ranks on the CPU over gloo (rank code in
``tests/torch_pp_sp_ranks.py``, no JAX) runs every job while the parent
runs JAX on the suite's 8 CPU devices. Weights come from JAX
(``TransformerLM.init`` or ``init_train_state`` under the same mesh),
carried across with ``params_from_jax`` and cut by the mesh (each rank its
blocks and its stage's layers). f32 on both sides; tolerances:

* (i) pp 2 x dp 2 x fsdp 2 (``:852``): the loss within 1e-5 relative
  and every leaf's gradient within 2e-4 of JAX's unpipelined model, the
  reference JAX's own pipeline tests hold JAX's pipeline to (JAX's
  gradient through its pipeline takes minutes on this CPU, and its
  pipelined loss alone a quarter of this file's time budget);
* (ii) 4 microbatches with "block" remat at pp 2 x fsdp 2 x tp 2
  (``:874``): the same loss (1e-5) and gradients (2e-4);
* (iii) ``train_loop`` at pp 2 x dp 2 x fsdp 2 (``:890``): finite, the same
  on every rank, the single device's loop within 1e-4;
* (iv) pp 2 x sp 2 x fsdp 2 (``:918``): loss (1e-5) and gradients (2e-4)
  against JAX's unpipelined model, ring attention inside the stages;
* (v) the MLM encoder at pp 2 x sp 2 x fsdp 2 (``:1191``): the loss within
  1e-5 of JAX's unsharded ``mlm_loss_packed``, as JAX's test holds its
  mesh to;
* (vi) the LM and MLM steps at sp 2 x fsdp 2 x tp 2: loss and grad norm
  within 1e-5 relative of JAX's mesh step, the params after it within
  1e-5 per element, Adam's first moment within 1e-5 of its largest element
  per leaf (as ``tests/test_torch_train_mesh.py``'s (i));
* (vii) a checkpoint written at pp 2 x sp 2 x fsdp 2 (one file per (pp,
  fsdp) coordinate, each stage's layers under their global indices),
  restored bitwise at dp 2 x fsdp 2 x tp 2 and on one device; each rank
  of either mesh holds exactly its specs' share of params/``mu``/``nu``
  (under pp its stage's layers only).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorhive_tpu import train as jax_train
from tensorhive_tpu.models import encoder as jax_encoder
from tensorhive_tpu.models.transformer import TransformerLM as JaxLM
from tensorhive_tpu.parallel import mesh as jax_mesh
from tensorhive_tpu_torch import train
from tensorhive_tpu_torch.convert import config_from_jax
from tensorhive_tpu_torch.models.transformer import TransformerLM
from tensorhive_tpu_torch.parallel import mesh as port_mesh
from tests import torch_pp_sp_ranks as ranks
from tests import torch_train_ranks
from tests.test_torch_train_mesh import (
    assert_metrics,
    assert_state_matches,
    jax_config,
    jax_mu,
    mlm_batch,
    numpy_tree,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device CPU platform")

WORLD = 8
#: the spawned group's whole run, joins included
JOIN_TIMEOUT_S = 300
TOL = 1e-5
GRAD_TOL = 2e-4

PP_DP_FSDP = dict(pp=2, dp=2, fsdp=2)
PP_SP_FSDP = dict(pp=2, sp=2, fsdp=2)
SP_FSDP_TP = dict(sp=2, fsdp=2, tp=2)
TC_STEP = dict(batch_size=8, seq_len=64, warmup_steps=1, total_steps=10)
TC_MLM = dict(batch_size=8, seq_len=16, warmup_steps=1, total_steps=10)
TC_LOOP = dict(batch_size=8, seq_len=64, warmup_steps=1, total_steps=4)
TC_CKPT = dict(batch_size=8, seq_len=32, warmup_steps=1, total_steps=10,
               learning_rate=1e-2)
#: JAX's pipeline train-loop config (``:890``) in the port's terms
LOOP_KNOBS = dict(vocab_size=256, n_layers=4)


def jobs(ckpt):
    return [
        {"name": "i_pp_dp_fsdp", "kind": "grads", "mesh": PP_DP_FSDP,
         "config": "tiny", "weights": "tiny", "tokens": "tokens"},
        {"name": "ii_microbatches", "kind": "grads",
         "mesh": dict(pp=2, fsdp=2, tp=2), "config": "tiny",
         "knobs": dict(remat=True, pp_microbatches=4), "weights": "tiny",
         "tokens": "tokens"},
        {"name": "iii_loop", "kind": "loop", "mesh": PP_DP_FSDP,
         "config": "c1", "knobs": LOOP_KNOBS, "train": TC_LOOP, "steps": 3},
        {"name": "iv_pp_sp", "kind": "grads", "mesh": PP_SP_FSDP,
         "config": "tiny", "weights": "tiny", "tokens": "tokens"},
        {"name": "v_mlm", "kind": "grads", "mesh": PP_SP_FSDP,
         "config": "encoder", "loss": "mlm", "weights": "encoder",
         "tokens": "mlm_pp"},
        {"name": "vi_lm_step", "kind": "step", "mesh": SP_FSDP_TP,
         "config": "c1", "train": TC_STEP, "weights": "vi_lm",
         "tokens": "c1_tokens"},
        {"name": "vi_mlm_step", "kind": "step", "mesh": SP_FSDP_TP,
         "config": "encoder", "loss": "mlm", "train": TC_MLM,
         "weights": "vi_mlm", "tokens": "mlm"},
        {"name": "vii_checkpoint", "kind": "checkpoint", "config": "tiny",
         "train": TC_CKPT, "save": dict(pp=2, sp=2, fsdp=2),
         "restore": [dict(dp=2, fsdp=2, tp=2)], "tokens": "ckpt_tokens",
         "path": str(ckpt)},
    ]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs every job reads (JAX-made weights, numpy batches) and
    the spawned group, started before the JAX references so its ranks run
    beside them."""
    tiny = jax_config("tiny")
    enc = jax_config("encoder")
    rng = np.random.default_rng(11)
    mesh_step = jax_mesh.make_mesh(**SP_FSDP_TP)
    states = {
        "vi_lm": jax_train.init_train_state(
            jax.random.PRNGKey(0), jax_config("c1"),
            jax_train.TrainConfig(**TC_STEP), mesh_step),
        "vi_mlm": jax_train.init_train_state(
            jax.random.PRNGKey(0), enc, jax_train.TrainConfig(**TC_MLM),
            mesh_step),
    }
    tokens = rng.integers(0, tiny.vocab_size, (8, 65), dtype=np.int32)
    mlm_pp = rng.integers(0, enc.vocab_size - 1, (4, 64), dtype=np.int32)
    mask = rng.random((4, 64)) < 0.3
    inputs = {
        "tiny": numpy_tree(JaxLM.init(jax.random.PRNGKey(0), tiny)),
        "encoder": numpy_tree(JaxLM.init(jax.random.PRNGKey(50), enc)),
        "vi_lm": numpy_tree(states["vi_lm"][0]),
        "vi_mlm": numpy_tree(states["vi_mlm"][0]),
        "tokens": tokens,
        "mlm_pp": np.stack([np.where(mask, enc.vocab_size - 1, mlm_pp),
                            mlm_pp, mask.astype(np.int32)],
                           axis=1).astype(np.int32),
        "mlm": mlm_batch(),
        "c1_tokens": np.asarray(jax_train.synthetic_batch(
            jax.random.PRNGKey(7), jax_train.TrainConfig(**TC_STEP), 128)),
        "ckpt_tokens": rng.integers(0, 512, (8, 33), dtype=np.int32),
    }
    group = ranks.Group(tmp_path_factory.mktemp("group"), WORLD,
                        jobs(tmp_path_factory.mktemp("ckpt") / "run"),
                        inputs, JOIN_TIMEOUT_S)
    # the references, while the ranks run
    plain_loss, plain_grads = jax.jit(jax.value_and_grad(
        lambda p, t: JaxLM.loss(p, t, tiny)))(
            jax.tree_util.tree_map(jnp.asarray, inputs["tiny"]),
            jnp.asarray(tokens))
    refs = {"plain": (float(plain_loss), numpy_tree(plain_grads)),
            "mlm_pp": float(jax.jit(
                lambda p, b: jax_encoder.mlm_loss_packed(p, b, enc))(
                    jax.tree_util.tree_map(jnp.asarray, inputs["encoder"]),
                    jnp.asarray(inputs["mlm_pp"])))}
    for key, config, tc, batch, loss_fn in (
            ("vi_lm", jax_config("c1"), TC_STEP, "c1_tokens", {}),
            ("vi_mlm", enc, TC_MLM, "mlm",
             {"loss_fn": jax_encoder.mlm_loss_packed})):
        step = jax_train.make_train_step(
            config, jax_train.TrainConfig(**tc), mesh_step, **loss_fn)
        params, opt, metrics = step(*states[key], jnp.asarray(inputs[batch]))
        refs[key] = ({k: float(v) for k, v in metrics.items()},
                     numpy_tree(params), numpy_tree(jax_mu(opt)))
    yield {"inputs": inputs, "refs": refs, "group": group}
    group.outcomes()


def job(world, name):
    return world["group"].outcomes()[name]


def jax_plain(world):
    """JAX's unpipelined loss and gradients of the tiny LM on the shared
    tokens."""
    return world["refs"]["plain"]


def assert_grads(got_tree, want_tree):
    got = jax.tree_util.tree_flatten_with_path(got_tree)[0]
    want = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    assert len(got) == len(want)
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a, b, atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=str(path))


def assert_same_loss(outcome):
    """Every rank's loss and its gradients of the leaves every stage holds
    whole are rank 0's (a stage that missed the embedding's sum over the
    stages would hold a zero gradient there); returns the loss."""
    first = outcome[0]["loss"]
    assert all(outcome[rank]["loss"] == first for rank in outcome)
    assert all(outcome[rank]["shared"] == outcome[0]["shared"]
               for rank in outcome)
    return first


# -- in process ----------------------------------------------------------------

LAYOUTS = [dict(pp=2, sp=2, fsdp=2), dict(pp=2, dp=2, fsdp=2),
           dict(sp=2, fsdp=2, tp=2), dict(sp=4, fsdp=2), dict(pp=2, sp=4),
           dict(pp=2, tp=2, sp=2), dict(pp=8), dict(sp=8)]


@pytest.mark.parametrize("axes", LAYOUTS, ids=lambda a: "_".join(
    f"{k}{v}" for k, v in a.items()))
def test_layout_and_groups_match_jax(monkeypatch, axes):
    """Rank r sits where make_mesh puts device r; each group holds the
    ranks that differ from it along its axis alone (data: along dp, fsdp
    and sp); sp, tp and pp ranks of a data shard share its data_rank."""
    mesh = jax_mesh.make_mesh(**axes)
    assert port_mesh.mesh_sizes(WORLD, **axes) == dict(mesh.shape)
    where = {device.id: dict(zip(mesh.axis_names, index))
             for index, device in np.ndenumerate(mesh.devices)}
    ids = [device.id for device in jax.devices()]
    data_ranks = {}
    for rank, device in enumerate(ids):
        ours, fake = ranks.built_mesh(monkeypatch, rank, **axes)
        position = where[device]
        assert ours.position == position
        assert ours.coords == {axis: index for axis, index in position.items()
                               if axis in ("dp", "fsdp", "tp")
                               or mesh.shape[axis] > 1}

        def along(*moving):
            return sorted(r for r, d in enumerate(ids)
                          if all(where[d][a] == position[a]
                                 for a in port_mesh.AXES if a not in moving))

        for axis in ("tp", "fsdp", "sp", "pp"):
            group = getattr(ours, f"{axis}_group")
            members = along(axis)
            assert (group is None) == (len(members) == 1), axis
            if group is not None:
                assert sorted(group) == members, axis
        data = along("dp", "fsdp", "sp")
        assert (ours.data_group is None) == (len(data) == 1)
        if ours.data_group is not None:
            assert sorted(ours.data_group) == data
        key = (position["dp"], position["fsdp"])
        assert data_ranks.setdefault(key, ours.data_rank) == ours.data_rank
        # every rank makes every group, in one order
        assert fake.groups == ranks.built_mesh(monkeypatch, 0, **axes)[1].groups
    assert sorted(data_ranks.values()) == list(range(
        mesh.shape["dp"] * mesh.shape["fsdp"]))


def test_validation_errors():
    """JAX's words: layers that pp does not divide, rows that the
    microbatch count does not divide; and sp against the sequence."""
    config = torch_train_ranks.model_config("tiny", n_layers=3)
    tokens = torch.zeros(1, 33, dtype=torch.int32)
    mesh = port_mesh.TrainMesh(1, 4, 1, pp=2)
    params = TransformerLM.init(config, device="cpu")
    with pytest.raises(ValueError, match="not divisible by pp"):
        TransformerLM.loss(params, tokens, config, mesh=mesh)
    with pytest.raises(ValueError, match="not divisible by pp"):
        train.make_train_step(config, train.TrainConfig(batch_size=4), mesh)
    config = dataclasses.replace(config, n_layers=2, pp_microbatches=3)
    stage = TransformerLM.init(config, device="cpu", layers=range(1))
    with pytest.raises(ValueError, match="microbatches"):
        TransformerLM.loss(stage, tokens, config, mesh=mesh)
    with pytest.raises(ValueError, match="microbatches"):
        train.make_train_step(config, train.TrainConfig(batch_size=4), mesh)
    with pytest.raises(ValueError, match="sp=4 does not divide"):
        train.make_train_step(
            torch_train_ranks.model_config("tiny"),
            train.TrainConfig(batch_size=4, seq_len=30),
            port_mesh.TrainMesh(1, 1, 1, sp=4))


def test_config_carries_across():
    """``config_from_jax`` carries every field both configs define,
    ``pp_microbatches`` included."""
    ours = config_from_jax(jax_config("tiny", pp_microbatches=4))
    assert ours == dataclasses.replace(torch_train_ranks.model_config("tiny"),
                                       pp_microbatches=4)


# -- the spawned group ---------------------------------------------------------

def test_pipeline_matches_jax(world):
    """(i) pp 2 x dp 2 x fsdp 2: each stage holds one layer; loss and
    gradients as JAX's model."""
    loss, grads = jax_plain(world)
    outcome = job(world, "i_pp_dp_fsdp")
    np.testing.assert_allclose(assert_same_loss(outcome), loss, rtol=TOL)
    assert all(outcome[rank]["layers"] == 1 for rank in outcome)
    assert_grads(outcome[0]["grads"], grads)


def test_pipeline_microbatches_and_remat(world):
    """(ii) 4 microbatches of each rank's 4 rows, block remat, tp 2 inside
    each stage."""
    loss, grads = jax_plain(world)
    outcome = job(world, "ii_microbatches")
    np.testing.assert_allclose(assert_same_loss(outcome), loss, rtol=TOL)
    assert_grads(outcome[0]["grads"], grads)


def test_pipeline_train_loop(world):
    """(iii) train_loop on the pipeline, 4 layers in 2 stages."""
    outcome = job(world, "iii_loop")
    first = outcome[0]
    assert math.isfinite(first["loss"]) and math.isfinite(first["grad_norm"])
    assert all(outcome[rank] == first for rank in outcome)
    config = dataclasses.replace(torch_train_ranks.model_config("c1"),
                                 **LOOP_KNOBS)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)            # the ranks hold the other cores
    try:
        single = train.train_loop(config, train.TrainConfig(**TC_LOOP),
                                  num_steps=3, log_every=0, device="cpu")
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_allclose(first["loss"], single["loss"], rtol=1e-4)


def test_pipeline_with_ring_matches_jax(world):
    """(iv) pp 2 x sp 2 x fsdp 2: the ring inside each stage."""
    loss, grads = jax_plain(world)
    outcome = job(world, "iv_pp_sp")
    np.testing.assert_allclose(assert_same_loss(outcome), loss, rtol=TOL)
    assert_grads(outcome[0]["grads"], grads)


def test_encoder_mlm_under_pp_sp(world):
    """(v) the MLM objective (non-causal ring in the stages, the mask
    count summed over dp x fsdp x sp) against JAX's."""
    outcome = job(world, "v_mlm")
    np.testing.assert_allclose(assert_same_loss(outcome),
                               world["refs"]["mlm_pp"], rtol=TOL)


@pytest.mark.parametrize("name", ["vi_lm_step", "vi_mlm_step"])
def test_sp_step_matches_jax_mesh_step(world, name):
    """(vi) one step at sp 2 x fsdp 2 x tp 2 against JAX's mesh step."""
    metrics, params, mu = world["refs"][name[:-5]]
    outcome = job(world, name)
    first = outcome[0]["metrics"]
    assert all(outcome[rank]["metrics"] == first for rank in outcome)
    assert_metrics(first, metrics)
    assert_state_matches(outcome[0]["whole"], params, mu)


def test_checkpoint_across_pp_and_sp(world):
    """(vii) the pp 2 x sp 2 x fsdp 2 checkpoint, restored bitwise at dp 2
    x fsdp 2 x tp 2 (which then steps) and on one device; bytes per rank
    exactly the specs' share, a stage's layers only."""
    outcome = job(world, "vii_checkpoint")
    for rank in outcome:
        assert outcome[rank]["held"] == outcome[rank]["expected"]
        assert outcome[rank]["layers"] == 1 and outcome[rank]["init_equal"]
    first = outcome[0]
    assert first["files"] == [
        f"step_0000000007.ranks/pp{p}_fsdp{f}_tp0_of_2x2x1.pt"
        for p in range(2) for f in range(2)]
    assert first["count"] == 2
    for shape, restored in first["restored"].items():
        for key in ("params", "mu", "nu"):
            got = jax.tree_util.tree_leaves(restored[key])
            want = jax.tree_util.tree_leaves(first["saved"][key])
            assert len(got) == len(want)
            assert all(np.array_equal(a, b) for a, b in zip(got, want)), \
                (shape, key)
    assert all(math.isfinite(loss) for loss in first["losses"].values())
