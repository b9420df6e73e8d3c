"""The port's LoRA under a training mesh against the JAX package's LoRA
under the same mesh.

JAX's adapters are whole on every device (``param_sharding`` replicates a
leaf it has no logical axes for); so are the port's, and each rank adds
``A[rows] @ B[:, cols]`` to its block of the frozen base. One spawned
group of 8 ranks on the CPU over gloo (rank code in
``tests/torch_lora_ranks.py``, no JAX) runs every job while the parent runs
JAX's ``make_train_step(mesh, loss_fn=partial(lora_loss, ...))`` on the
suite's 8 CPU devices. The tiny preset with GQA (4 heads over 2 KV heads),
f32 on both sides; JAX-made base weights and adapters (B drawn nonzero from
numpy, so that A has a gradient too), carried across as numpy trees.

* At dp 2 x fsdp 2 x tp 2 and at pp 2 x sp 2 x fsdp 2: the loss, the
  global gradient norm and every adapter's gradient against
  ``jax.value_and_grad`` of JAX's ``lora_loss`` under the mesh (loss and
  norm within 1e-5 relative; each gradient within 1e-5 of its leaf's
  largest element); 3 steps against JAX's 3 mesh steps (loss and
  grad_norm at each step within 1e-5 relative, the adapters and Adam's
  ``mu`` and ``nu`` after them within 1e-5 of each leaf's largest element);
  the frozen base bitwise unchanged on every rank. The gradient is summed
  over fsdp and tp, never again over dp or sp: Adam hides a constant
  factor on a gradient, the gradient and its norm do not.
* ``init_lora`` from one seed draws the same adapters on both meshes as on
  one device.
* A checkpoint written at pp 2 x sp 2 x fsdp 2 (one file per (pp, fsdp)
  coordinate, the adapters in the fsdp 0 files) restores bitwise at dp 2 x
  fsdp 2 x tp 2 and on one device into ``meta`` templates, then steps.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tensorhive_tpu import train as jax_train
from tensorhive_tpu.models import lora as jax_lora
from tensorhive_tpu.models.transformer import TransformerLM as JaxLM
from tensorhive_tpu.parallel import mesh as jax_mesh
from tests import torch_lora_ranks
from tests import torch_pp_sp_ranks as pp_sp_ranks
from tests.test_torch_train_mesh import jax_config, jax_mu, numpy_tree

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device CPU platform")

WORLD = 8
#: the spawned group's whole run, joins included
JOIN_TIMEOUT_S = 300
TOL = 1e-5
STEPS = 3

KNOBS = dict(n_kv_heads=2)
LORA = dict(rank=4, alpha=8.0)
TC = dict(batch_size=8, seq_len=32, warmup_steps=1, total_steps=10,
          learning_rate=1e-2)
MESHES = {"dp_fsdp_tp": dict(dp=2, fsdp=2, tp=2),
          "pp_sp_fsdp": dict(pp=2, sp=2, fsdp=2)}


def jobs(ckpt):
    common = dict(config="tiny", knobs=KNOBS, lora=LORA, train=TC)
    return [
        *({"name": name, "kind": "lora_step", "mesh": axes, "steps": STEPS,
           **common} for name, axes in MESHES.items()),
        {"name": "init", "kind": "lora_init", "meshes": list(MESHES.values()),
         **common},
        {"name": "checkpoint", "kind": "lora_checkpoint", "steps": 2,
         "save": MESHES["pp_sp_fsdp"], "restore": [MESHES["dp_fsdp_tp"]],
         "path": str(ckpt), **common},
    ]


def jax_inputs():
    """JAX's base, its adapters with B drawn from numpy, and the tokens."""
    config = jax_config("tiny", **KNOBS)
    base = JaxLM.init(jax.random.PRNGKey(0), config)
    adapters = jax_lora.init_lora(jax.random.PRNGKey(1), base,
                                  jax_lora.LoraConfig(**LORA))
    rng = np.random.default_rng(5)
    adapters = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (rng.standard_normal(leaf.shape, np.float32)
                            * 0.05) if path[-1].key == "B"
        else np.asarray(leaf), adapters)
    tokens = rng.integers(0, config.vocab_size,
                          (TC["batch_size"], TC["seq_len"] + 1),
                          dtype=np.int32)
    return {"base": numpy_tree(base), "adapters": adapters,
            "tokens": tokens}


def jax_reference(inputs, axes):
    """JAX's LoRA under ``axes``: the loss and adapter gradients of
    ``lora_loss``, then ``STEPS`` mesh steps (metrics, adapters, mu, nu)."""
    config = jax_config("tiny", **KNOBS)
    mesh = jax_mesh.make_mesh(**axes)

    def placed(tree):
        tree = jax.tree_util.tree_map(jnp.asarray, tree)
        return jax.device_put(tree, jax_mesh.tree_shardings(mesh, tree))

    base = placed(inputs["base"])
    lora_config = jax_lora.LoraConfig(**LORA)
    loss_fn = functools.partial(jax_lora.lora_loss, base_params=base,
                                lora_config=lora_config)
    tokens = jax.device_put(jnp.asarray(inputs["tokens"]),
                            jax_mesh.batch_sharding(mesh))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda a, t: loss_fn(a, t, config, mesh)))(
            placed(inputs["adapters"]), tokens)
    tc = jax_train.TrainConfig(**TC)
    step = jax_train.make_train_step(config, tc, mesh, loss_fn=loss_fn)
    adapters = placed(inputs["adapters"])
    opt = jax_train.make_optimizer(tc).init(adapters)
    metrics = []
    for _ in range(STEPS):
        adapters, opt, out = step(adapters, opt, tokens)
        metrics.append({key: float(value) for key, value in out.items()})
    nu = next(node.nu for node in jax.tree_util.tree_leaves(
        opt, is_leaf=lambda n: hasattr(n, "nu")) if hasattr(node, "nu"))
    return {"loss": float(loss), "grads": numpy_tree(grads),
            "metrics": metrics, "params": numpy_tree(adapters),
            "mu": numpy_tree(jax_mu(opt)), "nu": numpy_tree(nu)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The spawned group, started first so its ranks run beside JAX's
    references."""
    inputs = jax_inputs()
    group = pp_sp_ranks.Group(
        tmp_path_factory.mktemp("group"), WORLD,
        jobs(tmp_path_factory.mktemp("ckpt") / "run"), inputs,
        JOIN_TIMEOUT_S, target=torch_lora_ranks.rank_main)
    refs = {name: jax_reference(inputs, axes)
            for name, axes in MESHES.items()}
    yield {"inputs": inputs, "refs": refs, "group": group}
    group.outcomes()


def job(world, name):
    return world["group"].outcomes()[name]


def leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def assert_leaf_close(got_tree, want_tree, what):
    """Every leaf within TOL of its largest element."""
    got, want = leaves(got_tree), leaves(want_tree)
    assert len(got) == len(want) > 0
    for index, (a, b) in enumerate(zip(got, want)):
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(np.asarray(a) - np.asarray(b)).max())
        assert err <= TOL * scale, (what, index, err, scale)


@pytest.mark.parametrize("name", list(MESHES))
def test_lora_gradients_match_jax_mesh(world, name):
    """The loss, the global norm and every adapter gradient on the mesh
    against JAX's on the same mesh; the same loss and norm on every rank."""
    ref = world["refs"][name]
    outcome = job(world, name)
    for rank in outcome:
        np.testing.assert_allclose(outcome[rank]["loss"], ref["loss"],
                                   rtol=TOL, atol=0)
        np.testing.assert_allclose(outcome[rank]["grad_norm"],
                                   ref["metrics"][0]["grad_norm"], rtol=TOL,
                                   atol=0)
    assert_leaf_close(outcome[0]["grads"], ref["grads"], "grads")


@pytest.mark.parametrize("name", list(MESHES))
def test_lora_steps_match_jax_mesh(world, name):
    """3 steps: metrics at every step on every rank, then the adapters and
    Adam's moments, against JAX's mesh steps; the base bitwise unchanged."""
    ref = world["refs"][name]
    outcome = job(world, name)
    for rank in outcome:
        assert outcome[rank]["base_unchanged"], rank
        assert outcome[rank]["metrics"] == outcome[0]["metrics"]
    for got, want in zip(outcome[0]["metrics"], ref["metrics"]):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[key], want[key], rtol=TOL,
                                       atol=0, err_msg=key)
    whole = outcome[0]["whole"]
    for key in ("params", "mu", "nu"):
        assert_leaf_close(whole[key], ref[key], key)


def test_lora_init_is_the_same_on_any_mesh(world):
    outcome = job(world, "init")
    assert all(all(equal.values()) and len(equal) == len(MESHES)
               for equal in outcome.values()), outcome


def test_lora_checkpoint_restores_across_meshes(world):
    """Written at pp 2 x sp 2 x fsdp 2: a file per (pp, fsdp) coordinate,
    restored bitwise at dp 2 x fsdp 2 x tp 2 and on one device, and a
    step on the restored mesh state."""
    outcome = job(world, "checkpoint")[0]
    assert outcome["files"] == [
        f"step_0000000007.ranks/pp{p}_fsdp{f}_tp0_of_2x2x1.pt"
        for p in range(2) for f in range(2)]
    assert outcome["count"] == 2
    assert set(outcome["restored"]) == {str(MESHES["dp_fsdp_tp"]), "single"}
    for where, restored in outcome["restored"].items():
        for key in ("params", "mu", "nu"):
            for got, want in zip(leaves(restored[key]),
                                 leaves(outcome["saved"][key])):
                assert np.array_equal(got, want), (where, key)
    assert all(np.isfinite(loss) for loss in outcome["losses"].values())
