"""The port's ring attention (``parallel/ring.py``) against the JAX
package's.

One spawned group of 4 ranks on the CPU over gloo (sp 4; rank code in
``tests/torch_pp_sp_ranks.py``, no JAX) runs every case while the parent
runs JAX on the suite's 8 CPU devices. Inputs are made with numpy from
seeds; each rank takes its sequence block of q, k and v, and the parent
assembles the blocks. On CPU tensors the ring's kernel wrappers run their
plain versions, so these hold the ring's schedule, merge and gradient
rotation; the kernels themselves are held on the card. Tolerances are
JAX's own tests' (``tests/unit/test_compute.py``):

* (a) f32 forward, causal and not, at B 2, S 256, H 2, d 32: 2e-5 against
  JAX's ``ring_attention`` on a fsdp 2 x sp 4 mesh (``:72``);
* (b) f32 forward at the flash-ring shapes B 1, S 1024 (``:537``): 3e-5
  against ``reference_attention``, the oracle JAX's flash-ring tests hold
  theirs to (JAX's interpret-mode flash-ring takes minutes on this CPU);
* (c) GQA at H 4 / Hkv 2, S 1024 (``:557``): forward 3e-5 and the
  gradients of ``sum(out * dO)`` 3e-4 against ``jax.vjp`` of the oracle;
  dK/dV come back at KV width, and every block the ring moves (K/V and
  their f32 gradient accumulators) is at KV width;
* (d) the backward at S 512 (``:615``): gradients of ``sum(out ** 2)``
  within 5e-4;
* (e) bf16 inputs at S 512 (``:641``): forward within 0.05 and gradients
  within 0.2 of the f32 oracle, outputs and gradients bf16;
* every case: rank ``i`` of a causal ring calls the forward (and backward)
  kernel ``i + 1`` times, one causal (the diagonal) and ``i`` full (past
  blocks), none for future blocks; a non-causal ring calls each ``sp``
  times, all full.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorhive_tpu.ops.flash_attention import (
    reference_attention as jax_reference,
)
from tensorhive_tpu.parallel import mesh as jax_mesh
from tensorhive_tpu.parallel.ring import ring_attention as jax_ring
from tensorhive_tpu_torch.ops.flash_attention import reference_attention
from tensorhive_tpu_torch.parallel import ring_attention
from tests import torch_pp_sp_ranks as ranks

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device CPU platform")

SP = 4
#: the spawned group's whole run, joins included
JOIN_TIMEOUT_S = 240
MESH = {"sp": SP}

#: name -> (seed, B, S, H, Hkv, d, with dO)
CASES = {
    "a": (1, 2, 256, 2, 2, 32, False),
    "b": (13, 1, 1024, 2, 2, 32, False),
    "c": (17, 1, 1024, 4, 2, 32, True),
    "d": (17, 1, 512, 2, 2, 32, False),
    "e": (23, 1, 512, 2, 2, 32, False),
}


def make_inputs(seed, batch, seq, heads, kv_heads, d, with_do):
    rng = np.random.default_rng(seed)
    out = {"q": rng.standard_normal((batch, seq, heads, d), np.float32),
           "k": rng.standard_normal((batch, seq, kv_heads, d), np.float32),
           "v": rng.standard_normal((batch, seq, kv_heads, d), np.float32)}
    if with_do:
        out["do"] = rng.standard_normal((batch, seq, heads, d), np.float32)
    return out


def jobs():
    listed = []
    for causal in (True, False):
        for name in ("a", "b"):
            listed.append({"name": f"{name}_{causal}", "kind": "ring",
                           "mesh": MESH, "inputs": name, "causal": causal})
        listed.append({"name": f"c_{causal}", "kind": "ring", "mesh": MESH,
                       "inputs": "c", "causal": causal, "grad": True})
    listed += [
        {"name": "d", "kind": "ring", "mesh": MESH, "inputs": "d",
         "causal": True, "grad": True},
        {"name": "e", "kind": "ring", "mesh": MESH, "inputs": "e",
         "causal": True, "grad": True, "dtype": "bfloat16"},
    ]
    return listed


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    inputs = {name: make_inputs(*case) for name, case in CASES.items()}
    inputs["e"] = {key: np.asarray(jnp.asarray(value, jnp.bfloat16),
                                   np.float32)
                   for key, value in inputs["e"].items()}
    group = ranks.Group(tmp_path_factory.mktemp("ring"), SP, jobs(), inputs,
                        JOIN_TIMEOUT_S)
    yield {"inputs": inputs, "group": group}
    group.outcomes()


def assembled(outcome, key, index=None):
    """The whole [B, S, ...] array from every rank's block."""
    blocks = [outcome[rank][key] if index is None
              else outcome[rank][key][index] for rank in range(SP)]
    return np.concatenate(blocks, axis=1)


def check_calls(outcome, causal, backward):
    for rank in range(SP):
        calls = outcome[rank]["calls"]
        if causal:
            want = {"fwd_causal": 1, "fwd_full": rank}
        else:
            want = {"fwd_causal": 0, "fwd_full": SP}
        if backward:
            want.update(bwd_causal=want["fwd_causal"],
                        bwd_full=want["fwd_full"])
        else:
            want.update(bwd_causal=0, bwd_full=0)
        assert calls == want, (rank, calls, want)


def jax_oracle(arrays, causal, dtype=jnp.float32):
    """(out, (dq, dk, dv)) of JAX's ``reference_attention`` in f32; the
    gradients of ``sum(out * dO)``, or of ``sum(out ** 2)`` without
    ``do``."""
    q, k, v = (jnp.asarray(arrays[name], dtype) for name in "qkv")
    out, vjp = jax.vjp(lambda q, k, v: jax_reference(q, k, v, causal=causal),
                       q, k, v)
    cotangent = (jnp.asarray(arrays["do"]) if "do" in arrays else 2 * out)
    return np.asarray(out), [np.asarray(g) for g in vjp(cotangent)]


@pytest.mark.parametrize("causal", [True, False])
def test_ring_forward_matches_jax_ring(world, causal):
    """(a) against JAX's ring_attention under fsdp 2 x sp 4."""
    arrays = world["inputs"]["a"]
    mesh = jax_mesh.make_mesh(fsdp=2, sp=SP)
    want = jax_ring(*(jnp.asarray(arrays[name]) for name in "qkv"),
                    mesh=mesh, causal=causal, head_axis=None)
    outcome = world["group"].outcomes()[f"a_{causal}"]
    np.testing.assert_allclose(assembled(outcome, "out"), np.asarray(want),
                               atol=2e-5, rtol=2e-5)
    check_calls(outcome, causal, backward=False)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_forward_at_flash_ring_shapes(world, causal):
    """(b) S 1024 over sp 4 (256-token shards) against the oracle."""
    arrays = world["inputs"]["b"]
    want = jax_reference(*(jnp.asarray(arrays[name]) for name in "qkv"),
                         causal=causal)
    outcome = world["group"].outcomes()[f"b_{causal}"]
    np.testing.assert_allclose(assembled(outcome, "out"), np.asarray(want),
                               atol=3e-5, rtol=3e-5)
    check_calls(outcome, causal, backward=False)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_gqa_forward_and_grads(world, causal):
    """(c) GQA natively: K/V, their gradients and every rotated block at
    KV width."""
    arrays = world["inputs"]["c"]
    out, grads = jax_oracle(arrays, causal)
    outcome = world["group"].outcomes()[f"c_{causal}"]
    np.testing.assert_allclose(assembled(outcome, "out"), out, atol=3e-5,
                               rtol=3e-5)
    for index, (want, name) in enumerate(zip(grads, "qkv")):
        got = assembled(outcome, "grads", index)
        assert got.shape == arrays[name].shape
        np.testing.assert_allclose(got, want, atol=3e-4, rtol=3e-4,
                                   err_msg=f"ring gqa d{name}")
    local = 1024 // SP
    for rank in range(SP):
        moved = outcome[rank]["moved"]
        # forward: K and V each hop; backward: K/V and dK/dV, one more
        # hop of the accumulators after the last step
        assert len(moved) == 2 * (SP - 1) + 2 * (SP - 1) + 2 * SP
        assert {shape for shape, _ in moved} == {(1, local, 2, 32)}
    check_calls(outcome, causal, backward=True)


def test_ring_backward_matches_oracle(world):
    """(d) gradients of sum(out ** 2) through the ring's backward."""
    arrays = world["inputs"]["d"]
    _, grads = jax_oracle(arrays, causal=True)
    outcome = world["group"].outcomes()["d"]
    for index, (want, name) in enumerate(zip(grads, "qkv")):
        np.testing.assert_allclose(assembled(outcome, "grads", index), want,
                                   atol=5e-4, rtol=5e-4,
                                   err_msg=f"d{name} mismatch")
    check_calls(outcome, True, backward=True)


def test_ring_bf16_forward_and_grads(world):
    """(e) bf16 through the ring against the f32 oracle."""
    arrays = world["inputs"]["e"]
    out, grads = jax_oracle(arrays, causal=True)
    outcome = world["group"].outcomes()["e"]
    assert all(outcome[rank]["dtype"] == "torch.bfloat16"
               for rank in range(SP))
    np.testing.assert_allclose(assembled(outcome, "out"), out, atol=0.05,
                               rtol=0.05)
    for index, (want, name) in enumerate(zip(grads, "qkv")):
        assert all(outcome[rank]["grad_dtypes"][index] == "torch.bfloat16"
                   for rank in range(SP))
        np.testing.assert_allclose(assembled(outcome, "grads", index), want,
                                   atol=0.2, rtol=0.2, err_msg=f"d{name}")


def test_ring_single_shard_path():
    """Without a mesh (or at sp 1) the ring is flash attention on the
    whole sequence, the JAX single-shard path (``:85``)."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 64, 2, 16), np.float32))
    out = ring_attention(q, q, q, mesh=None, causal=True)
    want = jax_reference(*(jnp.asarray(q.numpy()),) * 3, causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(
        out.numpy(), reference_attention(q, q, q, causal=True).numpy(),
        atol=0)


def test_ring_group_finished_in_time(world):
    """The group's run stays well inside its join timeout."""
    world["group"].outcomes()
    assert time.monotonic() - world["group"].started < JOIN_TIMEOUT_S
