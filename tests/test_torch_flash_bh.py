"""The port's head-blocked flash forward (``bh_block``) against the JAX
package's ``_fwd_kernel_resident_bh``.

* ``fwd_bh_block`` picks the G that the JAX ``_fwd_bh_block`` picks under
  ``TPUHIVE_FLASH_BH_BLOCK`` for every (b·h rows, GQA group, S, d_head,
  dtype, requested G) of a grid that reaches each of its clamps.
* ``flash_attention(..., bh_block=4)`` on CPU tensors — the plain version,
  which the CUDA kernel is held to on the card — against the JAX
  ``flash_attention`` in interpret mode under ``TPUHIVE_FLASH_BH_BLOCK=4``,
  causal and not: the forward within 2e-5 and the q/k/v gradients (the
  standard backward reading the head-blocked forward's LSE) within 2e-4,
  the JAX package's own bounds for this kernel
  (``tests/unit/test_compute.py``). The env knob is read at trace time, so
  JAX's caches are dropped before and after.
"""
import importlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorhive_tpu_torch.ops import flash_attention as fa

# the module, not the function that tensorhive_tpu.ops re-exports by its name
jax_fa = importlib.import_module("tensorhive_tpu.ops.flash_attention")

DTYPES = ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16))


@pytest.mark.parametrize("requested", [0, 1, 2, 3, 4, 8])
def test_bh_block_choice_matches_jax(monkeypatch, requested):
    monkeypatch.setenv("TPUHIVE_FLASH_BH_BLOCK", str(requested))
    grid = itertools.product((1, 6, 8, 12, 128, 512), (1, 2, 4),
                             (256, 1024, 4096, 8192), (32, 64, 128), DTYPES)
    for bh, group, seq, d, (torch_dtype, jax_dtype) in grid:
        ours = fa.fwd_bh_block(bh, group, seq, d, torch_dtype, requested)
        theirs = jax_fa._fwd_bh_block(bh, group, seq, d, jax_dtype)
        assert ours == theirs, (bh, group, seq, d, torch_dtype, requested)
    # the shapes the card runs: t2t-big asks for 4, f32 clamps to 2
    assert fa.fwd_bh_block(128, 1, 4096, 64, torch.bfloat16, 4) == 4
    assert fa.fwd_bh_block(128, 1, 4096, 64, torch.float32, 4) == 2
    assert fa.fwd_bh_block(512, 1, 1024, 64, torch.bfloat16, 8) == 8
    assert fa.fwd_bh_block(256, 4, 2048, 128, torch.bfloat16, 4) == 1


@pytest.fixture
def jax_bh_block(monkeypatch):
    monkeypatch.setenv("TPUHIVE_FLASH_BH_BLOCK", "4")
    jax.clear_caches()
    yield
    jax.clear_caches()      # no head-blocked executables leak to others


@pytest.mark.parametrize("causal", [True, False])
def test_bh_block_forward_and_grads_match_jax(jax_bh_block, causal):
    batch, seq, heads, d = 2, 128, 4, 32
    assert jax_fa._fwd_bh_block(batch * heads, 1, seq, d, jnp.float32) == 4
    rng = np.random.default_rng(17 + causal)
    q, k, v, weight = (rng.standard_normal((batch, seq, heads, d),
                                           np.float32) for _ in range(4))

    def jax_loss(q, k, v):
        out = jax_fa.flash_attention(q, k, v, causal=causal, interpret=True)
        return jnp.sum(out * jnp.asarray(weight)), out

    (_, jax_out), jax_grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = dict(fa.launches)
    out = fa.flash_attention(*leaves, causal=causal, bh_block=4)
    grads = torch.autograd.grad((out * torch.from_numpy(weight)).sum(),
                                leaves)
    assert fa.launches == before                # CPU: no kernel launch
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jax_out),
                               atol=2e-5, rtol=2e-5)
    for grad, want, name in zip(grads, jax_grads, "qkv"):
        np.testing.assert_allclose(grad.numpy(), np.asarray(want), atol=2e-4,
                                   rtol=2e-4, err_msg=f"d{name}")


def test_bh_block_is_the_per_head_function_on_the_cpu():
    """On CPU tensors every G runs the plain version: O and LSE do not
    depend on the request, GQA included (where G stays 1)."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 40, 6, 16), np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, 40, 3, 16), np.float32))
    for k, v in ((q, q * 0.5), (kv, kv * 0.5)):
        base = fa.flash_attention(q, k, v, causal=False, return_lse=True)
        for request in (2, 3, 4, 12):
            blocked = fa.flash_attention(q, k, v, causal=False,
                                         return_lse=True, bh_block=request)
            for got, want in zip(blocked, base):
                assert torch.equal(got, want)


def test_bh_block_refuses_other_devices():
    q = torch.zeros((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(q, q, q, bh_block=2)
