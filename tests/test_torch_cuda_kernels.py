"""The CUDA kernels against their plain versions at every head dim, GQA
group and page type they accept, and the tiny engine on the card against
the same engine on the CPU.

These tests need the card and skip without a CUDA device. On the card,
where JAX is not installed, run them without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``chip_smoke.py`` covers the main path's shapes, the 7b heads.) Tolerances:
f32 outputs 1e-5 abs (accumulation order only). bf16 outputs against the
f32 plain version on the same bf16 values: the kernel rounds its output,
and the flash kernel its probabilities, to bf16, an error that scales with
the output row, so each row (the d_head values of one token and head) is
held to ||out - plain||_2 / ||plain||_2 <= 1e-2.
"""
import dataclasses

import numpy as np
import pytest
import torch

from tensorhive_tpu_torch.ops import flash_attention as fa
from tensorhive_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda

ABS_TOL = 1e-5
ROW_REL_TOL = 1e-2
LSE_TOL = 5e-5


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def assert_close_to_plain(out, ref):
    diff = out.float() - ref
    if out.dtype == torch.bfloat16:
        row_rel = diff.norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)
        assert row_rel.max().item() <= ROW_REL_TOL
    else:
        assert diff.abs().max().item() <= ABS_TOL


def normal(generator, shape, dtype):
    return torch.randn(shape, generator=generator, device=generator.device
                       ).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (4, 1), (8, 2)])
@pytest.mark.parametrize("causal,seq", [(True, 1), (True, 70), (True, 128),
                                        (False, 100)])
def test_flash_kernel_matches_plain(device, dtype, d, heads, kv_heads,
                                    causal, seq):
    generator = torch.Generator(device=device).manual_seed(d * 1000 + seq)
    q = normal(generator, (2, seq, heads, d), dtype)
    k = normal(generator, (2, seq, kv_heads, d), dtype)
    v = normal(generator, (2, seq, kv_heads, d), dtype)
    variant = "bf16" if dtype == torch.bfloat16 else "f32"
    before = fa.launches[variant]
    out, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    ref, ref_lse = fa.reference_attention(q.float(), k.float(), v.float(),
                                          causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert fa.launches[variant] == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    assert_close_to_plain(out, ref)
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL


@pytest.mark.parametrize("variant", ["bf16", "f32", "int8", "int8/bf16q"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (4, 2), (8, 2), (8, 1)])
@pytest.mark.parametrize("page_size", [8, 16])
def test_paged_kernel_matches_plain(device, variant, d, heads, kv_heads,
                                    page_size):
    """Five slots over a shuffled pool: a parked slot (position 0, trash
    row), positions at both sides of a page boundary, one mid-page and one
    at the last position of a 4-page window."""
    generator = torch.Generator(device=device).manual_seed(d + heads)
    max_pages = 4
    positions = [0, page_size - 1, page_size, 3 * page_size + 2,
                 max_pages * page_size - 1]
    live = [0] + [p // page_size + 1 for p in positions[1:]]
    num_pages = 1 + sum(live) + 3
    physical = np.random.default_rng(d).permutation(np.arange(1, num_pages))
    table = np.zeros((len(positions), max_pages), np.int32)
    cursor = 0
    for slot, count in enumerate(live):
        table[slot, :count] = physical[cursor:cursor + count]
        cursor += count
    quant = variant.startswith("int8")
    q_dtype = (torch.float32 if variant in ("f32", "int8")
               else torch.bfloat16)
    shape = (num_pages, page_size, kv_heads, d)
    q = normal(generator, (len(positions), 1, heads, d), q_dtype)
    if quant:
        k_pages = torch.randint(-127, 128, shape, generator=generator,
                                device=device, dtype=torch.int8)
        v_pages = torch.randint(-127, 128, shape, generator=generator,
                                device=device, dtype=torch.int8)
        k_scales = 0.005 + 0.015 * torch.rand((num_pages, kv_heads),
                                              generator=generator,
                                              device=device)
        v_scales = 0.005 + 0.015 * torch.rand((num_pages, kv_heads),
                                              generator=generator,
                                              device=device)
        plain_pages = (k_pages, v_pages)
    else:
        k_pages = normal(generator, shape, q_dtype)
        v_pages = normal(generator, shape, q_dtype)
        k_scales = v_scales = None
        plain_pages = (k_pages.float(), v_pages.float())
    page_table = torch.from_numpy(table).to(device)
    pos = torch.tensor(positions, dtype=torch.int32, device=device)
    key = variant.split("/")[0]
    before = pa.launches[key]
    out = pa.paged_attention(q, k_pages, v_pages, page_table, pos,
                             k_scales=k_scales, v_scales=v_scales)
    ref = pa.paged_attention_reference(q.float(), *plain_pages, page_table,
                                       pos, k_scales, v_scales)
    torch.cuda.synchronize()
    assert pa.launches[key] == before + 1
    assert out.shape == q.shape and out.dtype == q_dtype
    assert bool(torch.isfinite(out).all())
    # slot 0 is parked: its output is finite garbage by contract
    assert_close_to_plain(out[1:], ref[1:])


def test_wrappers_refuse_what_the_kernels_do_not_take(device):
    generator = torch.Generator(device=device).manual_seed(0)
    q = normal(generator, (1, 8, 4, 48), torch.float32)
    with pytest.raises(ValueError, match="d_head"):
        fa.flash_attention(q, q, q)
    q = normal(generator, (1, 8, 4, 16), torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           q, q)
    pages = normal(generator, (3, 8, 1, 16), torch.float32)
    table = torch.zeros((2, 2), dtype=torch.int32, device=device)
    pos = torch.zeros(2, dtype=torch.int32, device=device)
    q = normal(generator, (2, 1, 3, 16), torch.float32)      # group 3
    with pytest.raises(ValueError, match="query heads per kv head"):
        pa.paged_attention(q, pages, pages, table, pos)
    q = normal(generator, (2, 1, 4, 16), torch.float32)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_attention(q, pages, pages, table.long(), pos)
    with pytest.raises(ValueError, match="scales"):
        pa.paged_attention(q, pages.to(torch.int8), pages.to(torch.int8),
                           table, pos)


@pytest.mark.parametrize("kv_quant", ["off", "on"])
def test_tiny_engine_on_the_card_matches_the_cpu(device, kv_quant):
    """The f32 tiny engine through both kernels (d_head 16, MHA) emits the
    tokens its plain CPU twin emits on the same params."""
    from tensorhive_tpu_torch.convert import params_from_jax, params_to_numpy
    from tensorhive_tpu_torch.models.transformer import PRESETS, TransformerLM
    from tensorhive_tpu_torch.serving.engine import SlotEngine

    config = dataclasses.replace(PRESETS["tiny"], dtype=torch.float32,
                                 max_seq_len=128)
    params = TransformerLM.init(config, torch.Generator().manual_seed(0),
                                device="cpu")
    on_card = params_from_jax(params_to_numpy(params), config, device)
    prompts = [list(range(3, 11)), [5], list(range(1, 41)), [9, 8, 7]]
    results = []
    for device_params, where in ((params, "cpu"), (on_card, device)):
        engine = SlotEngine(device_params, config, slots=4, max_len=96,
                            kv_quant=kv_quant, device=where)
        engine.warmup(prompt_lens=(16, 48))
        handles = []
        for prompt in prompts:
            handles.append(engine.submit(prompt, max_new_tokens=8))
            engine.step()
        engine.pump()
        results.append([h.result(timeout_s=30)["tokens"] for h in handles])
    assert results[0] == results[1]
