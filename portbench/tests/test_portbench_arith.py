"""The frozen arithmetic against numbers worked out by hand."""
import math

import pytest

from portbench.harness import arith

MISTRAL = arith.Shape(hidden=4096, intermediate=14336, layers=32, heads=32,
                      kv_heads=8, vocab=32768)
INTERNLM2 = arith.Shape(hidden=2048, intermediate=8192, layers=24, heads=16,
                        kv_heads=8, vocab=92544)


def test_mistral_7b_has_its_published_size():
    # per block: q, o 4096² each; k, v 4096·1024 each; three 4096·14336
    block = 2 * 4096 * 4096 + 2 * 4096 * 1024 + 3 * 4096 * 14336
    assert block == 218_103_808
    assert arith.layer_matmul_params(MISTRAL) == block
    total = 2 * 32768 * 4096 + 32 * (block + 2 * 4096) + 4096
    assert arith.param_count(MISTRAL) == total == 7_248_023_552
    assert arith.param_count(MISTRAL) * 2 / 1e9 == pytest.approx(14.496,
                                                                 abs=1e-3)


def test_internlm2_1_8b_has_its_published_size():
    block = 2 * 2048 * 2048 + 2 * 2048 * 1024 + 3 * 2048 * 8192
    assert arith.param_count(INTERNLM2) == (2 * 92544 * 2048
                                            + 24 * (block + 4096) + 2048)
    assert arith.param_count(INTERNLM2) == 1_889_110_016


@pytest.mark.parametrize("shape, seq, expected", [
    # 3 × (24 × (4·2048² + 4·2048·1024 + 6·2048·8192 + 2·4096·2048)
    #      + 2·2048·92544)
    (INTERNLM2, 4096, 3 * (24 * (16_777_216 + 8_388_608 + 100_663_296
                                 + 16_777_216) + 379_060_224)),
    (MISTRAL, 2048, 3 * (32 * (4 * 4096 ** 2 + 4 * 4096 * 1024
                               + 6 * 4096 * 14336 + 2 * 2048 * 4096)
                         + 2 * 4096 * 32768)),
])
def test_train_flops_per_token(shape, seq, expected):
    assert arith.train_flops_per_token(shape, seq) == expected


def test_train_flops_of_internlm2_cells():
    assert arith.train_flops_per_token(INTERNLM2, 4096) / 1e9 == \
        pytest.approx(11.405, abs=1e-3)
    assert arith.train_flops_per_token(INTERNLM2, 16384) / 1e9 == \
        pytest.approx(15.029, abs=1e-3)


@pytest.mark.parametrize("b, s, h, d", [(4, 4096, 16, 128), (1, 16384, 16, 128)])
def test_flash_bounds(b, s, h, d):
    assert arith.flash_fwd_flops(b, s, h, d) == 2 * s * s * h * d * b
    assert arith.flash_bwd_flops(b, s, h, d) == 5 * s * s * h * d * b
    # b4 x s4096, 16 heads of 128: 274.9 GFLOP forward a layer
    if s == 4096:
        assert arith.flash_fwd_flops(b, s, h, d) / 1e9 == pytest.approx(
            274.878, abs=1e-3)


def test_paged_decode_bytes_by_hand():
    # 1000 positions over 63 pages of 16: K and V rows at a byte a cell,
    # 2 scales of 4 bytes per page and KV head, 4 bytes a table entry,
    # q and out in bf16, all 32 layers
    rows = 2 * 1000 * 8 * 128
    scales = 2 * 63 * 8 * 4
    table = 63 * 4
    q_out = 2 * 32 * 128 * 2
    assert arith.paged_decode_bytes(1000, MISTRAL, 16) == \
        32 * (rows + scales + table + q_out)
    assert arith.paged_decode_bytes(16, INTERNLM2, 16) == \
        24 * (2 * 16 * 8 * 128 + 2 * 8 * 4 + 4 + 2 * 16 * 128 * 2)


def test_decode_tick_bound_is_the_weights_at_small_batches():
    # one token: 14.2 GB of matmul weights (+ norms) at 3.35 TB/s
    bound = arith.decode_tick_bound_s([1000], MISTRAL, 16)
    weight_bytes = (arith.matmul_params(MISTRAL) + 32 * 2 * 4096 + 4096) * 2
    kv = arith.paged_decode_bytes(1000, MISTRAL, 16)
    assert bound == pytest.approx((weight_bytes + kv) / 3.35e12)
    assert bound * 1e3 == pytest.approx(4.26, abs=0.01)
    # 4096 tokens at once: the FLOPs bound
    many = arith.decode_tick_bound_s([1] * 4096, MISTRAL, 16)
    assert many == pytest.approx(
        4096 * (2 * arith.matmul_params(MISTRAL)
                + arith.decode_attention_flops(1, MISTRAL)) / 989e12)
    assert arith.decode_tick_bound_s([], MISTRAL, 16) == 0.0
    assert math.isclose(arith.matmul_params(MISTRAL),
                        32 * 218_103_808 + 4096 * 32768)
