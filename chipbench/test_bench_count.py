"""The yardstick against counts made by hand."""
import json
import pathlib

import pytest

from chipbench import count

HERE = pathlib.Path(__file__).resolve().parent


def cfg(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def test_phimoe_products_per_token():
    attn = 4096 * 4096 * 2 + 4096 * 1024 * 2
    experts = 2 * 3 * 4096 * 6400            # top-2 of 16
    layer = attn + 4096 * 16 + experts
    assert layer == 199_294_976
    assert count.matmul_params(cfg("phi35moe")) == \
        16 * layer + 4096 * 32064
    # the head over the last position of each prompt only
    assert count.prefill_flops(cfg("phi35moe"), 1000) == \
        2.0 * (1000 * 16 * layer + 4096 * 32064)
    assert count.prefill_flops(cfg("phi35moe"), 3000, requests=3) == \
        2.0 * 3000 * 16 * layer + 3 * 2.0 * 4096 * 32064
    assert count.train_flops(cfg("phi35moe"), 1000) == \
        6000.0 * (16 * layer + 4096 * 32064)


def test_zamba2_counts_every_application_of_the_shared_block():
    c = cfg("zamba2")
    mamba = 3584 * (2 * 7168 + 2 * 64 + 112) + 7168 * 3584
    shared = 3584 * 3584 * 4 + 3 * 3584 * 14336
    assert (mamba, shared) == (77_930_496, 205_520_896)
    assert count.matmul_params(c) == 81 * mamba + 13 * shared + 3584 * 32000
    assert count.prefill_flops(c, 4096) == \
        2.0 * (4096 * (81 * mamba + 13 * shared) + 3584 * 32000)
    one = dict(c, hybrid_layer_ids=[6])
    assert count.matmul_params(c) - count.matmul_params(one) == 12 * shared
    assert count.attention_layers(c) == 13
    assert count.attention_shape(c) == (32, 32, 112)


def test_flash_bound_by_hand():
    # B=1, H=32, Hkv=8, S=4096, D=128: 4 H D S(S+1)/2 products' operations
    flops = 4 * 32 * 128 * 4096 * 4097 / 2
    nbytes = (2 * 32 + 2 * 8) * 4096 * 128 * 2
    assert count.flash_bound_s(1, 32, 8, 4096, 128) == pytest.approx(
        max(flops / 989e12, nbytes / 3.35e12))
    assert flops / 989e12 > nbytes / 3.35e12
    # a short sequence is bound by its bytes
    assert count.flash_bound_s(1, 32, 8, 16, 128) == pytest.approx(
        (2 * 32 + 2 * 8) * 16 * 128 * 2 / 3.35e12)


@pytest.mark.parametrize("nbytes", [1, 4096, 262144, 262145, 3 * 262144,
                                    10 * 262144 + 17])
def test_stripe_rows_and_xor_bound(nbytes):
    rows = count.stripe_rows(nbytes, 262144, 3)
    assert sum(rows) == nbytes and len(rows) <= 3
    assert rows == sorted(rows, reverse=True)
    lanes = count.xor_lanes(max(rows))
    assert lanes % 4 == 0 and 0 <= lanes * 4 - max(rows) < 16
    assert count.xor_bound_s(len(rows), lanes) == pytest.approx(
        (len(rows) + 1) * lanes * 4 / 3.35e12)
