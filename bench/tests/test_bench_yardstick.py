"""The work and least times of the yardstick against hand-worked figures
for the configuration, and for a sliding-window variant of it."""
import json
import math
import os

import pytest
from conftest import ROOT

from harness import yardstick as ys
from harness.weights import leaf_specs


def model(name):
    d = json.load(open(os.path.join(ROOT, "bench", "configs",
                                    name + ".json")))
    return d


YI = model("yi-9b-16of48")
YI_W = dict(YI, attn_pattern="sliding", window=1024)


def test_product_parameters_by_hand():
    # yi-9b a layer: wq, wo 4096^2; wk, wv 4096 x 512; three 4096 x 11008
    yi_layer = 2 * 4096 * 4096 + 2 * 4096 * 512 + 3 * 4096 * 11008
    assert yi_layer == 173_015_040
    assert ys.product_params(YI) == 16 * 173_015_040 + 4096 * 64000 \
        == 3_030_384_640
    # every parameter: the products, the embedding and the vectors
    assert sum(math.prod(s) for _, s, _ in leaf_specs(YI)) == \
        3_030_384_640 + 64000 * 4096 + 16 * 2 * 4096 + 4096


def test_attention_pairs_by_hand():
    assert ys.attn_pairs(4096, None) == 4096 * 4097 // 2 == 8_390_656
    # window 1024: the first 1024 rows causal, the rest 1024 keys each
    assert ys.attn_pairs(4096, 1024) == 1024 * 1025 // 2 + 3072 * 1024 \
        == 3_670_528
    assert ys.attn_pairs(512, 1024) == 512 * 513 // 2


def test_training_flops_by_hand():
    # yi-9b, 4 x 4096: 6 N a token, and QK^T, PV (4 H hd a pair a layer)
    # three times with the backward
    attn = 3 * 4 * 16 * 32 * 128 * 8_390_656
    assert ys.train_flops(YI, 4, 4096) == pytest.approx(
        6 * 4 * 4096 * 3_030_384_640 + 4 * attn, rel=1e-12)
    per_token = ys.train_flops(YI, 4, 4096) / (4 * 4096)
    assert per_token == pytest.approx(19.79e9, rel=1e-3)
    # a window of 1024 caps the pairs, not the products
    w = 6 * 4096 * 3_030_384_640 + 3 * 4 * 16 * 32 * 128 * 3_670_528
    assert ys.train_flops(YI_W, 1, 4096) == pytest.approx(w, rel=1e-12)


def test_serving_flops_by_hand():
    # a prefill of 1000 tokens: the layers' products at every token, the
    # head at the last, attention over the causal pairs
    p = 2 * 1000 * 16 * 173_015_040 + 2 * 4096 * 64000 \
        + 4 * 16 * 32 * 128 * (1000 * 1001 // 2)
    assert ys.prefill_flops(YI, 1000) == pytest.approx(p, rel=1e-12)
    # a token decoded at position 1000 attends 1001 keys
    d = 2 * 3_030_384_640 + 4 * 16 * 32 * 128 * 1001
    assert ys.decode_flops(YI, 1000) == pytest.approx(d, rel=1e-12)
    # a window caps the keys
    assert ys.decode_flops(YI_W, 5000) == pytest.approx(
        2 * 3_030_384_640 + 4 * 16 * 32 * 128 * 1024, rel=1e-12)


def test_gemm_least_time_by_hand():
    # training, M 16384 x K 4096 x N 4096: bound by the int8 rate
    ops = 2 * 16384 * 4096 * 4096
    assert ys.gemm_least_s(16384, 4096, 4096) == pytest.approx(
        ops / 1979e12, rel=1e-12)
    # a tick, M 64 x 4096 x 11008: bound by the bytes, weights 8-bit
    # mantissas and one exponent a 128 x 128 tile, activations bf16
    nbytes = 2 * 64 * 4096 + 4096 * 11008 + 4096 * 11008 / 16384 \
        + 2 * 64 * 11008
    assert nbytes == 47_024_832
    assert ys.gemm_least_s(64, 4096, 11008) == pytest.approx(
        nbytes / 3.35e12, rel=1e-12)
    # wgrad reads both activations and writes the bf16 gradient
    assert ys.gemm_least_s(64, 4096, 11008, ys.WGRAD) == pytest.approx(
        (2 * 64 * 4096 + 2 * 64 * 11008 + 2 * 4096 * 11008) / 3.35e12,
        rel=1e-12)


def test_step_least_times_sum_their_products():
    per_layer = sum(ys.gemm_least_s(16384, k, n, op)
                    for _, k, n in ys.layer_products(YI)
                    for op in (ys.FWD, ys.DGRAD, ys.WGRAD))
    head = sum(ys.gemm_least_s(16384, 4096, 64000, op)
               for op in (ys.FWD, ys.DGRAD, ys.WGRAD))
    assert ys.train_gemm_least_s(YI, 16384) == pytest.approx(
        16 * per_layer + head, rel=1e-12)
    # flash, yi-9b 4 x 4096: 12 pair-products a layer (4 fwd, 8 bwd) at
    # the int8 rate, compute-bound
    mac = 4 * 32 * 128 * 8_390_656
    assert ys.flash_least_s(YI, 4, 4096) == pytest.approx(
        16 * 12 * mac / 1979e12, rel=1e-12)
    tick = ys.serve_gemm_least_s(YI, [], [64])
    assert tick == pytest.approx(
        16 * sum(ys.gemm_least_s(64, k, n)
                 for _, k, n in ys.layer_products(YI))
        + ys.gemm_least_s(64, 4096, 64000), rel=1e-12)
