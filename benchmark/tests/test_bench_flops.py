"""The FLOP and byte counters against hand counts of one block of each
configuration, at the cells' 512^2 tile."""

import json

import pytest

import flops
from conftest import BENCH


def cfg(name):
    with open(BENCH / "configs" / f"{name}.json") as f:
        return json.load(f)


def block(c, B=1):
    dense, ops = flops.layers(c, 512, 512, B)
    d = {x.name: x for x in dense if x.name.startswith("blocks.0.")}
    o = {x.name: x for x in ops if x.name.startswith("blocks.0.")}
    return d, o


def test_vit_b_block_by_hand():
    d, o = block(cfg("dinounet_b"))
    n = 32 * 32 + 5  # patch tokens of a 512^2 tile, the cls and 4 storage tokens
    assert d["blocks.0.qkv"].flops == 2 * n * 768 * 2304
    assert d["blocks.0.proj"].flops == 2 * n * 768 * 768
    assert d["blocks.0.fc1"].flops == d["blocks.0.fc2"].flops == 2 * n * 768 * 3072
    assert o["blocks.0.attention"].flops == 4 * n * n * 768
    total = sum(x.flops for x in d.values()) + sum(x.flops for x in o.values())
    assert total == pytest.approx(2 * n * 768 * (2304 + 768 + 2 * 3072) + 4 * n * n * 768)


def test_vit_7b_block_by_hand():
    d, o = block(cfg("dinounet_7b"))
    n = 1029
    assert d["blocks.0.qkv"].flops == 2 * n * 4096 * 12288
    assert d["blocks.0.proj"].flops == 2 * n * 4096 * 4096
    for k in ("w1", "w2", "w3"):
        assert d[f"blocks.0.{k}"].flops == 2 * n * 4096 * 8192
    assert o["blocks.0.attention"].flops == 4 * n * n * 4096


def test_dense_bytes_and_bound_by_hand():
    d, _ = block(cfg("dinounet_b"), B=8)
    qkv = d["blocks.0.qkv"]
    m = 8 * 1029
    assert qkv.bytes == 2 * (m * 768 + 768 * 2304 + m * 2304)
    assert flops.bound_s(qkv) == max(2 * m * 768 * 2304 / 989e12, qkv.bytes / 3.35e12)
    dx, dw = qkv.backward()
    assert (dx.M, dx.K, dx.N) == (m, 2304, 768) and (dw.M, dw.K, dw.N) == (768, m, 2304)


def test_extractor_products_by_hand():
    dense, ops = flops.layers(cfg("dinounet_7b"), 512, 512)
    ex = {x.name: x for x in dense if x.name.startswith("extractor.0.")}
    lq, s = 21 * 16 * 16, 32 * 32  # conv queries over three scales; ViT patch tokens
    assert ex["extractor.0.value_proj"].flops == 2 * s * 4096 * 2048
    assert ex["extractor.0.sampling_offsets"].flops == 2 * lq * 4096 * 128
    assert ex["extractor.0.output_proj"].flops == 2 * lq * 2048 * 4096
    assert sum(1 for x in dense if x.name.endswith(".value_proj")) == 6
    assert all(x.trainable for x in ex.values())


def test_train_step_counts_backward_of_trainable_layers_only():
    c = cfg("dinounet_b")
    dense, ops = flops.layers(c, 512, 512, 13)
    fwd = flops.forward_flops(c, 512, 512, 13)
    trainable = (sum(x.flops for x in dense if x.trainable)
                 + sum(x.flops for x in ops if x.trainable))
    stem = next(x.flops for x in ops if x.name == "spm.stem.0")
    assert flops.train_step_flops(c, 512, 512, 13) == pytest.approx(fwd + 2 * trainable - stem)
    assert flops.forward_flops(c, 512, 512, 13) == pytest.approx(13 * flops.forward_flops(
        c, 512, 512))
