"""The benchmark's arithmetic against numbers worked by hand."""
import pytest

import roofline


@pytest.mark.parametrize("hidden,layers,mlp,gflop", [
    (1024, 24, 4096, 123.1),   # ViT-L/16 at 224
    (768, 12, 3072, 35.1),     # ViT-B/16 at 224
])
def test_vit_forward_flops(hidden, layers, mlp, gflop):
    flops = roofline.vit_forward_flops(hidden, layers, mlp, 224, 16, 120)
    assert flops / 1e9 == pytest.approx(gflop, abs=0.05)


def test_vit_l_forward_flops_by_hand():
    # N 197: per layer 8 N C^2 + 4 N C M + 4 N^2 C, and the 196-patch
    # projection, and the head
    n, c, m = 197, 1024, 4096
    layer = 8 * n * c * c + 4 * n * c * m + 4 * n * n * c
    expect = 24 * layer + 2 * 196 * 768 * c + 2 * c * 120
    assert roofline.vit_forward_flops(c, 24, m, 224, 16, 120) == expect
    assert roofline.train_step_flops(expect) == 3 * expect


@pytest.mark.parametrize("bound,ms", [
    (lambda: roofline.k1_bound_s(64, 197, 1024), 0.0308),
    (lambda: roofline.k2_bound_s(64, 197, 1024), 0.0540),
    (lambda: roofline.k1_bound_s(64, 197, 768), 0.0231),
    (lambda: roofline.k2_bound_s(8, 197, 1024), 0.00674),
])
def test_attention_bounds(bound, ms):
    assert bound() * 1e3 == pytest.approx(ms, abs=5e-5)


def test_bounds_are_bytes_bound_at_n197():
    b, n, c = 64, 197, 1024
    assert roofline.k1_bound_s(b, n, c) == roofline.bytes_bound_s(
        roofline.k1_bytes(b, n, c))
    assert roofline.k2_bound_s(b, n, c) == roofline.bytes_bound_s(
        roofline.k2_bytes(b, n, c))
    assert roofline.k1_bytes(b, n, c) == 4 * b * n * c * 2
    assert roofline.k2_bytes(b, n, c) == 7 * b * n * c * 2
