"""The yardstick's counts against hand counts."""

import pytest

from benchmark import counts


def test_vit_b32_forward_is_8_8_gflop():
    # 12 blocks over 50 tokens at width 768: 4 projections 4*50*768^2,
    # attention 2*50^2*768, MLP 2*50*768*3072, all x2 flops; patchify
    # 49 patches x 3072 x 768; head 768 x 512
    block = 2 * (4 * 50 * 768 ** 2 + 2 * 50 ** 2 * 768
                 + 2 * 50 * 768 * 3072)
    hand = 12 * block + 2 * 49 * 3072 * 768 + 2 * 768 * 512
    got = counts.vit_forward_flops(768, 12, 32, 224, 512)
    assert got == hand
    assert got == pytest.approx(8.8e9, rel=0.01)


def test_resnet18_small_stem_at_96px_is_10_gflop():
    def conv(hw, cin, cout, k):
        return 2 * hw * hw * cin * cout * k * k

    hand = conv(96, 3, 64, 3) + 4 * conv(96, 64, 64, 3)
    for hw, cin, cout in ((48, 64, 128), (24, 128, 256), (12, 256, 512)):
        hand += conv(hw, cin, cout, 3) + 3 * conv(hw, cout, cout, 3) \
            + conv(hw, cin, cout, 1)
    hand += 2 * 512 * 128
    total, stem = counts.resnet18_forward_flops(96, 96, 3, 128)
    assert total == hand
    assert stem == conv(96, 3, 64, 3)
    assert total == pytest.approx(10.0e9, rel=0.01)


def test_bince_step_counts_both_views_forward_and_backward():
    enc, stem = counts.resnet18_forward_flops(96, 96, 3, 128)
    got = counts.bince_train_flops(96, 96, 128, 128, 512, 10)
    proj = 2 * (128 * 128 * 2)
    probe = 2 * (128 * 512 + 512 * 10)
    assert got == 2 * (3 * (enc + proj) - stem) + 2 * probe
    assert got == pytest.approx(60e9, rel=0.01)


def test_attention_bounds_are_memory_bound_at_vit_b32():
    B, N, h, d = 512, 50, 12, 64
    k1 = counts.attention_bound_s(B, N, h, d)
    assert k1 == pytest.approx(B * N * 4 * h * d * 2 / 3.35e12)
    k2 = counts.attention_cls_bound_s(B, N, h, d)
    assert k2 == pytest.approx((2 * B * h * d + B * N * 2 * h * d) * 2
                               / 3.35e12)
    assert counts.vit_attention_bound_s(B, 12, N, h, d) == \
        pytest.approx(11 * k1 + k2)


def test_k3_coefficients_and_bounds():
    # (1,3,3,3,1): matrices 3+9+9+3, biases 3+3+3+1, factors 3+3+3
    assert counts.k3_coefficients((3, 3, 3)) == 43
    # one chain: per layer 2*out*in + out (+ 3*out for the tanh stage but
    # in the last): 18 + 30 + 30 + 7
    fwd = counts.k3_forward_bound_s(256, 128, (3, 3, 3))
    assert fwd == pytest.approx(max(256 * 128 * (2 * 85 + 10) / 67e12,
                                    (2 * 256 * 128 * 4 + 128 * 43 * 4)
                                    / 3.35e12))
    assert counts.k3_backward_bound_s(256, 128, (3, 3, 3)) > fwd
