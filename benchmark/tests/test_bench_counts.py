"""The yardsticks against hand-worked values at small shapes."""

import pytest
import torch
import torch.nn as nn

from benchmark.counts import flash, flops, groupnorm, peaks
from benchmark.harness import core
from benchmark.reference import models
from benchmark.tests.tiny import tiny_cell


def test_flash_forward_by_hand():
    f, b = flash.work("fwd", 2, 3, 128, 100, 16)
    assert f == 4 * 2 * 3 * 128 * 100 * 16
    assert b == 2 * 3 * ((2 * 128 + 2 * 100) * 16 * 2 + 128 * 4)


def test_flash_backward_by_hand():
    f, b = flash.work("bwd", 1, 8, 4096, 4096, 40)
    assert f == 10 * 8 * 4096 * 4096 * 40
    assert b == 8 * ((4 * 4096 + 4 * 4096) * 40 * 2 + 4096 * 4)


def test_flash_bound_is_the_larger_term_and_has_no_exp_term():
    # (1, 8, 4096, 4096, 40): operations bound it; 21.47 GFLOP at 989 TFLOP/s
    assert flash.bound_s("fwd", 1, 8, 4096, 4096, 40) == pytest.approx(
        4 * 8 * 4096 ** 2 * 40 / 989e12)
    # a tiny head dim with few keys: bytes bound it
    f, b = flash.work("fwd", 64, 8, 256, 8, 8)
    assert flash.bound_s("fwd", 64, 8, 256, 8, 8) == pytest.approx(b / 3.35e12)
    assert f / 989e12 < b / 3.35e12


def test_groupnorm_bound_by_hand():
    # (B, C, H*W, bytes): x in and y out, gamma and beta once a call
    assert groupnorm.bound_s(2, 10, 50, 2) == pytest.approx((2000 + 20) * 2 / 3.35e12)
    assert groupnorm.total_bound_s([(2, 10, 50, 2), (1, 2, 5, 4)]) == pytest.approx(
        (2020 * 2 + 24 * 4) / 3.35e12)


def test_flash_sites_are_the_kernels():
    assert flash.is_site(128, 128, 256, False)
    assert not flash.is_site(128, 128, 256, True)  # a mask: CLIP text's causal one
    assert not flash.is_site(4096, 77, 40, False)  # a short context
    assert not flash.is_site(64, 64, 160, False)  # the UNet's mid block at 8x8
    assert not flash.is_site(4096, 4096, 512, False)  # the VAE's one-head attention


def test_rows_merge_batches_and_heads_and_mismatches_are_named():
    one = flash.rows([("fwd", 2, 8, 256, 256, 40)])
    assert one == flash.rows([("fwd", 1, 8, 256, 256, 40)] * 2) == \
        flash.rows([("fwd", 1, 16, 256, 256, 40)])
    flash.check_calls("flash", one, flash.rows([("fwd", 16, 1, 256, 256, 40)]))
    with pytest.raises(flash.CountMismatch, match="256, 256, 64"):  # a padded head dim
        flash.check_calls("flash", one, flash.rows([("fwd", 2, 8, 256, 256, 64)]))
    assert groupnorm.rows([(2, 32, 64, 2), (1, 32, 64, 2)]) == {(32, 64, 2): 3}


def test_peaks_are_the_data_sheet():
    assert peaks.FLOPS["bfloat16"] == 989e12 and peaks.FLOPS["float32"] == 67e12
    assert peaks.HBM_BYTES == 3.35e12


def test_flop_counter_on_meta_matches_hand_counts():
    lin = nn.Linear(64, 32, device="meta")
    assert flops.count(lambda: lin(torch.empty(5, 64, device="meta"))) == 2 * 5 * 64 * 32
    conv = nn.Conv2d(3, 8, 3, padding=1, device="meta")
    x = torch.empty(2, 3, 10, 10, device="meta")
    assert flops.count(lambda: conv(x)) == 2 * 2 * 8 * 10 * 10 * 3 * 9
    q = torch.empty(1, 256, 64, device="meta")
    # two products per head: 2 * (2 * n * n * d) over 4 heads of 16
    assert flops.count(lambda: models.attention(q, q, q, 4)) == 2 * 2 * 256 * 256 * 64


def test_counter_on_the_tiny_stack():
    c = flops.Counter(tiny_cell("sd15-lgp.guided-b1-512-50").config)
    fwd = c.unet(1, 8, 77).total
    assert fwd > 0 and c.unet(2, 8, 77).total == 2 * fwd
    assert c.unet_taps_grad(1, 8, 77).total > fwd
    lgp_in = c.lgp(1, 8, "input")
    first = c._mod("lgp").layers[0]
    # forward and input backward of the first Linear dominate: 2 x 2 x rows x in x out
    assert lgp_in.total >= 4 * 64 * first.in_features * first.out_features
    assert set(lgp_in.flops) == {"float32"} and not lgp_in.flash and not lgp_in.groupnorm
    both = 2 * c.unet(1, 8, 77) + lgp_in
    assert both.total == 2 * fwd + lgp_in.total
    assert both.groupnorm == 2 * c.unet(1, 8, 77).groupnorm


def test_counter_derives_the_kernel_sites():
    c = flops.Counter(tiny_cell("sd15-lgp.guided-b1-512-50").config)
    # at a 16x16 latent only the first level's self-attentions have 128
    # queries and keys: two transformers down, three up, two heads of 16
    site = (1, 2, 256, 256, 16)
    assert c.unet(1, 16, 77).flash == [("fwd",) + site] * 5
    grad = c.unet_taps_grad(1, 16, 77).flash
    assert grad.count(("fwd",) + site) == 5 and 1 <= grad.count(("bwd",) + site) <= 5
    assert c.unet(1, 16, 231).flash.count(("fwd", 1, 2, 256, 231, 16)) == 5  # long captions
    assert not c.text(1, 77).flash  # a causal mask
    # the VAE's one-head mid attention is a site at 32 wide, not at 512
    assert c.vae_encode(1, 128).flash == [("fwd", 1, 1, 256, 256, 32)]
    real = flops.Counter(core.find_cell("sd15-lgp.guided-b1-512-50").config)
    assert not real.vae_encode(1, 512).flash
    gn = c.vae_encode(1, 128).groupnorm
    assert gn and all(b == 1 and n * c_ > 0 and e == 4 for b, c_, n, e in gn)
