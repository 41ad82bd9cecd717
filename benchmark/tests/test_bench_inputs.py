"""Seeded inputs: the same for a seed, different across seeds."""

import numpy as np
import pytest
import torch

from benchmark.harness import inputs, models, weights
from benchmark.tests.tiny import tiny_cell

BIG = 2 ** 31 + 12345  # the driver's seeds can pass 32 signed bits


def test_requests_repeat_for_a_seed_and_differ_across():
    a = inputs.rng_for(BIG, 1, 3)
    b = inputs.rng_for(BIG, 1, 3)
    assert inputs.prompt(a) == inputs.prompt(b)
    assert np.array_equal(inputs.stroke_sketch(a, 64), inputs.stroke_sketch(b, 64))
    c = inputs.rng_for(BIG + 1, 1, 3)
    d = inputs.rng_for(BIG, 1, 4)
    assert inputs.prompt(inputs.rng_for(BIG, 1, 3)) != inputs.prompt(c) or \
        inputs.prompt(inputs.rng_for(BIG, 1, 3)) != inputs.prompt(d)
    assert 0 < inputs.request_seed(inputs.rng_for(BIG, 1, 0)) < 2 ** 31


def test_weights_repeat_for_a_seed_and_differ_across():
    cfg = tiny_cell("sd15-lgp.guided-b1-512-50").config
    a = models.make_weights(cfg, BIG, "unet", "cpu")
    b = models.make_weights(cfg, BIG, "unet", "cpu")
    c = models.make_weights(cfg, BIG + 1, "unet", "cpu")
    key = "conv_in.weight"
    assert torch.equal(a[key], b[key]) and not torch.equal(a[key], c[key])
    assert torch.equal(a["conv_norm_out.weight"], torch.ones_like(a["conv_norm_out.weight"]))


def test_weights_scaled_to_fan_in():
    cfg = tiny_cell("sd15-lgp.guided-b1-512-50").config
    sd = models.make_weights(cfg, 7, "unet", "cpu")
    w = sd["down_blocks.0.resnets.0.conv1.weight"]
    bound = 1 / (w.shape[1] * 9) ** 0.5
    assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
    lgp = models.make_weights(cfg, 7, "lgp", "cpu")
    assert torch.count_nonzero(lgp["layers.0.bias"]) == 0
    assert float(lgp["layers.2.running_var"].min()) == 1.0
    sc = models.make_weights(cfg, 7, "safety_checker", "cpu")
    assert float(sc["concept_embeds_weights"][0]) == pytest.approx(weights.THRESHOLD)


def test_training_images_and_captions(tmp_path):
    paths = inputs.write_dataset(str(tmp_path), 5, 3, 32, "cpu")
    again = inputs.training_images(5, 0, 3, 32, "cpu")
    assert again.shape == (3, 32, 32, 3) and again.dtype == torch.uint8
    assert not torch.equal(again[0], again[1])
    ids = inputs.StandInTokenizer()(open(paths[0][:-4] + ".txt").read(), max_length=225)
    assert len(ids.input_ids) == 225
