"""The port's copies of the training data pipeline against the JAX
package's modules: tag processing, ``ImageStore`` (items, collate, the
latent cache), ``Loader`` (epochs, ``set_epoch``, ``skip_batches``) and
``BucketBatcher``, on one seeded temporary image folder. Both sides are
host code over the same files, so every batch must be identical.
"""

import random

import numpy as np
import pytest
from PIL import Image

from sketch2img_torch.data import arb as tarb
from sketch2img_torch.data import dataset as tds
from sketch2img_torch.data import loader as tloader
from sketch2img_torch.data import tags as ttags
from sketch2img_tpu.data import arb as jarb
from sketch2img_tpu.data import dataset as jds
from sketch2img_tpu.data import loader as jloader
from sketch2img_tpu.data import tags as jtags

from fakes import FakeTokenizer
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Nine images of assorted sizes and aspect ratios with captions, one
    of them tagged to be skipped, in two sub-folders."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(0)
    for i in range(9):
        sub = root / ("a" if i % 2 else "b")
        sub.mkdir(exist_ok=True)
        h, w = (40 + 3 * i, 48) if i % 3 else (36, 70)
        Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(sub / f"im{i}.png")
        (sub / f"im{i}.txt").write_text(
            "comic 1girl" if i == 4 else f"artist:someone 1girl solo tag_{i} flower sky")
    return str(root)


def _stores(folder, **kw):
    args = dict(img_path=[folder], size=32, seed=7, tokenizer=FakeTokenizer(), max_length=20, **kw)
    return tds.ImageStore(**args), jds.ImageStore(**args)


def _same_batch(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k


def test_process_tags_matches_jax():
    """Same tags and RNG seed -> the same caption and skip flag."""
    for i, tags in enumerate(["artist:foo copyright:bar 1girl solo highres flower sky tree",
                              "comic 1girl", " ".join(f"tag{k}" for k in range(90)),
                              "rating:explicit 2girls bad_hands meta:lowres"]):
        got = ttags.process_tags(tags, rng=random.Random(i), important_tags=["solo"])
        want = jtags.process_tags(tags, rng=random.Random(i), important_tags=["solo"])
        assert got == want


@pytest.mark.parametrize("center_crop", [False, True])
def test_imagestore_items_and_collate_match_jax(folder, center_crop):
    """Scan order, skips, random or centre crops (the store's own RNG),
    tokens and the collated batch, with and without uncond dropout."""
    port, jax_ = _stores(folder, center_crop=center_crop, ucg=0.3)
    assert len(port) == len(jax_) == 8
    assert [e[0] for e in port.entries] == [e[0] for e in jax_.entries]
    examples_p = [port[i] for i in range(len(port))]
    examples_j = [jax_[i] for i in range(len(jax_))]
    for pad_to in (None, 20):
        _same_batch(port.collate_fn(examples_p[:4], pad_to=pad_to),
                    jax_.collate_fn(examples_j[:4], pad_to=pad_to))


def test_loader_epochs_and_resume_position_match_jax(folder):
    """Two epochs of shuffled batches, then a loader positioned at epoch 1
    batch 2 (``set_epoch``, ``skip_batches``) -> the same batches as JAX's,
    and the positioned stream equals the tail of the uninterrupted one."""
    def run(mod, ds):
        ld = mod.Loader(ds, 3, seed=5, pad_to=20)
        full = [b for _ in range(2) for b in ld]
        ld = mod.Loader(ds, 3, seed=5, pad_to=20)
        ld.set_epoch(1)
        ld.skip_batches(1)
        return len(ld), full, list(ld)

    port, jax_ = _stores(folder, center_crop=True)
    n_p, full_p, tail_p = run(tloader, port)
    n_j, full_j, tail_j = run(jloader, jax_)
    assert n_p == n_j == 2 and len(full_p) == len(full_j) == 4 and len(tail_p) == 1
    for a, b in zip(full_p + tail_p, full_j + tail_j):
        _same_batch(a, b)
    _same_batch(tail_p[0], full_p[3])


def test_bucket_batcher_matches_jax(folder):
    """Aspect-ratio buckets: the same assignments, the same bucketed batches
    (with set_epoch / skip_batches) and the same bucketed pixels."""
    arb_cfg = {"base_res": (32, 32), "max_size": (48, 32), "divisible": 8, "min_dim": 16,
               "dim_limit": 64}
    port, jax_ = _stores(folder, center_crop=True)
    assert tarb.generate_buckets(**arb_cfg) == jarb.generate_buckets(**arb_cfg)
    ap, aj = port.enable_arb(arb_cfg), jax_.enable_arb(arb_cfg)
    assert ap == aj and len(set(ap.values())) > 1
    bp, bj = tarb.BucketBatcher(ap, 2, seed=3), jarb.BucketBatcher(aj, 2, seed=3)
    assert len(bp) == len(bj)
    for b in (bp, bj):
        b.set_epoch(2)
        b.skip_batches(1)
    got, want = list(bp), list(bj)
    assert got == want and got
    bucket, idxs = got[0]
    _same_batch(port.collate_fn([port.get_bucketed(i, bucket) for i in idxs]),
                jax_.collate_fn([jax_.get_bucketed(i, bucket) for i in idxs]))


def test_cache_latents_batches_match_jax(folder):
    """``cache_latents`` with the same encode and sketch functions: the
    cached items replace the pixels under the given keys, identically."""
    def encode(px):  # (1, H, W, 3) -> (1, 8, 4, 4): a stand-in for the VAE moments
        return np.tile(px[:, ::8, ::8, :].transpose(0, 3, 1, 2), (1, 3, 1, 1))[:, :8]

    def sketch(px):
        return -px.transpose(0, 3, 1, 2)

    port, jax_ = _stores(folder, center_crop=True)
    port.cache_latents(encode, sketch, sketch_key="sketch_clip_pixels")
    jax_.cache_latents(encode, sketch, sketch_key="sketch_clip_pixels")
    got = tloader.Loader(port, 4, seed=1, pad_to=20)
    want = jloader.Loader(jax_, 4, seed=1, pad_to=20)
    batches = list(zip(got, want))
    assert len(batches) == 2
    for a, b in batches:
        assert set(a) == {"input_ids", "latent_dist", "sketch_clip_pixels"}
        _same_batch(a, b)
