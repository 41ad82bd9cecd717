"""anime2sketch and the trainers' sketch making in the PyTorch port against
the JAX package: the generator (5 levels, ngf 4) through the JAX package's
``convert_torch_anime2sketch`` (and back through ``anime2sketch_from_jax``),
``netG.pth`` loading, the bicubic resizes up and down, ``generate_sketch``
and ``sketch_to_clip_pixels``. fp32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketch2img_torch.core.convert import anime2sketch_from_jax
from sketch2img_torch.models.anime2sketch import create_anime2sketch, load_netg
from sketch2img_torch.ops.resize import resize_bicubic
from sketch2img_torch.train.train_attn_inject import sketch_to_clip_pixels
from sketch2img_torch.train.train_lgp import generate_sketch
from sketch2img_tpu.models.anime2sketch import UnetGenerator, convert_torch_anime2sketch
from sketch2img_tpu.train import train_attn_inject as jinject
from sketch2img_tpu.train import train_lgp as jlgp

from torch_port_stack import nchw, nhwc, t
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

DOWNS, NGF = 5, 4


@pytest.fixture(scope="module")
def gan_pair():
    """The port's generator (seeded), the JAX one, its converted params and
    a jitted apply."""
    torch.manual_seed(0)
    port = create_anime2sketch(DOWNS, NGF).eval().requires_grad_(False)
    params = convert_torch_anime2sketch(port.state_dict(), num_downs=DOWNS)
    jmod = UnetGenerator(3, 1, DOWNS, NGF)
    return port, params, jax.jit(lambda p, x: jmod.apply({"params": p}, x))


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-6))


def test_generator_matches_jax_and_weights_round_trip(gan_pair, tmp_path):
    """Output to 1e-5 of its scale; ``anime2sketch_from_jax`` inverts the JAX
    converter exactly; a DataParallel-style ``module.``-prefixed netG.pth
    loads strictly."""
    port, params, apply = gan_pair
    x = np.random.RandomState(1).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        got = port(t(nchw(x))).numpy()
    assert got.shape == (2, 1, 64, 64)
    _close(nhwc(got), apply(params, jnp.asarray(x)), 1e-5)

    back = anime2sketch_from_jax(params, num_downs=DOWNS)
    sd = port.state_dict()
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    path = tmp_path / "netG.pth"
    torch.save({"module." + k: v for k, v in sd.items()}, path)
    loaded = load_netg(str(path), DOWNS, NGF, device="cpu")
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("size_in,size_out", [(32, 64), (64, 24), (20, 224)])
def test_resize_bicubic_matches_jax_cubic(size_in, size_out):
    """jax.image.resize(method="cubic") up and down (antialiased when
    shrinking) against the port's resize_bicubic, to 1e-5 of the scale."""
    x = np.random.RandomState(size_in).randn(2, size_in, size_in, 3).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, size_out, size_out, 3), method="cubic")
    got = resize_bicubic(t(nchw(x)), size_out, size_out).numpy()
    _close(nhwc(got), want, 1e-5)


@pytest.mark.parametrize("binarize", [True, False])
def test_generate_sketch_matches_jax(gan_pair, binarize):
    """32^2 images up to 64^2, the generator, invert, (threshold,) tile,
    back down: to 1e-4 of the scale (with the threshold, no pixel of this
    input lies within the models' disagreement of 0.5)."""
    port, params, apply = gan_pair
    px = np.random.RandomState(2).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    want = jlgp.generate_sketch(apply, params, jnp.asarray(px), fixed=64, binarize=binarize)
    with torch.no_grad():
        got = generate_sketch(port, t(nchw(px)), fixed=64, binarize=binarize).numpy()
    _close(nhwc(got), want, 1e-4)


def test_sketch_to_clip_pixels_matches_jax(gan_pair):
    """No binarisation, clip to [0, 1], bicubic to the CLIP size (upscaling
    here), CLIP mean/std: to 1e-4 of the scale."""
    port, params, apply = gan_pair
    px = np.random.RandomState(3).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    want = jinject.sketch_to_clip_pixels(apply, params, jnp.asarray(px), sketch_fixed_size=32,
                                         clip_image_size=48)
    with torch.no_grad():
        got = sketch_to_clip_pixels(port, t(nchw(px)), sketch_fixed_size=32,
                                    clip_image_size=48).numpy()
    _close(nhwc(got), want, 1e-4)
