"""The port's safety checker against the JAX package's: its CLIP
preprocessing (the bicubic resize, shortest edge then centre crop) and
``check_images`` on a tiny tower, one image flagged and one not, with the
weights carried by the JAX package's ``convert_torch_safety_checker``.
Also the strict loader and the pipeline's black-out contract.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketch2img_tpu.models import safety_checker as jsc
from sketch2img_tpu.models.clip_vision import CLIPVisionConfig as JVisionConfig
from sketch2img_torch.models import safety_checker as tsc
from sketch2img_torch.models.clip_vision import CLIPVisionConfig

from torch_port_stack import _perturb, nchw, nhwc, t

TINY = dict(image_size=28, patch_size=14, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64)


@pytest.mark.parametrize("shape,size", [((2, 512, 512), 224), ((1, 100, 200), 224),
                                        ((1, 300, 120), 224), ((2, 32, 32), 28)])
def test_preprocess_matches_jax(shape, size):
    """jax.image.resize "bicubic" is Keys a = -0.5, antialiased when
    shrinking; so is PyTorch's antialiased bicubic, to ~1e-6 before the
    CLIP normalisation (1/0.26 amplifies it): 5e-5 absolute. PyTorch's
    plain bicubic (a = -0.75, no antialias) is off by more than 0.05 here,
    which would move every flag near a threshold."""
    b, h, w = shape
    img = np.random.RandomState(0).rand(b, h, w, 3).astype(np.float32)
    want = np.asarray(jsc.preprocess(jnp.asarray(img), size))
    got = nhwc(tsc.preprocess(t(nchw(img)), size).numpy())
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)
    if h == w == 512:  # the decoded image's shape
        naive = torch.nn.functional.interpolate(t(nchw(img)), size=(size, size), mode="bicubic",
                                                align_corners=False)
        pixels = want * np.asarray(jsc.CLIP_IMAGE_STD) + np.asarray(jsc.CLIP_IMAGE_MEAN)
        assert np.abs(nhwc(naive.numpy()).clip(0, 1) - pixels).max() > 0.05


def _pair(seed=0):
    torch.manual_seed(seed)
    port = tsc.SafetyChecker(CLIPVisionConfig(**TINY), projection_dim=16)
    _perturb(port, seed)
    return port


def test_check_images_matches_jax_one_flagged_one_not():
    """Thresholds set between the two images' best concept cosine (a margin
    of over 100x the ~1e-6 fp32 agreement of the scores): the first image flagged
    and blacked out, the second returned as it was, on both sides."""
    port = _pair(1)
    images = np.random.RandomState(2).rand(2, 32, 32, 3).astype(np.float32)
    images[1] = 1.0 - images[1]
    with torch.no_grad():
        pixels = tsc.preprocess(t(nchw(images)), 28)
        cls = port.vision_model(pixels)[:, 0]
        post = port.vision_model.vision_model.post_layernorm
        emb = post(cls) @ port.visual_projection.weight.T
        cos = (torch.nn.functional.normalize(emb, dim=-1)
               @ torch.nn.functional.normalize(port.concept_embeds, dim=-1).T).max(-1).values
    hi, lo = (0, 1) if cos[0] > cos[1] else (1, 0)
    assert float(cos[hi] - cos[lo]) > 2e-4
    with torch.no_grad():
        port.concept_embeds_weights.fill_(float(cos[hi] + cos[lo]) / 2)
        port.special_care_embeds_weights.fill_(10.0)  # never fires
    p = jsc.convert_torch_safety_checker(port.state_dict(), num_layers=2)
    _, run = jsc.make_safety_checker(JVisionConfig(**TINY))
    jb, jf = jax.jit(run)(p, jnp.asarray(images))
    tb, tf = port.check_images(t(nchw(images)))
    assert tf.tolist() == np.asarray(jf).tolist() == [hi == 0, hi == 1]
    np.testing.assert_array_equal(nhwc(tb.numpy()), np.asarray(jb))
    assert np.all(nhwc(tb.numpy())[hi] == 0) and np.all(nhwc(tb.numpy())[lo] == images[lo])


def test_load_safety_checker_strictly_and_pipeline_blacks_out(tmp_path):
    """A diffusers ``safety_checker/`` directory loads strictly (a missing
    key raises); with every concept threshold at -1 each generated image is
    flagged, blacked out and reported in ``last_nsfw_flags``."""
    from sketch2img_torch.models.clip_text import CLIPTextConfig
    from sketch2img_torch.models.unet import UNetConfig
    from sketch2img_torch.models.vae import VAEConfig
    from sketch2img_torch.runtime import SDComponents, SketchGuidedPipeline

    from fakes import FakeTokenizer

    c = SDComponents.random_init(
        seed=0, compute_dtype=torch.float32, device="cpu", lgp=False,
        unet_config=UNetConfig(block_out_channels=(32, 64), cross_attn=(True, False),
                               layers_per_block=1, num_heads=2, cross_attention_dim=32),
        vae_config=VAEConfig(block_out_channels=(32, 64), layers_per_block=1),
        text_config=CLIPTextConfig(vocab_size=100, hidden_size=32, intermediate_size=64,
                                   num_layers=2, num_heads=4))
    c.tokenizer = FakeTokenizer()
    sd = _pair(3).state_dict()
    sd["concept_embeds_weights"] = torch.full((17,), -1.0)
    (tmp_path / "safety_checker").mkdir()
    torch.save(sd, str(tmp_path / "safety_checker" / "pytorch_model.bin"))
    c.load_safety_checker(str(tmp_path / "safety_checker"), CLIPVisionConfig(**TINY))
    assert not any(p.requires_grad for p in c.safety_checker.parameters())
    pipe = SketchGuidedPipeline(c)
    img = pipe(["a", "b"], num_inference_steps=1, width=32, height=32, seed=1)
    assert pipe.last_nsfw_flags.tolist() == [True, True] and np.all(img == 0)
    del sd["visual_projection.weight"]
    torch.save(sd, str(tmp_path / "safety_checker" / "pytorch_model.bin"))
    with pytest.raises(RuntimeError, match="visual_projection"):
        c.load_safety_checker(str(tmp_path / "safety_checker"), CLIPVisionConfig(**TINY))
