"""The PyTorch port's user-facing apps against the JAX package's.

- ``app.inference`` against the JAX ``app.inference`` through one recording
  stub pipeline, with a uint8 and a float sketchpad and none;
- ``app.build_pipeline`` and the headless ``app.main --prompt`` on a tiny
  diffusers directory (torch.save ``.bin`` files, tests/torch_port_stack.py);
- ``clip_guided_inf.main`` on that directory;
- ``pic2sketch`` against the JAX ``pic2sketch`` on a tiny generator pair, and
  ``pic2sketch.main``;
- ``evaluation.evaluate`` against the JAX ``evaluate`` with the noise given
  and the posterior mean as the latent (the draw-free mode), on the tiny
  shared-weight pair.

gradio is not installed here: only the headless paths run. fp32, CPU.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from sketch2img_torch.apps import app as tapp
from sketch2img_torch.apps import clip_guided_inf as tclip_inf
from sketch2img_torch.apps import evaluation as teval
from sketch2img_torch.apps import pic2sketch as tpic
from sketch2img_torch.core.convert import injection_to_jax
from sketch2img_torch.core.schedulers import make_schedule
from sketch2img_torch.models import anime2sketch as tanime
from sketch2img_torch.models.clip_vision import CLIPVisionConfig
from sketch2img_torch.runtime import SDComponents
from sketch2img_torch.train.checkpoint import export_params_npz
from sketch2img_tpu.apps import app as japp
from sketch2img_tpu.apps import evaluation as jeval
from sketch2img_tpu.apps import pic2sketch as jpic
from sketch2img_tpu.core.schedulers import make_schedule as j_make_schedule
from sketch2img_tpu.models.anime2sketch import UnetGenerator, convert_torch_anime2sketch
from sketch2img_tpu.runtime import SDComponents as JSDComponents

from fakes import FakeTokenizer
from torch_port_stack import (
    CLIP_KW, VISION_KW, clip_pair, dir_component_kw, dir_lgp, lgp_pair, nhwc, unet_pair,
    vae_pair, write_diffusers_dir,
)
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

PX = 64


class StubPipe:
    """Records its calls; returns a (H, W, 3) image in [0, 1] drawn from
    the seed."""

    def __init__(self):
        self.calls = []

    def __call__(self, prompt, **kw):
        self.calls.append((prompt, kw))
        return np.random.RandomState(kw["seed"]).rand(kw["height"], kw["width"], 3)


@pytest.mark.parametrize("pad", ["uint8", "float", "none"])
def test_inference_matches_jax(pad):
    """The same pipeline call (prompt, negative, steps, guidance, size,
    seed, the sketchpad taken to [0, 1]; strength dropped) and the same
    uint8 image."""
    rng = np.random.RandomState(0)
    spimg = {"uint8": rng.randint(0, 256, (PX, PX), np.uint8),
             "float": rng.rand(PX, PX).astype(np.float32), "none": None}[pad]
    args = ("a cat", 6.5, 3.0, PX, PX, 17, 0.3, "bad", spimg)
    got = {}
    for name, mod in (("jax", japp), ("port", tapp)):
        stub = StubPipe()
        img, err = mod.inference(stub, *args)
        got[name] = (img, err, stub.calls)
    (jimg, jerr, jcalls), (pimg, perr, pcalls) = got["jax"], got["port"]
    np.testing.assert_array_equal(pimg, jimg)
    assert pimg.dtype == np.uint8 and perr is jerr is None
    assert len(pcalls) == len(jcalls) == 1
    (jp, jkw), (pp, pkw) = jcalls[0], pcalls[0]
    assert pp == jp and pkw.keys() == jkw.keys()
    for k in jkw:
        if k == "sketch_image" and jkw[k] is not None:
            np.testing.assert_array_equal(pkw[k], jkw[k])
            assert pkw[k].dtype == np.float32 and pkw[k].max() <= 1.0
        else:
            assert pkw[k] == jkw[k] and type(pkw[k]) is type(jkw[k]), k


@pytest.fixture(scope="module")
def sd_dir(tmp_path_factory):
    """The tiny diffusers directory, an ``edge_predictor.pt`` for it and a
    sketch PNG."""
    root = tmp_path_factory.mktemp("apps")
    sds = write_diffusers_dir(root / "sd", seed=0)
    lgp = dir_lgp(1)
    torch.save(lgp.state_dict(), root / "edge_predictor.pt")
    sketch = np.full((PX, PX), 255, np.uint8)
    sketch[20:44, 30:34] = 0
    Image.fromarray(sketch).save(root / "sketch.png")
    return root, sds, lgp.state_dict()


def test_build_pipeline_and_headless_main(sd_dir, tmp_path, monkeypatch):
    """``build_pipeline`` loads the directory and the LGP strictly;
    ``main --prompt --sketch`` writes the image ``inference`` makes with the
    same arguments; without ``--prompt`` (and no gradio) it exits with a
    usage error."""
    root, sds, lgp_sd = sd_dir
    pipe = tapp.build_pipeline(str(root / "sd"), str(root / "edge_predictor.pt"),
                               **dir_component_kw())
    for k, v in sds["unet/diffusion_pytorch_model"].items():
        assert torch.equal(pipe.c.unet.state_dict()[k], v), k
    for k, v in lgp_sd.items():
        assert torch.equal(pipe.c.lgp.state_dict()[k], v), k
    assert pipe.c.tokenizer is not None
    monkeypatch.setattr(tapp, "build_pipeline",
                        functools.partial(tapp.build_pipeline, **dir_component_kw()))
    out = tmp_path / "out.png"
    argv = ["--model_path", str(root / "sd"), "--lgp_weights", str(root / "edge_predictor.pt")]
    tapp.main(argv + ["--prompt", "a house", "--sketch", str(root / "sketch.png"), "--steps",
                      "2", "--width", str(PX), "--height", str(PX), "--seed", "9",
                      "--output", str(out)])
    got = np.asarray(Image.open(out))
    want, _ = tapp.inference(pipe, "a house", 7.5, 2, PX, PX, 9,
                             spimg=np.asarray(Image.open(root / "sketch.png").convert("L")))
    assert got.shape == (PX, PX, 3)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(SystemExit) as e:
        tapp.main(argv)
    assert e.value.code == 2


def test_clip_guided_inf_main(sd_dir, tmp_path, monkeypatch):
    """``clip_guided_inf.main`` with npz injection weights: the pipeline
    built from the directory holds them; it is called with the command
    line's arguments and the sketch in [0, 1]; the file holds the image it
    returned. (The command line renders at 512^2, as the JAX demo's; the
    recording pipeline renders at 64^2 to keep this test short.)"""
    root, _, _ = sd_dir
    real = SDComponents.from_diffusers_dir.__func__
    monkeypatch.setattr(SDComponents, "from_diffusers_dir", classmethod(
        lambda cls, path, **kw: real(cls, path, **{**kw, **dir_component_kw()})))

    class Recording(tclip_inf.ClipGuidedPipeline):
        def __init__(self, *args, **kw):
            super().__init__(*args, clip_config=CLIPVisionConfig(**VISION_KW), **kw)
            self.calls = []

        def __call__(self, prompt, **kw):
            self.calls.append((prompt, kw))
            self.image = super().__call__(prompt, **{**kw, "width": PX, "height": PX})
            return self.image

    donor = Recording(str(root / "sd"))  # injection blocks of seed 0, moved, saved as an npz
    torch.manual_seed(3)
    with torch.no_grad():
        for p in donor.unet.sat.parameters():
            p.add_(0.1 * torch.randn_like(p))
    export_params_npz(str(tmp_path / "sketch_attn_model.npz"),
                      injection_to_jax(donor.unet.sat.state_dict(), donor.unet.config))
    built = []
    monkeypatch.setattr(tclip_inf, "ClipGuidedPipeline",
                        lambda *a, **kw: built.append(Recording(*a, **kw)) or built[-1])
    out = tmp_path / "out.png"
    tclip_inf.main(["--model_path", str(root / "sd"), "--attn_weights",
                    str(tmp_path / "sketch_attn_model.npz"), "--prompt", "a house", "--sketch",
                    str(root / "sketch.png"), "--steps", "2", "--seed", "4", "--strength", "0.7",
                    "--output", str(out)])
    (pipe,) = built
    for k, v in donor.unet.sat.state_dict().items():
        assert torch.equal(pipe.unet.sat.state_dict()[k], v), k
    sketch = np.asarray(Image.open(root / "sketch.png").convert("L"), np.float32) / 255.0
    ((prompt, kw),) = pipe.calls
    spimg = kw.pop("spimg")
    assert prompt == "a house" and kw == dict(negative_prompt="", num_inference_steps=2,
                                              guidance_scale=7.5, strength=0.7, seed=4)
    np.testing.assert_array_equal(spimg, sketch)
    got = np.asarray(Image.open(out))
    assert got.shape == (PX, PX, 3)
    np.testing.assert_array_equal(got, (pipe.image * 255).astype(np.uint8))


@pytest.fixture(scope="module")
def gan_pair():
    torch.manual_seed(4)
    gan = tanime.create_anime2sketch(5, 4).eval().requires_grad_(False)
    return gan, UnetGenerator(3, 1, 5, 4), convert_torch_anime2sketch(gan.state_dict(), 5)


def test_pic2sketch_matches_jax(gan_pair, tmp_path, monkeypatch):
    """A 70x50 picture at load_size 64 through both: the same size and mode,
    and at most 0.5% of the pixels differ (both binarise at 0.5, so a
    rounding difference flips a pixel near the threshold; the LANCZOS resize
    back spreads a flip to its neighbours). ``main`` writes the same image
    as the library call."""
    gan, jgan, jparams = gan_pair
    rng = np.random.RandomState(5)
    picture = Image.fromarray(rng.randint(0, 256, (50, 70, 3), np.uint8))
    want = jpic.pic2sketch(jax.jit(lambda p, x: jgan.apply({"params": p}, x)), jparams,
                           picture, load_size=PX)
    got = tpic.pic2sketch(gan, picture, load_size=PX)
    assert got.size == want.size == (70, 50) and got.mode == want.mode == "RGB"
    diff = np.asarray(got, np.int16) != np.asarray(want, np.int16)
    assert diff.mean() <= 5e-3, diff.mean()
    assert 0 < np.asarray(got).mean() < 255  # both strokes and paper

    torch.save(gan.state_dict(), tmp_path / "netG.pth")
    picture.save(tmp_path / "picture.png")
    monkeypatch.setattr(tanime, "load_netg", functools.partial(tanime.load_netg, num_downs=5,
                                                                ngf=4, device="cpu"))
    tpic.main(["--weights", str(tmp_path / "netG.pth"), "--input", str(tmp_path / "picture.png"),
               "--output", str(tmp_path / "sketch.png"), "--load_size", str(PX)])
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "sketch.png")),
                                  np.asarray(got))


def test_evaluate_matches_jax():
    """One t=100 pass on a 64x64 picture with the noise given and the VAE
    posterior mean as the latent, through the tiny shared-weight pair
    (fp32). The uint8 edge images agree within one level where both keep a
    pixel; where one keeps it and the other zeroes it, the kept value is
    127, i.e. the pre-threshold value lies within 1e-3 of 0.5 (such pixels
    are left out)."""
    hidden = CLIP_KW["hidden_size"]
    (tu, ju, jup), (tv, jv, jvp), (tt, jt, jtp) = (unet_pair(0, cross_attention_dim=hidden),
                                                   vae_pair(1), clip_pair(2))
    tl, jl, jlv = lgp_pair(3)
    jc = JSDComponents(unet=ju, vae=jv, text_encoder=jt, unet_params=jup, vae_params=jvp,
                       text_params=jtp, schedule=j_make_schedule(), tokenizer=FakeTokenizer(),
                       lgp=jl, lgp_vars=jlv)
    for name in ("unet_apply_taps", "vae_encode_moments", "vae_decode", "lgp_apply"):
        setattr(jc, name, jax.jit(getattr(jc, name)))  # op-by-op dispatch takes 3x as long
    c = SDComponents(unet=tu, vae=tv, text_encoder=tt, schedule=make_schedule(),
                     device=torch.device("cpu"), tokenizer=FakeTokenizer(), lgp=tl)
    rng = np.random.RandomState(6)
    image = rng.rand(PX, PX, 3).astype(np.float32)
    noise = rng.randn(1, 4, PX // 2, PX // 2).astype(np.float32)  # the tiny VAE downsamples 2x
    want = jeval.evaluate(jc, "a girl", "bad", image, 100, noise=nhwc(noise),
                          deterministic_latent=True)
    got = teval.evaluate(c, "a girl", "bad", image, 100, noise=noise, deterministic_latent=True)
    assert got.shape == want.shape == (PX, PX, 3) and got.dtype == np.uint8
    g, w = got.astype(np.int16), want.astype(np.int16)
    both = (g > 0) & (w > 0)
    assert 0 < both.mean() < 1  # edges and background both occur
    assert np.abs(g - w)[both].max() <= 1
    assert set(np.unique(np.concatenate([g[(g > 0) & (w == 0)], w[(w > 0) & (g == 0)]]))) <= {127}
    # seeded draws: the same seed gives the same image
    np.testing.assert_array_equal(teval.evaluate(c, "a girl", "", image, 100, seed=3),
                                  teval.evaluate(c, "a girl", "", image, 100, seed=3))
