"""The JAX loaders' options in the PyTorch port, against the JAX package on
the same files: ``from_diffusers_dir(safety_checker=, strict=)``,
``load_safety_checker(strict=)``, ``load_lgp_torch(compute_dtype=,
strict=)``, ``cast_params(lgp=)``, ``random_init(random_weights=)`` (zero
weights by default) and ``create_anime2sketch(compute_dtype=)``, each with
the JAX package's default. ``strict=False`` loads whatever the modules read
and drops the rest, in both packages; a missing key raises in both. Tiny
configs (the LGP at its published 9320 inputs), CPU.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketch2img_torch.core.convert import clip_text_to_jax, lgp_to_jax, unet_to_jax, vae_to_jax
from sketch2img_torch.core.manifest import ConversionError
from sketch2img_torch.models import anime2sketch as tanime
from sketch2img_torch.models import safety_checker as tsc
from sketch2img_torch.models.clip_text import CLIPTextConfig
from sketch2img_torch.models.clip_vision import CLIPVisionConfig
from sketch2img_torch.models.lgp import LatentEdgePredictor
from sketch2img_torch.models.unet import UNetConfig
from sketch2img_torch.models.vae import VAEConfig
from sketch2img_torch.runtime import SDComponents
from sketch2img_tpu.core.convert import convert_torch_lgp, convert_torch_vae
from sketch2img_tpu.core.manifest import ConversionError as JConversionError
from sketch2img_tpu.models import anime2sketch as janime
from sketch2img_tpu.models import lgp as jlgp
from sketch2img_tpu.models.clip_text import CLIPTextConfig as JCLIPTextConfig
from sketch2img_tpu.models.clip_vision import CLIPVisionConfig as JVisionConfig
from sketch2img_tpu.models.safety_checker import convert_torch_safety_checker
from sketch2img_tpu.models.unet import UNetConfig as JUNetConfig
from sketch2img_tpu.models.vae import VAEConfig as JVAEConfig
from sketch2img_tpu.runtime import SDComponents as JSDComponents

from torch_port_stack import (
    _perturb, dir_component_kw, jax_dir_config_kw, nchw, nhwc, t, write_diffusers_dir,
)
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

# the safety checker's ViT, tiny (the published one is ViT-L/14)
TINY_VIT = dict(image_size=28, patch_size=14, hidden_size=32, num_layers=2, num_heads=4,
                intermediate_size=64)
# an LGP over the SD1.5 taps: the size the manifest holds
LGP_IN = 9320


def _dtype_name(d):
    return str(d).rsplit(".", 1)[-1] if isinstance(d, torch.dtype) else np.dtype(d).name


@pytest.mark.parametrize("port_fn,jax_fn,options", [
    (SDComponents.from_diffusers_dir, JSDComponents.from_diffusers_dir,
     ("safety_checker", "strict")),
    (SDComponents.load_safety_checker, JSDComponents.load_safety_checker, ("strict",)),
    (SDComponents.load_lgp_torch, JSDComponents.load_lgp_torch, ("compute_dtype", "strict")),
    (SDComponents.cast_params, JSDComponents.cast_params, ("lgp",)),
    (SDComponents.random_init, JSDComponents.random_init, ("random_weights",)),
    (tanime.create_anime2sketch, janime.create_anime2sketch, ("compute_dtype",)),
], ids=["from_diffusers_dir", "load_safety_checker", "load_lgp_torch", "cast_params",
        "random_init", "create_anime2sketch"])
def test_option_defaults_match_jax(port_fn, jax_fn, options):
    """Each option exists in the port with the JAX package's default (a
    dtype by its name) and the same keyword-only-ness."""
    port, jax_ = inspect.signature(port_fn).parameters, inspect.signature(jax_fn).parameters
    for name in options:
        p, j = port[name], jax_[name]
        if name == "compute_dtype":
            assert _dtype_name(p.default) == _dtype_name(j.default), name
        else:
            assert p.default == j.default, name
        assert (p.kind == p.KEYWORD_ONLY) == (j.kind == j.KEYWORD_ONLY), name


def _tiny_checker_sd(seed=0):
    torch.manual_seed(seed)
    return _perturb(tsc.SafetyChecker(CLIPVisionConfig(**TINY_VIT), projection_dim=16),
                    seed).state_dict()


def _jax_load(path, **kw):
    return JSDComponents.from_diffusers_dir(str(path), compute_dtype=jnp.float32,
                                            **jax_dir_config_kw(), **kw)


def test_from_diffusers_dir_options_match_jax(tmp_path):
    """The tiny directory with a ``safety_checker/`` that is not the
    published ViT-L/14 one: both packages refuse it by default and skip it
    with ``safety_checker=False``. An extra VAE key fails ``strict`` in both
    and loads with ``strict=False`` into the same weights; a missing key
    fails in both even then (as tests/test_manifests.py has it for JAX)."""
    sds = write_diffusers_dir(tmp_path, seed=1)
    (tmp_path / "safety_checker").mkdir()
    torch.save(_tiny_checker_sd(), str(tmp_path / "safety_checker" / "pytorch_model.bin"))
    kw = dir_component_kw()
    with pytest.raises(ConversionError):
        SDComponents.from_diffusers_dir(str(tmp_path), **kw)
    with pytest.raises(JConversionError):
        _jax_load(tmp_path)
    c = SDComponents.from_diffusers_dir(str(tmp_path), safety_checker=False, **kw)
    assert c.safety_checker is None and _jax_load(tmp_path, safety_checker=False).safety_run is None

    vae_sd = dict(sds["vae/diffusion_pytorch_model"])
    vae_path = str(tmp_path / "vae" / "diffusion_pytorch_model.bin")
    torch.save({**vae_sd, "ema_decay_state": torch.zeros(1)}, vae_path)
    with pytest.raises(RuntimeError, match="ema_decay_state"):
        SDComponents.from_diffusers_dir(str(tmp_path), safety_checker=False, **kw)
    with pytest.raises(JConversionError, match="unconsumed"):
        _jax_load(tmp_path, safety_checker=False)
    c = SDComponents.from_diffusers_dir(str(tmp_path), safety_checker=False, strict=False, **kw)
    j = _jax_load(tmp_path, safety_checker=False, strict=False)
    for k, v in vae_sd.items():
        assert torch.equal(c.vae.state_dict()[k], v), k
    want = convert_torch_vae(vae_sd, jax_dir_config_kw()["vae_config"])
    got = vae_to_jax(c.vae.state_dict(), c.vae.config)
    for a, b in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(j.vae_params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    del vae_sd["decoder.conv_out.weight"]
    torch.save(vae_sd, vae_path)
    with pytest.raises(RuntimeError, match="decoder.conv_out.weight"):
        SDComponents.from_diffusers_dir(str(tmp_path), safety_checker=False, strict=False, **kw)
    with pytest.raises(KeyError):
        _jax_load(tmp_path, safety_checker=False, strict=False)


# the smallest stack the LGP's taps allow: three UNet levels, a two-level
# VAE, one text layer (JAX compiles each distinct parameter shape on its
# first use)
SMALL = dict(unet=dict(block_out_channels=(32, 32, 64), cross_attn=(True, True, False),
                       layers_per_block=1, num_heads=2, cross_attention_dim=32),
             vae=dict(block_out_channels=(32, 64), layers_per_block=1),
             text=dict(vocab_size=100, hidden_size=32, intermediate_size=64, num_layers=1,
                       num_heads=4))


def _small(unet_cls, vae_cls, text_cls):
    return dict(unet_config=unet_cls(**SMALL["unet"]), vae_config=vae_cls(**SMALL["vae"]),
                text_config=text_cls(**SMALL["text"]))


@pytest.fixture(scope="module")
def port_comps():
    """Small port components (zero weights, no LGP) to load into."""
    return SDComponents.random_init(compute_dtype=torch.float32, device="cpu", lgp=False,
                                    **_small(UNetConfig, VAEConfig, CLIPTextConfig))


@pytest.fixture(scope="module")
def jax_comps():
    """JAX components without models: what the loaders fill in."""
    return JSDComponents(unet=None, vae=None, text_encoder=None, unet_params={}, vae_params={},
                         text_params={}, schedule=None)


def test_load_safety_checker_strict_matches_jax(tmp_path, port_comps, jax_comps):
    """An extra key in ``safety_checker/``: ``strict`` (the default) refuses it
    in both packages; ``strict=False`` loads the same weights in both."""
    sd = _tiny_checker_sd(3)
    path = tmp_path / "safety_checker"
    path.mkdir()
    torch.save({**sd, "extra.scale": torch.ones(2)}, str(path / "model.bin"))
    with pytest.raises(RuntimeError, match="extra.scale"):
        port_comps.load_safety_checker(str(path), CLIPVisionConfig(**TINY_VIT))
    with pytest.raises(JConversionError, match="unconsumed"):
        jax_comps.load_safety_checker(str(path), vision_config=JVisionConfig(**TINY_VIT))
    port_comps.load_safety_checker(str(path), CLIPVisionConfig(**TINY_VIT), strict=False)
    jax_comps.load_safety_checker(str(path), vision_config=JVisionConfig(**TINY_VIT),
                                  strict=False)
    got = port_comps.safety_checker.state_dict()
    assert sorted(got) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
    want = convert_torch_safety_checker(sd, num_layers=TINY_VIT["num_layers"])
    for a, b in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(jax_comps.safety_params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    port_comps.safety_checker = None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_lgp_torch_options_match_jax(tmp_path, port_comps, jax_comps, dtype):
    """The published LGP's layout with an extra key: ``strict`` refuses it in
    both packages (the port through its manifest); ``strict=False`` with
    ``compute_dtype`` loads it and both heads agree on the same features, to
    1e-5 of the output's scale in fp32 and 3e-2 in bf16."""
    torch.manual_seed(5)
    sd = _perturb(LatentEdgePredictor(input_dim=LGP_IN), 5).state_dict()
    path = str(tmp_path / "edge_predictor.pt")
    torch.save({**sd, "head.extra": torch.ones(1)}, path)
    with pytest.raises(ConversionError, match="head.extra"):
        port_comps.load_lgp_torch(path)
    with pytest.raises(JConversionError, match="unconsumed"):
        jax_comps.load_lgp_torch(path)
    port_comps.load_lgp_torch(path, compute_dtype=getattr(torch, dtype), strict=False)
    jax_comps.load_lgp_torch(path, compute_dtype=getattr(jnp, dtype), strict=False)
    assert port_comps.lgp.layers[0].weight.dtype == getattr(torch, dtype)
    assert jax_comps.lgp.compute_dtype == getattr(jnp, dtype)

    rng = np.random.RandomState(6)
    x = rng.randn(2, 4, 4, LGP_IN - 40).astype(np.float32)
    nl = rng.uniform(0, 1, (2, 4, 4, 4)).astype(np.float32)
    want = np.asarray(jax.jit(jax_comps.lgp.apply)(jax_comps.lgp_vars, jnp.asarray(x),
                                                   jnp.asarray(nl)), np.float32)
    with torch.no_grad():
        got = nhwc(port_comps.lgp(t(nchw(x)), t(nchw(nl))).float().numpy())
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())
    port_comps.lgp = jax_comps.lgp = jax_comps.lgp_vars = None


@pytest.mark.parametrize("lgp", [False, True])
def test_cast_params_lgp_matches_jax(port_comps, jax_comps, lgp):
    """``cast_params(bf16, lgp=...)``: the LGP's weights and running
    statistics stay fp32 by default and are cast with ``lgp=True``, the
    same values in both packages."""
    torch.manual_seed(7)
    sd = _perturb(LatentEdgePredictor(input_dim=LGP_IN), 7).state_dict()
    port_comps.load_lgp_state(sd)
    params, stats = convert_torch_lgp(sd)
    jax_comps.lgp, jax_comps.lgp_vars = jlgp.LatentEdgePredictor(), {"params": params,
                                                                     "batch_stats": stats}
    try:
        port_comps.cast_params(torch.bfloat16, lgp=lgp)
        jax_comps.cast_params(jnp.bfloat16, lgp=lgp)
        want = jnp.bfloat16 if lgp else jnp.float32
        got = lgp_to_jax({k: v.float() for k, v in port_comps.lgp.state_dict().items()})
        assert port_comps.lgp.layers[0].weight.dtype == (torch.bfloat16 if lgp else torch.float32)
        assert port_comps.lgp.layers[2].running_var.dtype == port_comps.lgp.layers[0].weight.dtype
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(jax_comps.lgp_vars)):
            assert b.dtype == want
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b, np.float32))
    finally:
        port_comps.cast_params(torch.float32)
        port_comps.lgp = jax_comps.lgp = jax_comps.lgp_vars = None


def test_random_init_zero_weights_match_jax():
    """By default ``random_init`` gives zero weights, in the JAX package's
    trees (every UNet, VAE and text leaf, the same shapes; the port's LGP
    too); with ``random_weights=True`` the port's are seeded random ones."""
    kw = dict(compute_dtype=torch.float32, device="cpu")
    port = SDComponents.random_init(**kw, **_small(UNetConfig, VAEConfig, CLIPTextConfig))
    want = JSDComponents.random_init(compute_dtype=jnp.float32,
                                     **_small(JUNetConfig, JVAEConfig, JCLIPTextConfig))
    for got, want in ((unet_to_jax(port.unet.state_dict(), port.unet.config), want.unet_params),
                      (vae_to_jax(port.vae.state_dict(), port.vae.config), want.vae_params),
                      (clip_text_to_jax(port.text_encoder.state_dict(), 1), want.text_params)):
        got_leaves = jax.tree_util.tree_leaves_with_path(got)
        want_leaves = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
        for (path, a), (_, b) in zip(got_leaves, want_leaves):
            assert np.shape(a) == np.shape(b), path
            assert not np.asarray(a).any() and not np.asarray(b).any(), path
    assert not any(p.any() for p in port.lgp.parameters())
    c = SDComponents.random_init(**kw, **_small(UNetConfig, VAEConfig, CLIPTextConfig),
                                 random_weights=True)
    assert all(p.abs().sum() > 0 for p in c.unet.parameters() if p.dim() > 1)


def test_create_anime2sketch_compute_dtype_matches_jax():
    """The generator in bf16 (5 levels, ngf 4): the port's weights and
    arithmetic in bf16 against the JAX generator's bf16 compute on the same
    weights, to 3e-2 of the output's scale; fp32 by default in both."""
    torch.manual_seed(8)
    fp32 = tanime.create_anime2sketch(5, 4)
    assert fp32.dtype == torch.float32
    params = janime.convert_torch_anime2sketch(fp32.state_dict(), num_downs=5)
    port = tanime.create_anime2sketch(5, 4, compute_dtype=torch.bfloat16)
    port.load_state_dict(fp32.state_dict())
    port.eval().requires_grad_(False)
    assert port.dtype == torch.bfloat16
    x = np.random.RandomState(9).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    jmod = janime.UnetGenerator(3, 1, 5, 4, compute_dtype=jnp.bfloat16)
    want = np.asarray(jax.jit(jmod.apply)({"params": params}, jnp.asarray(x)), np.float32)
    with torch.no_grad():
        got = nhwc(port(t(nchw(x))).float().numpy())
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-2 * np.abs(want).max())
