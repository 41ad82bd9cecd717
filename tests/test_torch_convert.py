"""Weights carried across: JAX parameter trees -> the port's state dicts.

Round trip: a diffusers-named torch state dict (tests/torch_sd_mirror.py, or
the port's own modules for CLIP text and the LGP) -> the JAX package's
torch -> Flax converter -> the port's ``*_from_jax`` must give back the
original state dict exactly, and it must load strictly into the port's
module. Also the strict diffusers-directory loader.
"""

import os

import numpy as np
import pytest
import torch

from sketch2img_tpu.core.convert import (
    convert_torch_clip_text,
    convert_torch_lgp,
    convert_torch_unet,
    convert_torch_vae,
)
from sketch2img_tpu.core.export import convert_torch_sat
from sketch2img_tpu.models.clip_vision import convert_torch_clip_vision
from sketch2img_tpu.models.safety_checker import convert_torch_safety_checker
from sketch2img_tpu.models.unet import UNetConfig as JUNetConfig
from sketch2img_tpu.models.vae import VAEConfig as JVAEConfig
from sketch2img_torch.core.convert import (
    clip_text_from_jax,
    clip_vision_from_jax,
    injection_from_jax,
    lgp_from_jax,
    load_params_npz,
    safety_checker_from_jax,
    unet_from_jax,
    vae_from_jax,
)
from sketch2img_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionEncoder
from sketch2img_torch.models.safety_checker import SafetyChecker
from sketch2img_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from sketch2img_torch.models.lgp import LatentEdgePredictor
from sketch2img_torch.models.unet import UNet2DCondition, UNetConfig
from sketch2img_torch.models.vae import AutoencoderKL, VAEConfig

from torch_sd_mirror import TorchMiniUNet, TorchMiniVAE

UNET_KW = dict(block_out_channels=(32, 64), cross_attn=(True, False), num_heads=2,
               cross_attention_dim=24)
CLIP_KW = dict(vocab_size=100, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4)


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k


def _mirror_unet():
    torch.manual_seed(0)
    return TorchMiniUNet(block_out=(32, 64), cross=(True, False), context_dim=24, heads=2)


def _mirror_vae():
    torch.manual_seed(1)
    return TorchMiniVAE(block_out=(32, 64))


def test_unet_round_trip_is_exact_and_loads_strictly():
    sd = _mirror_unet().state_dict()
    back = unet_from_jax(convert_torch_unet(sd, JUNetConfig(**UNET_KW)), UNetConfig(**UNET_KW))
    _assert_same(back, sd)
    UNet2DCondition(UNetConfig(**UNET_KW)).load_state_dict(back, strict=True)


def test_vae_round_trip_is_exact_and_loads_strictly():
    sd = _mirror_vae().state_dict()
    cfg = dict(block_out_channels=(32, 64))
    back = vae_from_jax(convert_torch_vae(sd, JVAEConfig(**cfg)), VAEConfig(**cfg))
    _assert_same(back, sd)
    AutoencoderKL(VAEConfig(**cfg)).load_state_dict(back, strict=True)


def test_clip_text_round_trip_is_exact():
    torch.manual_seed(2)
    sd = CLIPTextEncoder(CLIPTextConfig(**CLIP_KW)).state_dict()
    back = clip_text_from_jax(convert_torch_clip_text(sd, num_layers=2), num_layers=2)
    _assert_same(back, sd)


def test_lgp_round_trip_is_exact():
    torch.manual_seed(3)
    m = LatentEdgePredictor(input_dim=40)
    with torch.no_grad():
        for bn in m.layers[2::3]:
            bn.running_mean.uniform_(-1, 1)
            bn.running_var.uniform_(0.5, 2)
    sd = m.state_dict()
    back = lgp_from_jax(*convert_torch_lgp(sd))
    _assert_same(back, sd)


VISION_KW = dict(image_size=28, patch_size=14, hidden_size=32, num_layers=2, num_heads=4,
                 intermediate_size=64)


def test_clip_vision_round_trip_is_exact():
    """The JAX tree has no post_layernorm: it comes back as the identity,
    which is what a fresh module holds."""
    torch.manual_seed(5)
    sd = CLIPVisionEncoder(CLIPVisionConfig(**VISION_KW)).state_dict()
    back = clip_vision_from_jax(convert_torch_clip_vision(sd, num_layers=2), num_layers=2)
    _assert_same(back, sd)


@pytest.mark.parametrize("variant", ["clip", "sketch"])
def test_injection_round_trip_is_exact_and_loads_strictly(variant, tmp_path):
    """``unet.sat`` state dict (the sketch_attn_model.pt layout) -> JAX
    ``convert_torch_sat`` -> ``injection_from_jax``; also through the JAX
    package's npz export format."""
    kw = dict(UNET_KW, injection=variant, injection_context_dim=16)
    torch.manual_seed(6)
    unet = UNet2DCondition(UNetConfig(**kw))
    sd = unet.sat.state_dict()
    assert "sketch_attn_down_blocks_0_attentions_0_transformer_blocks_0.sketch_norm.weight" in sd
    assert any(k.endswith("sketch_proj.weight") for k in sd) == (variant == "clip")
    tree = convert_torch_sat(sd, JUNetConfig(**kw))
    back = injection_from_jax(tree, UNetConfig(**kw))
    _assert_same(back, sd)
    unet.sat.load_state_dict(back, strict=True)

    def flat(node, path=()):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from flat(v, path + (k,))
            else:
                yield "/".join(path + (k,)), np.asarray(v)

    np.savez(tmp_path / "inj.npz", **dict(flat(tree)))
    _assert_same(injection_from_jax(load_params_npz(str(tmp_path / "inj.npz")),
                                    UNetConfig(**kw)), sd)


def test_safety_checker_round_trip_is_exact():
    torch.manual_seed(7)
    sd = SafetyChecker(CLIPVisionConfig(**VISION_KW), projection_dim=16).state_dict()
    back = safety_checker_from_jax(convert_torch_safety_checker(sd, num_layers=2),
                                   num_layers=2)
    _assert_same(back, sd)


def test_from_diffusers_dir_loads_strictly(tmp_path):
    """A diffusers-layout directory — newer VAE attention names
    (to_q/to_k/to_v/to_out.0) and an old transformers ``position_ids``
    buffer included — loads with strict state dicts; a missing key raises."""
    from sketch2img_torch.runtime import SDComponents

    unet_sd = _mirror_unet().state_dict()
    vae_sd = _mirror_vae().state_dict()
    renamed = {}
    for k, v in vae_sd.items():
        for old, new in (("query", "to_q"), ("key", "to_k"), ("value", "to_v"),
                         ("proj_attn", "to_out.0")):
            k = k.replace(f"attentions.0.{old}.", f"attentions.0.{new}.")
        renamed[k] = v
    torch.manual_seed(4)
    text_sd = CLIPTextEncoder(CLIPTextConfig(**CLIP_KW)).state_dict()
    text_sd["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    for sub, sd in (("unet/diffusion_pytorch_model", unet_sd),
                    ("vae/diffusion_pytorch_model", renamed),
                    ("text_encoder/model", text_sd)):
        os.makedirs(tmp_path / os.path.dirname(sub), exist_ok=True)
        torch.save(sd, str(tmp_path / sub) + ".bin")

    kw = dict(compute_dtype=torch.float32, device="cpu", unet_config=UNetConfig(**UNET_KW),
              vae_config=VAEConfig(block_out_channels=(32, 64)),
              text_config=CLIPTextConfig(**CLIP_KW))
    c = SDComponents.from_diffusers_dir(str(tmp_path), **kw)
    _assert_same(c.unet.state_dict(), unet_sd)
    _assert_same(c.vae.state_dict(), vae_sd)
    assert not any(p.requires_grad for p in c.unet.parameters())
    np.testing.assert_array_equal(
        c.text_encoder.text_model.final_layer_norm.weight.numpy(),
        text_sd["text_model.final_layer_norm.weight"].numpy())

    del unet_sd["conv_out.bias"]
    torch.save(unet_sd, str(tmp_path / "unet/diffusion_pytorch_model") + ".bin")
    with pytest.raises(RuntimeError, match="conv_out.bias"):
        SDComponents.from_diffusers_dir(str(tmp_path), **kw)
