"""Checkpoint key inventories of the PyTorch port (``core/manifest.py``).

The port's manifests are byte-identical copies of the JAX package's; the
full-width port modules, built on the meta device (no memory), have exactly
their keys and shapes (the only full-width check of the loaders the CPU
can make); and a loader handed a drifted full-size checkpoint raises
``ConversionError`` listing every missing and every unexpected key, before
``load_state_dict`` runs. The full-size checkpoints are meta tensors made
from the manifests.
"""

import dataclasses
import os

import pytest
import torch

from sketch2img_torch.core import manifest
from sketch2img_torch.models.anime2sketch import create_anime2sketch
from sketch2img_torch.models.clip_text import SD15_TEXT_CONFIG, CLIPTextEncoder
from sketch2img_torch.models.clip_vision import VIT_L14_CONFIG, CLIPVisionEncoder
from sketch2img_torch.models.lgp import LatentEdgePredictor
from sketch2img_torch.models.safety_checker import SafetyChecker
from sketch2img_torch.models.unet import SD15_CONFIG, UNet2DCondition, make_sat
from sketch2img_torch.models.vae import SD15_VAE_CONFIG, AutoencoderKL
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

JAX_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "sketch2img_tpu", "assets", "manifests")
NAMES = sorted(f[:-5] for f in os.listdir(JAX_DIR) if f.endswith(".json"))

MODULES = {
    "unet_sd15": lambda: UNet2DCondition(SD15_CONFIG),
    "vae_sd15": lambda: AutoencoderKL(SD15_VAE_CONFIG),
    "text_encoder_sd15": lambda: CLIPTextEncoder(SD15_TEXT_CONFIG),
    "clip_vision_l14": lambda: CLIPVisionEncoder(VIT_L14_CONFIG),
    "safety_checker_sd15": lambda: SafetyChecker(VIT_L14_CONFIG),
    "edge_predictor": lambda: LatentEdgePredictor(),
    "netG": lambda: create_anime2sketch(),
    "sat_sd15": lambda: make_sat(dataclasses.replace(SD15_CONFIG, injection="clip")),
}


def test_every_manifest_has_a_module():
    assert len(NAMES) == 8 and sorted(MODULES) == NAMES
    assert sorted(f[:-5] for f in os.listdir(manifest.MANIFEST_DIR)) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_manifest_copies_are_byte_identical(name):
    with open(os.path.join(JAX_DIR, name + ".json"), "rb") as a, \
            open(manifest.manifest_path(name), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", NAMES)
def test_full_width_modules_have_the_manifest_keys_and_shapes(name):
    """Equal key sets up to ``DEFAULT_IGNORE`` (old transformers'
    ``position_ids``) and netG's DataParallel ``module.``; equal shapes;
    ``check_state_dict`` passes the module's own state dict."""
    with torch.device("meta"):
        module = MODULES[name]()
    sd = module.state_dict()
    prefix = "module." if name == "netG" else ""
    want = {k[len(prefix):]: v for k, v in manifest.load_manifest(name).items()}
    missing, unexpected = manifest.diff_keys(want, sd)
    assert missing == [] and unexpected == []
    assert all(list(sd[k].shape) == want[k] for k in sd)
    manifest.check_state_dict(name, sd, strip_prefix=prefix)


def _doctored(name):
    sd = manifest.zeros_state_dict(manifest.load_manifest(name))
    first = sorted(sd)[0]
    sd["renamed." + first] = sd.pop(first)
    sd["extra.weight"] = torch.zeros(3, device="meta")
    return sd, first


def test_check_lists_what_is_missing_and_unexpected():
    sd, gone = _doctored("unet_sd15")
    with pytest.raises(manifest.ConversionError) as e:
        manifest.check_state_dict("unet_sd15", sd, what="unet")
    msg = str(e.value)
    assert "1 missing key(s)" in msg and gone in msg
    assert "2 unexpected key(s)" in msg and "extra.weight" in msg and "renamed." + gone in msg
    sd = manifest.zeros_state_dict(manifest.load_manifest("edge_predictor"))
    sd["layers.0.weight"] = torch.zeros(512, 9321, device="meta")
    with pytest.raises(manifest.ConversionError, match="another shape"):
        manifest.check_state_dict("edge_predictor", sd)
    # BatchNorm's counters and position_ids may be absent or present
    sd = manifest.zeros_state_dict(manifest.load_manifest("edge_predictor"))
    del sd["layers.2.num_batches_tracked"]
    manifest.check_state_dict("edge_predictor", sd)


@pytest.mark.parametrize("loader", ["from_diffusers_dir", "load_lgp_torch", "load_safety_checker",
                                    "load_netg", "load_attn_weights"])
def test_full_size_loads_check_the_manifest(monkeypatch, tmp_path, loader):
    """Each full-size load raises ``ConversionError`` on a drifted
    checkpoint before ``load_state_dict``."""
    from sketch2img_torch import runtime
    from sketch2img_torch.apps import clip_guided_inf
    from sketch2img_torch.models import anime2sketch

    name = {"from_diffusers_dir": "unet_sd15", "load_lgp_torch": "edge_predictor",
            "load_safety_checker": "safety_checker_sd15", "load_netg": "netG",
            "load_attn_weights": "sat_sd15"}[loader]
    sd, _ = _doctored(name)
    monkeypatch.setattr(torch, "load", lambda *a, **kw: dict(sd))
    monkeypatch.setattr(runtime, "_load_state_dict", lambda base: dict(sd))
    with pytest.raises(manifest.ConversionError, match=name):
        if loader == "from_diffusers_dir":
            runtime.SDComponents.from_diffusers_dir(str(tmp_path), device="cpu")
        elif loader == "load_netg":
            anime2sketch.load_netg("netG.pth", device="cpu")
        elif loader == "load_attn_weights":
            cfg = dataclasses.replace(SD15_CONFIG, injection="clip")
            clip_guided_inf.load_attn_weights("sketch_attn_model.pt", cfg)
        else:
            c = runtime.SDComponents(unet=None, vae=None, text_encoder=None, schedule=None,
                                     device=torch.device("cpu"))
            getattr(c, loader)(str(tmp_path))


def test_manifests_are_package_data():
    import tomllib

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]["sketch2img_torch"]
    assert "assets/manifests/*.json" in data
