"""Seed repeatability of the PyTorch port: the same call with the same seed
gives the same bits, as in the JAX package (tests/test_runtime.py's
``test_seed_determinism``).

On the card every entry point applies ``utils.device.set_deterministic``
(cuDNN's deterministic algorithms) before it puts anything on the device;
on the CPU it leaves PyTorch's flags alone. The CPU tests record the calls:
with a CUDA device (``torch.cuda.is_available`` patched) the recorder stops
the entry point there; with the CPU the entry point runs through and the
flags keep the values the test set. (The bilinear resize's backward, which
replaces PyTorch's atomic-add CUDA one, is held to the JAX package in
tests/test_torch_models.py.) A last test, marked ``cuda``, runs a tiny
guided pass twice on the card and gets the same eps and gradient, bit for
bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sketch2img_torch import runtime
from sketch2img_torch.apps import app, clip_guided_inf, evaluation, serve
from sketch2img_torch.apps import train_attn_inject as app_inject
from sketch2img_torch.apps import train_lgp as app_lgp
from sketch2img_torch.apps.clip_guided_inf import ClipGuidedPipeline
from sketch2img_torch.models import anime2sketch
from sketch2img_torch.models.clip_text import CLIPTextConfig
from sketch2img_torch.models.clip_vision import CLIPVisionConfig
from sketch2img_torch.models.unet import UNetConfig
from sketch2img_torch.models.vae import VAEConfig
from sketch2img_torch.parallel import mesh
from sketch2img_torch.runtime import SDComponents, SketchGuidedPipeline
from sketch2img_torch.train import loop
from sketch2img_torch.utils import device as device_mod

from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

# tests/torch_port_stack.py's UNet (its 16^2 level's self-attention a flash
# site), not imported from there: that module imports the JAX package's
# Flax models, and the card-only test below must collect without flax
TINY = dict(compute_dtype=torch.float32,
            unet_config=UNetConfig(block_out_channels=(32, 32, 64),
                                   cross_attn=(True, True, False), layers_per_block=1,
                                   num_heads=2, cross_attention_dim=32),
            vae_config=VAEConfig(block_out_channels=(32, 64), layers_per_block=1),
            text_config=CLIPTextConfig(vocab_size=100, hidden_size=32, intermediate_size=64,
                                       num_layers=1, num_heads=4))
TINY_VIT = CLIPVisionConfig(image_size=28, patch_size=14, hidden_size=32, num_layers=1,
                            num_heads=4, intermediate_size=64)
# every module that calls set_deterministic by its own name
CALLERS = (device_mod, runtime, clip_guided_inf, loop, mesh)


class Applied(Exception):
    """The recorder's stop: the entry point applied the setting to this device."""

    def __init__(self, device):
        super().__init__(str(device))
        self.device = torch.device(device)


@pytest.fixture
def flags(monkeypatch):
    """cuDNN's flags at values the setting would change, restored after."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)


@pytest.mark.parametrize("device,applies", [("cuda", True), ("cpu", False)])
def test_set_deterministic_on_cuda_only(flags, device, applies):
    device_mod.set_deterministic(device)
    assert torch.backends.cudnn.deterministic is applies
    assert torch.backends.cudnn.benchmark is not applies


@pytest.fixture(scope="module")
def cpu_comps():
    return SDComponents.random_init(**TINY, random_weights=True, device="cpu")


def _cuda(comps):
    return dataclasses.replace(comps, device=torch.device("cuda", 0))


def _native_dir(comps, path):
    comps.save_native(path)
    return path


def _netg(path):
    torch.save(anime2sketch.create_anime2sketch(5, 4).state_dict(), path + "/netG.pth")
    return path + "/netG.pth"


# name: (the call with a CUDA device, the call on the CPU where it runs here
# at the tiny size); each takes the tiny CPU components and a directory
ENTRY_POINTS = {
    "random_init": (lambda c, p: SDComponents.random_init(device="cuda"),
                    lambda c, p: SDComponents.random_init(**TINY, device="cpu")),
    "from_diffusers_dir": (lambda c, p: SDComponents.from_diffusers_dir(p, device="cuda"),
                           None),
    "from_native": (lambda c, p: SDComponents.from_native(p, device="cuda"),
                    lambda c, p: SDComponents.from_native(_native_dir(c, p), **TINY,
                                                          device="cpu")),
    "SketchGuidedPipeline": (lambda c, p: SketchGuidedPipeline(_cuda(c)),
                             lambda c, p: SketchGuidedPipeline(c)),
    "ClipGuidedPipeline": (lambda c, p: ClipGuidedPipeline(components=_cuda(c)),
                           lambda c, p: ClipGuidedPipeline(components=c, clip_config=TINY_VIT)),
    "evaluate": (lambda c, p: evaluation.evaluate(_cuda(c), "a", "", np.zeros((64, 64, 3)), 100),
                 None),
    # the trainers resolve their device through loop.components_device first
    "train_lgp": (lambda c, p: app_lgp.train_lgp({}, _cuda(c), None),
                  lambda c, p: loop.components_device(c, "cpu")),
    "train_attn_inject": (lambda c, p: app_inject.train_attn_inject({}, _cuda(c), None), None),
    "initialize_distributed": (lambda c, p: mesh.initialize_distributed(
        "cuda", init_method="file://" + p + "/rdzv", rank=0, world_size=1), None),
    "load_netg": (lambda c, p: anime2sketch.load_netg(p + "/netG.pth", device="cuda"),
                  lambda c, p: anime2sketch.load_netg(_netg(p), 5, 4, device="cpu")),
    "serve.main": (lambda c, p: serve.main(["--model_path", p, "--lgp_path", p + "/lgp.pt"]),
                   None),
    "app.main": (lambda c, p: app.main(["--model_path", p, "--prompt", "a"]), None),
    "evaluation.main": (lambda c, p: evaluation.main(["--model_path", p,
                                                      "--input", p + "/x.png"]), None),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_applies_setting_on_cuda_only(monkeypatch, flags, cpu_comps, tmp_path,
                                                  name):
    """On the CPU (where the entry point runs here) it runs through and
    cuDNN's flags keep the values the test set; with a CUDA device it calls
    ``set_deterministic`` with it before it loads or allocates anything
    (the recorder stops it there)."""
    on_cuda, on_cpu = ENTRY_POINTS[name]
    if on_cpu is not None:
        on_cpu(cpu_comps, str(tmp_path))
        assert torch.backends.cudnn.deterministic is False
        assert torch.backends.cudnn.benchmark is True

    def recorder(dev):
        raise Applied(dev)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for module in CALLERS:
        monkeypatch.setattr(module, "set_deterministic", recorder)
    with pytest.raises(Applied) as stop:
        on_cuda(cpu_comps, str(tmp_path))
    assert stop.value.device.type == "cuda"


@pytest.mark.cuda
def test_guided_pass_twice_is_bit_identical_on_card():
    """A tiny guided pass (UNet with taps, fused LGP head, the latent's
    gradient; the flash and GroupNorm kernels on their sites) run twice on
    the same inputs: eps and the gradient equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `pytest -m cuda tests/test_torch_determinism.py` "
                    "on a machine with one")
    from sketch2img_torch.core.schedulers import get_noise_level
    from sketch2img_torch.models.lgp import lgp_fused_apply

    c = SDComponents.random_init(**dict(TINY, compute_dtype=torch.bfloat16),
                                 random_weights=True, device="cuda")
    assert torch.backends.cudnn.deterministic
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(2, 4, 16, 16, generator=gen, device="cuda")
    target = 0.2 * torch.randn(2, 4, 16, 16, generator=gen, device="cuda")
    ctx = torch.randn(2, 77, 32, generator=gen, device="cuda", dtype=torch.bfloat16)
    t = torch.tensor([801, 301], device="cuda")

    def guided_pass():
        xc = x.detach().requires_grad_(True)
        eps, taps = c.unet(xc, t, ctx, capture_taps=True)
        out = lgp_fused_apply(c.lgp, taps, get_noise_level(c.schedule, x, t), 16, 16)
        (g,) = torch.autograd.grad(torch.mean((target - out.float()) ** 2), xc)
        return eps.detach(), g

    (e1, g1), (e2, g2) = guided_pass(), guided_pass()
    assert torch.isfinite(g1).all() and g1.abs().max() > 0
    assert torch.equal(e1, e2) and torch.equal(g1, g2)
