"""Native npz checkpoints between the PyTorch port and the JAX package.

A directory written by the port's ``SDComponents.save_native`` loads in the
JAX package's ``SDComponents.from_native`` with exactly the trees the JAX
package's own torch -> Flax converters make from the same weights (the key
sets equal, every leaf equal in float32), and a directory written by the JAX
package's ``save_native`` loads in the port's ``from_native`` with the
original state dicts. ``apps/convert_checkpoint.main`` (with an
``edge_predictor.pt`` and a ``netG.pth``) writes what the JAX package's
``from_native`` and ``load_params_npz`` read. (The trainers' npz exports are
held to the JAX trees in tests/test_torch_train.py, beside their runs.)
Tiny configs, fp32, CPU.
"""

import jax.numpy as jnp
import numpy as np
import torch

from sketch2img_torch.apps import convert_checkpoint
from sketch2img_torch.models.anime2sketch import create_anime2sketch
from sketch2img_torch.runtime import SDComponents
from sketch2img_tpu.core.convert import (
    convert_torch_clip_text,
    convert_torch_lgp,
    convert_torch_unet,
    convert_torch_vae,
)
from sketch2img_tpu.core.schedulers import make_schedule as j_make_schedule
from sketch2img_tpu.models.anime2sketch import convert_torch_anime2sketch
from sketch2img_tpu.models.clip_text import CLIPTextEncoder as JCLIPTextEncoder
from sketch2img_tpu.models.lgp import LatentEdgePredictor as JLatentEdgePredictor
from sketch2img_tpu.models.unet import UNet2DCondition as JUNet
from sketch2img_tpu.models.vae import AutoencoderKL as JAutoencoderKL
from sketch2img_tpu.runtime import SDComponents as JSDComponents
from sketch2img_tpu.train.checkpoint import load_params_npz as j_load_params_npz

from torch_port_stack import (
    DIR_CLIP_KW, dir_component_kw, dir_lgp, jax_dir_config_kw, write_diffusers_dir,
)
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _same_tree(got, want):
    """Equal key paths, and every leaf float32 and equal to the want's."""
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v.astype(np.float32), err_msg=k)


def _same_sd(got, want, skip=()):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k not in skip:
            assert torch.equal(got[k], v), k


def _jax_trees(sds, lgp_sd):
    """What the JAX package's converters make of the directory's weights."""
    cfg = jax_dir_config_kw()
    params, stats = convert_torch_lgp(lgp_sd)
    return {"unet": convert_torch_unet(sds["unet/diffusion_pytorch_model"], cfg["unet_config"]),
            "vae": convert_torch_vae(sds["vae/diffusion_pytorch_model"], cfg["vae_config"]),
            "text": convert_torch_clip_text(sds["text_encoder/model"],
                                            num_layers=DIR_CLIP_KW["num_layers"]),
            "lgp": {"params": params, "batch_stats": stats}}


def _jax_from_native(path):
    return JSDComponents.from_native(str(path), compute_dtype=jnp.float32, **jax_dir_config_kw())


def _check_jax_loaded(j, trees):
    _same_tree(j.unet_params, trees["unet"])
    _same_tree(j.vae_params, trees["vae"])
    _same_tree(j.text_params, trees["text"])
    _same_tree(j.lgp_vars, trees["lgp"])


def test_port_save_native_loads_in_jax(tmp_path):
    """Port ``save_native`` -> JAX ``from_native``: unet.npz, vae.npz,
    text.npz and lgp.npz hold the JAX converters' trees of the port's
    weights."""
    sds = write_diffusers_dir(tmp_path / "sd", seed=1)
    c = SDComponents.from_diffusers_dir(str(tmp_path / "sd"), **dir_component_kw())
    lgp = dir_lgp(2)
    c.load_lgp_state(lgp.state_dict())
    c.save_native(str(tmp_path / "native"))
    assert sorted(p.name for p in (tmp_path / "native").iterdir()) == [
        "lgp.npz", "text.npz", "unet.npz", "vae.npz"]
    _check_jax_loaded(_jax_from_native(tmp_path / "native"), _jax_trees(sds, lgp.state_dict()))


def test_jax_save_native_loads_in_port(tmp_path):
    """JAX ``save_native`` (its trees converted from diffusers-named state
    dicts) -> port ``from_native``: the modules hold those state dicts
    exactly (the LGP's ``num_batches_tracked`` is not in the JAX tree: 0)."""
    sds = write_diffusers_dir(tmp_path / "sd", seed=3)
    lgp_sd = dir_lgp(4).state_dict()
    trees = _jax_trees(sds, lgp_sd)
    cfg = jax_dir_config_kw()
    j = JSDComponents(unet=JUNet(cfg["unet_config"]), vae=JAutoencoderKL(cfg["vae_config"]),
                      text_encoder=JCLIPTextEncoder(cfg["text_config"]),
                      unet_params=trees["unet"], vae_params=trees["vae"],
                      text_params=trees["text"], schedule=j_make_schedule(),
                      lgp=JLatentEdgePredictor(), lgp_vars=trees["lgp"])
    j.save_native(str(tmp_path / "native"))
    c = SDComponents.from_native(str(tmp_path / "native"), **dir_component_kw())
    _same_sd(c.unet.state_dict(), sds["unet/diffusion_pytorch_model"])
    _same_sd(c.vae.state_dict(), sds["vae/diffusion_pytorch_model"])
    _same_sd(c.text_encoder.state_dict(), sds["text_encoder/model"])
    tracked = [k for k in lgp_sd if k.endswith("num_batches_tracked")]
    _same_sd(c.lgp.state_dict(), lgp_sd, skip=tracked)
    assert all(int(c.lgp.state_dict()[k]) == 0 for k in tracked)
    assert c.unet.dtype == torch.float32 and not any(p.requires_grad for p in c.unet.parameters())


def test_convert_checkpoint_main_loads_in_jax(tmp_path, monkeypatch):
    """``convert_checkpoint.main --lgp_weights --netg``: the directory loads
    in JAX's ``from_native`` with the JAX converters' trees, and
    anime2sketch.npz in JAX's ``load_params_npz`` as
    ``convert_torch_anime2sketch`` makes it (the published 8 levels, narrow)."""
    sds = write_diffusers_dir(tmp_path / "sd", seed=5)
    lgp_sd = dir_lgp(6).state_dict()
    torch.save(lgp_sd, tmp_path / "edge_predictor.pt")
    torch.manual_seed(7)
    netg_sd = create_anime2sketch(8, 2).state_dict()
    torch.save({"module." + k: v for k, v in netg_sd.items()}, tmp_path / "netG.pth")
    real = SDComponents.from_diffusers_dir.__func__
    monkeypatch.setattr(SDComponents, "from_diffusers_dir", classmethod(
        lambda cls, path, **kw: real(cls, path, **{**kw, **dir_component_kw()})))
    out = tmp_path / "native"
    convert_checkpoint.main(["--model_path", str(tmp_path / "sd"), "--lgp_weights",
                             str(tmp_path / "edge_predictor.pt"), "--netg",
                             str(tmp_path / "netG.pth"), "--output", str(out)])
    assert sorted(p.name for p in out.iterdir()) == [
        "anime2sketch.npz", "lgp.npz", "text.npz", "unet.npz", "vae.npz"]
    _check_jax_loaded(_jax_from_native(out), _jax_trees(sds, lgp_sd))
    _same_tree(j_load_params_npz(str(out / "anime2sketch.npz")),
               convert_torch_anime2sketch(netg_sd, 8))
