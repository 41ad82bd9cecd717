"""Both sides' modules from one configuration and one seed: the port's,
built through its public classes with the seeded weights loaded into
them, and the reference's, in float32 (or the control's lower precision)
from the same weights made again.

Why it is here: the two sides must get the same inputs and nothing else.
The weights are made from the seed on the device in the dtype the
configuration serves (``harness.weights``); the port's modules are built
on the meta device and take those tensors (``load_state_dict(strict=True,
assign=True)``), so a name or shape the port does not share fails here.
After the window the reference makes the same weights again, so nothing
the port did to its tensors reaches it.
"""

from __future__ import annotations

import copy
import types
from typing import Dict, Iterable

import torch

from benchmark.harness import weights
from benchmark.reference import build, precision

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}
#: tree -> (reference builder, dtype key in the configuration, kaiming init)
TREES = {
    "unet": ("unet", "unet", False),
    "sat": ("unet_inject", "unet", False),
    "vae": ("vae", "vae", False),
    "text_encoder": ("text_encoder", "text_encoder", False),
    "safety_checker": ("safety_checker", "safety_checker", False),
    "vision": ("vision", "vision", False),
    "lgp": ("lgp", "lgp", True),
    "anime2sketch": ("anime2sketch", "anime2sketch", False),
}


def dtype_of(cfg: Dict, tree: str) -> torch.dtype:
    return DTYPES[cfg["dtypes"][TREES[tree][1]]]


def _meta_tree(cfg: Dict, tree: str) -> torch.nn.Module:
    with torch.device("meta"):
        mod = build.build(cfg, TREES[tree][0])
    return mod.sat if tree == "sat" else mod


def make_weights(cfg: Dict, seed: int, tree: str, device) -> Dict[str, torch.Tensor]:
    return weights.make(_meta_tree(cfg, tree), seed, tree, dtype_of(cfg, tree), device,
                        kaiming=TREES[tree][2])


def _frozen(module: torch.nn.Module) -> torch.nn.Module:
    return module.eval().requires_grad_(False)


def port_module(cfg: Dict, tree: str, sd: Dict[str, torch.Tensor]) -> torch.nn.Module:
    """The port's module for ``tree``, holding ``sd``'s tensors."""
    from sketch2img_torch.models.anime2sketch import create_anime2sketch
    from sketch2img_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
    from sketch2img_torch.models.lgp import LatentEdgePredictor
    from sketch2img_torch.models.safety_checker import SafetyChecker
    from sketch2img_torch.models.unet import UNet2DCondition, UNetConfig
    from sketch2img_torch.models.vae import AutoencoderKL, VAEConfig

    with torch.device("meta"):
        if tree == "unet":
            u = cfg["unet"]
            n = len(u["block_out_channels"])
            mod = UNet2DCondition(UNetConfig(
                in_channels=u["in_channels"], block_out_channels=tuple(u["block_out_channels"]),
                layers_per_block=u["layers_per_block"], cross_attn=(True,) * (n - 1) + (False,),
                num_heads=u["attention_head_dim"], cross_attention_dim=u["cross_attention_dim"]))
        elif tree == "vae":
            v = cfg["vae"]
            mod = AutoencoderKL(VAEConfig(block_out_channels=tuple(v["block_out_channels"]),
                                          layers_per_block=v["layers_per_block"],
                                          latent_channels=v["latent_channels"]))
        elif tree == "text_encoder":
            t = cfg["text_encoder"]
            mod = CLIPTextEncoder(CLIPTextConfig(
                vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
                num_layers=t["num_hidden_layers"], num_heads=t["num_attention_heads"],
                max_length=t["max_position_embeddings"],
                intermediate_size=t["intermediate_size"]))
        elif tree == "safety_checker":
            s = cfg["safety_checker"]
            mod = SafetyChecker(vision_config(s), s["projection_dim"], s["concepts"], s["special"])
        elif tree == "vision":
            from sketch2img_torch.models.clip_vision import CLIPVisionEncoder

            mod = CLIPVisionEncoder(vision_config(cfg["vision"]))
        elif tree == "lgp":
            mod = LatentEdgePredictor(input_dim=sd["layers.0.weight"].shape[1],
                                      output_dim=cfg["lgp"]["output_dim"])
        elif tree == "anime2sketch":
            a = cfg["anime2sketch"]
            mod = create_anime2sketch(a["num_downs"], a["ngf"])
        else:
            raise ValueError(f"no port module for tree {tree!r}")
    mod.load_state_dict(sd, strict=True, assign=True)
    return _frozen(mod)


def vision_config(v: Dict):
    from sketch2img_torch.models.clip_vision import CLIPVisionConfig

    return CLIPVisionConfig(image_size=v["image_size"], patch_size=v["patch_size"],
                            hidden_size=v["hidden_size"], num_layers=v["num_hidden_layers"],
                            num_heads=v["num_attention_heads"],
                            intermediate_size=v["intermediate_size"])


def reference(cfg: Dict, seed: int, trees: Iterable[str], device) -> types.SimpleNamespace:
    """The reference's modules in float32, on ``device``, holding the
    seeded weights made again (``unet`` takes the ``sat`` tree when it is
    listed: the injected UNet)."""
    trees = list(trees)
    sds = {t: {k: v.float() for k, v in make_weights(cfg, seed, t, device).items()}
           for t in trees}
    out = types.SimpleNamespace()
    for tree in trees:
        if tree == "sat":
            continue
        name = "unet_inject" if tree == "unet" and "sat" in trees else TREES[tree][0]
        with torch.device("meta"):
            mod = build.build(cfg, name)
        sd = dict(sds[tree])
        if name == "unet_inject":
            sd.update({"sat." + k: v for k, v in sds["sat"].items()})
        mod.load_state_dict(sd, strict=True, assign=True)
        setattr(out, {"text_encoder": "text"}.get(tree, tree), _frozen(mod))
    return out


def lower_precision(cfg: Dict, ref: types.SimpleNamespace) -> types.SimpleNamespace:
    """The control: a copy of ``ref`` with every module the configuration
    serves in bf16 or fp16 rounded to fp8 (``reference.precision``). The
    fp32 modules are left as they are: run them under ``precision.tf32``."""
    out = types.SimpleNamespace()
    for name, mod in vars(ref).items():
        tree = {"text": "text_encoder"}.get(name, name)
        low = cfg["dtypes"][TREES[tree][1]] in ("bfloat16", "float16")
        setattr(out, name, precision.to_fp8(copy.deepcopy(mod)) if low else mod)
    return out
