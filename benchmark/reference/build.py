"""The reference's modules at a configuration's sizes.

Why it is here: one place turns a configuration file's published sizes
into the reference's module trees, so the weights maker, the output check
and the FLOP counts see the same architecture.
"""

from __future__ import annotations

from typing import Dict

import torch.nn as nn

from benchmark.reference import models


def unet(cfg: Dict, injection: bool = False) -> models.UNet:
    u = cfg["unet"]
    inj = cfg["vision"]["hidden_size"] if injection else None
    return models.UNet(u["block_out_channels"], u["attention_head_dim"],
                       u["cross_attention_dim"], u["in_channels"], injection_dim=inj)


def vae(cfg: Dict) -> models.VAE:
    v = cfg["vae"]
    return models.VAE(v["block_out_channels"], v["layers_per_block"], v["latent_channels"])


def text(cfg: Dict) -> models.CLIPText:
    t = cfg["text_encoder"]
    return models.CLIPText(t["vocab_size"], t["hidden_size"], t["num_hidden_layers"],
                           t["num_attention_heads"], t["intermediate_size"],
                           t["max_position_embeddings"])


def vision(v: Dict) -> models.CLIPVision:
    return models.CLIPVision(v["image_size"], v["patch_size"], v["hidden_size"],
                             v["num_hidden_layers"], v["num_attention_heads"],
                             v["intermediate_size"])


def safety_checker(cfg: Dict) -> models.SafetyChecker:
    s = cfg["safety_checker"]
    return models.SafetyChecker(vision(s), s["projection_dim"], s["concepts"], s["special"])


def lgp(cfg: Dict) -> models.LGP:
    g = cfg["lgp"]
    return models.LGP(models.tap_channels(cfg["unet"]["block_out_channels"]) + 4 + 4 * 9,
                      g["widths"], g["output_dim"])


def anime2sketch(cfg: Dict) -> models.Anime2Sketch:
    a = cfg["anime2sketch"]
    return models.Anime2Sketch(a["num_downs"], a["ngf"])


BUILDERS = {
    "unet": lambda cfg: unet(cfg),
    "unet_inject": lambda cfg: unet(cfg, injection=True),
    "vae": vae,
    "text_encoder": text,
    "safety_checker": safety_checker,
    "lgp": lgp,
    "anime2sketch": anime2sketch,
    "vision": lambda cfg: vision(cfg["vision"]),
}


def build(cfg: Dict, name: str) -> nn.Module:
    """The reference module ``name`` of ``cfg`` (on the current default device)."""
    return BUILDERS[name](cfg)
