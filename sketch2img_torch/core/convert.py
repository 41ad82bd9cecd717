"""Weights carried across from the JAX package: parameter trees of
``sketch2img_tpu`` (nested dicts of arrays, e.g. from its ``save_native``
npz files) -> state dicts of the port's modules.

These invert the JAX package's torch -> Flax converters
(``core/convert.py::convert_torch_unet`` / ``convert_torch_vae``,
``models/clip_text.py::convert_torch_clip_text``,
``models/lgp.py::convert_torch_lgp``,
``models/clip_vision.py::convert_torch_clip_vision``,
``models/safety_checker.py::convert_torch_safety_checker``,
``core/export.py::convert_torch_sat``,
``models/anime2sketch.py::convert_torch_anime2sketch``):

  conv   flax (kh, kw, I, O) -> torch (O, I, kh, kw)
  dense  flax (I, O)         -> torch (O, I)
  norms  {"GroupNorm_0"|"LayerNorm_0": {scale, bias}} -> weight, bias
  LGP    batch_stats {mean, var} -> BatchNorm1d running_mean / running_var
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from sketch2img_torch.models.unet import SD15_CONFIG, UNetConfig, injection_sites, sat_name
from sketch2img_torch.models.vae import SD15_VAE_CONFIG, VAEConfig

StateDict = Dict[str, torch.Tensor]


def load_params_npz(path: str) -> Dict[str, Any]:
    """A JAX package npz export ("a/b/c" keys, ``export_params_npz``) ->
    the nested parameter tree."""
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            *outer, leaf = key.split("/")
            node = tree
            for part in outer:
                node = node.setdefault(part, {})
            node[leaf] = data[key]
    return tree


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _conv(sd: StateDict, prefix: str, p: Mapping) -> None:
    sd[prefix + ".weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    sd[prefix + ".bias"] = _t(p["bias"])


def _dense(sd: StateDict, prefix: str, p: Mapping) -> None:
    sd[prefix + ".weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[prefix + ".bias"] = _t(p["bias"])


def _norm(sd: StateDict, prefix: str, p: Mapping) -> None:
    inner = p["GroupNorm_0"] if "GroupNorm_0" in p else p["LayerNorm_0"]
    sd[prefix + ".weight"] = _t(inner["scale"])
    sd[prefix + ".bias"] = _t(inner["bias"])


def _resnet(sd: StateDict, prefix: str, p: Mapping) -> None:
    _norm(sd, prefix + ".norm1", p["norm1"])
    _conv(sd, prefix + ".conv1", p["conv1"])
    if "time_emb_proj" in p:
        _dense(sd, prefix + ".time_emb_proj", p["time_emb_proj"])
    _norm(sd, prefix + ".norm2", p["norm2"])
    _conv(sd, prefix + ".conv2", p["conv2"])
    if "conv_shortcut" in p:
        _conv(sd, prefix + ".conv_shortcut", p["conv_shortcut"])


def _spatial_transformer(sd: StateDict, prefix: str, p: Mapping) -> None:
    _norm(sd, prefix + ".norm", p["norm"])
    _conv(sd, prefix + ".proj_in", p["proj_in"])
    _conv(sd, prefix + ".proj_out", p["proj_out"])
    d = 0
    while f"block_{d}" in p:
        bp, bx = p[f"block_{d}"], f"{prefix}.transformer_blocks.{d}"
        for n in ("norm1", "norm2", "norm3"):
            _norm(sd, f"{bx}.{n}", bp[n])
        for a in ("attn1", "attn2"):
            for n in ("to_q", "to_k", "to_v"):
                _dense(sd, f"{bx}.{a}.{n}", bp[a][n])
            _dense(sd, f"{bx}.{a}.to_out.0", bp[a]["to_out"])
        _dense(sd, f"{bx}.ff.net.0.proj", bp["ff"]["proj_in"])
        _dense(sd, f"{bx}.ff.net.2", bp["ff"]["proj_out"])
        d += 1


def unet_from_jax(params: Mapping, config: UNetConfig = SD15_CONFIG) -> StateDict:
    """JAX ``UNet2DCondition`` params -> port ``UNet2DCondition`` state dict."""
    sd: StateDict = {}
    _conv(sd, "conv_in", params["conv_in"])
    _dense(sd, "time_embedding.linear_1", params["time_linear_1"])
    _dense(sd, "time_embedding.linear_2", params["time_linear_2"])
    n = len(config.block_out_channels)
    for i in range(n):
        for j in range(config.layers_per_block):
            _resnet(sd, f"down_blocks.{i}.resnets.{j}", params[f"down_{i}_resnet_{j}"])
            if config.cross_attn[i]:
                _spatial_transformer(sd, f"down_blocks.{i}.attentions.{j}",
                                     params[f"down_{i}_attn_{j}"])
        if i < n - 1:
            _conv(sd, f"down_blocks.{i}.downsamplers.0.conv",
                  params[f"down_{i}_downsample"]["conv"])
    _resnet(sd, "mid_block.resnets.0", params["mid_resnet_0"])
    _spatial_transformer(sd, "mid_block.attentions.0", params["mid_attn"])
    _resnet(sd, "mid_block.resnets.1", params["mid_resnet_1"])
    rev_ca = tuple(reversed(config.cross_attn))
    for i in range(n):
        for j in range(config.layers_per_block + 1):
            _resnet(sd, f"up_blocks.{i}.resnets.{j}", params[f"up_{i}_resnet_{j}"])
            if rev_ca[i]:
                _spatial_transformer(sd, f"up_blocks.{i}.attentions.{j}",
                                     params[f"up_{i}_attn_{j}"])
        if i < n - 1:
            _conv(sd, f"up_blocks.{i}.upsamplers.0.conv", params[f"up_{i}_upsample"]["conv"])
    _norm(sd, "conv_norm_out", params["norm_out"])
    _conv(sd, "conv_out", params["conv_out"])
    return sd


def _vae_mid(sd: StateDict, prefix: str, p: Mapping) -> None:
    _resnet(sd, prefix + ".resnets.0", p["resnet_0"])
    _resnet(sd, prefix + ".resnets.1", p["resnet_1"])
    a, ax = p["attn"], prefix + ".attentions.0"
    _norm(sd, ax + ".group_norm", a["group_norm"])
    for n in ("query", "key", "value", "proj_attn"):
        _dense(sd, f"{ax}.{n}", a[n])


def vae_from_jax(params: Mapping, config: VAEConfig = SD15_VAE_CONFIG) -> StateDict:
    """JAX ``AutoencoderKL`` params -> port ``AutoencoderKL`` state dict."""
    sd: StateDict = {}
    n = len(config.block_out_channels)
    enc, dec = params["encoder"], params["decoder"]
    _conv(sd, "encoder.conv_in", enc["conv_in"])
    for i in range(n):
        for j in range(config.layers_per_block):
            _resnet(sd, f"encoder.down_blocks.{i}.resnets.{j}", enc[f"down_{i}_resnet_{j}"])
        if i < n - 1:
            _conv(sd, f"encoder.down_blocks.{i}.downsamplers.0.conv",
                  enc[f"down_{i}_downsample"]["conv"])
    _vae_mid(sd, "encoder.mid_block", enc["mid"])
    _norm(sd, "encoder.conv_norm_out", enc["norm_out"])
    _conv(sd, "encoder.conv_out", enc["conv_out"])
    _conv(sd, "decoder.conv_in", dec["conv_in"])
    _vae_mid(sd, "decoder.mid_block", dec["mid"])
    for i in range(n):
        for j in range(config.layers_per_block + 1):
            _resnet(sd, f"decoder.up_blocks.{i}.resnets.{j}", dec[f"up_{i}_resnet_{j}"])
        if i < n - 1:
            _conv(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv",
                  dec[f"up_{i}_upsample"]["conv"])
    _norm(sd, "decoder.conv_norm_out", dec["norm_out"])
    _conv(sd, "decoder.conv_out", dec["conv_out"])
    _conv(sd, "quant_conv", params["quant_conv"])
    _conv(sd, "post_quant_conv", params["post_quant_conv"])
    return sd


def clip_text_from_jax(params: Mapping, num_layers: int = 12) -> StateDict:
    """JAX ``CLIPTextEncoder`` params -> port ``CLIPTextEncoder`` state dict."""
    p = "text_model."
    sd: StateDict = {
        p + "embeddings.token_embedding.weight": _t(params["token_embedding"]["embedding"]),
        p + "embeddings.position_embedding.weight": _t(params["position_embedding"]),
    }
    for i in range(num_layers):
        lp, lx = params[f"layer_{i}"], f"{p}encoder.layers.{i}."
        _norm(sd, lx + "layer_norm1", lp["layer_norm1"])
        _norm(sd, lx + "layer_norm2", lp["layer_norm2"])
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(sd, f"{lx}self_attn.{n}", lp["self_attn"][n])
        _dense(sd, lx + "mlp.fc1", lp["fc1"])
        _dense(sd, lx + "mlp.fc2", lp["fc2"])
    _norm(sd, p + "final_layer_norm", params["final_layer_norm"])
    return sd


def lgp_from_jax(params: Mapping, batch_stats: Mapping) -> StateDict:
    """JAX ``LatentEdgePredictor`` (params, batch_stats) -> port
    ``LatentEdgePredictor`` state dict (the ``edge_predictor.pt`` layout)."""
    sd: StateDict = {}
    for i, li in enumerate((0, 3, 6, 9, 12)):
        _dense(sd, f"layers.{li}", params[f"dense_{i}"])
    for i, bi in enumerate((2, 5, 8, 11)):
        sd[f"layers.{bi}.weight"] = _t(params[f"bn_{i}"]["scale"])
        sd[f"layers.{bi}.bias"] = _t(params[f"bn_{i}"]["bias"])
        sd[f"layers.{bi}.running_mean"] = _t(batch_stats[f"bn_{i}"]["mean"])
        sd[f"layers.{bi}.running_var"] = _t(batch_stats[f"bn_{i}"]["var"])
        sd[f"layers.{bi}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def clip_vision_from_jax(params: Mapping, num_layers: int = 24,
                         prefix: str = "vision_model.") -> StateDict:
    """JAX ``CLIPVisionEncoder`` params -> port ``CLIPVisionEncoder`` state
    dict (transformers ``CLIPVisionModel`` names under ``prefix``).
    ``post_layernorm`` is not in the JAX tree (only the safety checker's
    pooled output reads it): it comes out as the identity, scale 1, bias 0."""
    p = prefix
    pre = params["pre_layrnorm"]["LayerNorm_0"]
    sd: StateDict = {
        p + "embeddings.class_embedding": _t(params["class_embedding"]),
        p + "embeddings.patch_embedding.weight":
            _t(np.asarray(params["patch_embedding"]["kernel"]).transpose(3, 2, 0, 1)),
        p + "embeddings.position_embedding.weight": _t(params["position_embedding"]),
    }
    _norm(sd, p + "pre_layrnorm", params["pre_layrnorm"])
    for i in range(num_layers):
        lp, lx = params[f"layer_{i}"], f"{p}encoder.layers.{i}."
        _norm(sd, lx + "layer_norm1", lp["layer_norm1"])
        _norm(sd, lx + "layer_norm2", lp["layer_norm2"])
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(sd, f"{lx}self_attn.{n}", lp[n])
        _dense(sd, lx + "mlp.fc1", lp["fc1"])
        _dense(sd, lx + "mlp.fc2", lp["fc2"])
    scale = np.asarray(pre["scale"])
    sd[p + "post_layernorm.weight"] = _t(np.ones_like(scale))
    sd[p + "post_layernorm.bias"] = _t(np.zeros_like(scale))
    return sd


def injection_from_jax(inj_params: Mapping, config: UNetConfig) -> StateDict:
    """JAX injection subtree (``down_{i}_attn_{j}`` / ``mid_attn`` /
    ``up_{i}_attn_{j}`` -> ``block_0`` -> ``sketch_*``) -> the state dict of
    the port's ``unet.sat``: the reference's ``sketch_attn_model.pt``
    layout."""
    outers = []
    for i, ca in enumerate(config.cross_attn):
        outers += [f"down_{i}_attn_{j}" for j in range(config.layers_per_block)] if ca else []
    outers.append("mid_attn")
    for i, ca in enumerate(reversed(config.cross_attn)):
        outers += [f"up_{i}_attn_{j}" for j in range(config.layers_per_block + 1)] if ca else []
    sd: StateDict = {}
    for outer, (path, _) in zip(outers, injection_sites(config)):
        b, n = inj_params[outer]["block_0"], sat_name(path)
        if "sketch_proj" in b:
            _dense(sd, n + ".sketch_proj", b["sketch_proj"])
        _norm(sd, n + ".sketch_norm", b["sketch_norm"])
        for proj in ("to_q", "to_k", "to_v"):
            _dense(sd, f"{n}.sketch_attn.{proj}", b["sketch_attn"][proj])
        _dense(sd, n + ".sketch_attn.to_out.0", b["sketch_attn"]["to_out"])
        sd[n + ".sketch_conv.weight"] = _t(np.asarray(b["sketch_conv"]["kernel"]).T[:, :, None])
        sd[n + ".sketch_conv.bias"] = _t(b["sketch_conv"]["bias"])
    return sd


def safety_checker_from_jax(p: Any, num_layers: int = 24) -> StateDict:
    """JAX ``SafetyCheckerParams`` (any object with its field names) -> port
    ``SafetyChecker`` state dict (diffusers ``StableDiffusionSafetyChecker``
    names)."""
    sd = clip_vision_from_jax(p.vision, num_layers, prefix="vision_model.vision_model.")
    sd["vision_model.vision_model.post_layernorm.weight"] = _t(p.post_ln_scale)
    sd["vision_model.vision_model.post_layernorm.bias"] = _t(p.post_ln_bias)
    sd["visual_projection.weight"] = _t(np.asarray(p.projection).T)
    sd["concept_embeds"] = _t(p.concept_embeds)
    sd["concept_embeds_weights"] = _t(p.concept_thresholds)
    sd["special_care_embeds"] = _t(p.special_care_embeds)
    sd["special_care_embeds_weights"] = _t(p.special_care_thresholds)
    return sd


def anime2sketch_from_jax(params: Mapping, num_downs: int = 8) -> StateDict:
    """JAX ``UnetGenerator`` params -> port ``UnetGenerator`` state dict (the
    ``netG.pth`` layout). Inverts ``convert_torch_anime2sketch``: the
    Sequential index of each level's down and up conv is 0 and 3 at the
    outermost level, 1 and 3 at the innermost, 1 and 5 between, and the
    submodule sits at 1 (outermost) or 3; both conv kernels go
    (kh, kw, a, b) -> (b, a, kh, kw)."""
    sd: StateDict = {}
    node, prefix = params["model"], "model.model"
    for level in range(num_downs):
        innermost = level == num_downs - 1
        down_i, up_i, sub_i = (0, 3, 1) if level == 0 else (1, 3, None) if innermost else (1, 5, 3)
        _conv(sd, f"{prefix}.{down_i}", node["downconv"])
        _conv(sd, f"{prefix}.{up_i}", node["upconv"])
        if sub_i is not None:
            node, prefix = node["submodule"], f"{prefix}.{sub_i}.model"
    return sd
