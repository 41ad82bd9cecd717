"""Weights carried across to and from the JAX package: parameter trees of
``sketch2img_tpu`` (nested dicts of arrays, e.g. from its ``save_native``
npz files) <-> state dicts of the port's modules.

``*_from_jax`` invert the JAX package's torch -> Flax converters
(``core/convert.py::convert_torch_unet`` / ``convert_torch_vae``,
``models/clip_text.py::convert_torch_clip_text``,
``models/lgp.py::convert_torch_lgp``,
``models/clip_vision.py::convert_torch_clip_vision``,
``models/safety_checker.py::convert_torch_safety_checker``,
``core/export.py::convert_torch_sat``,
``models/anime2sketch.py::convert_torch_anime2sketch``); ``*_to_jax`` are
those converters' counterparts here, writing float32 arrays:

  conv   flax (kh, kw, I, O) <-> torch (O, I, kh, kw)
  dense  flax (I, O)         <-> torch (O, I)
  norms  {"GroupNorm_0"|"LayerNorm_0": {scale, bias}} <-> weight, bias
  LGP    batch_stats {mean, var} <-> BatchNorm1d running_mean / running_var

Each model's key and layout mapping is written once, as a walk over a
mapper: ``_Reader`` fills a state dict from a tree, ``_Writer`` fills a tree
from a state dict and refuses a state dict with keys the walk did not take.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from sketch2img_torch.models.unet import SD15_CONFIG, UNetConfig, injection_sites, sat_name
from sketch2img_torch.models.vae import SD15_VAE_CONFIG, VAEConfig

StateDict = Dict[str, torch.Tensor]
Path = Tuple[str, ...]


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
    return torch.from_numpy(np.array(x, copy=True, order="C"))


# a leaf's layout change: (flax -> torch, torch -> flax); None keeps it
_SAME = (None, None)
_CONV = (lambda k: k.transpose(3, 2, 0, 1), lambda w: w.transpose(2, 3, 1, 0))
_DENSE = (lambda k: k.T, lambda w: w.T)
_CONV1D = (lambda k: k.T[:, :, None], lambda w: w[:, :, 0].T)  # Dense kernel <-> Conv1d(k=1)
_GN, _LN = "GroupNorm_0", "LayerNorm_0"


class _Reader:
    """JAX tree -> state dict."""

    def __init__(self, tree: Mapping):
        self.tree, self.sd = tree, {}

    def has(self, key: str, path: Path) -> bool:
        node = self.tree
        for part in path:
            if not isinstance(node, Mapping) or part not in node:
                return False
            node = node[part]
        return True

    def leaf(self, key: str, path: Path, layout=_SAME) -> None:
        node = self.tree
        for part in path:
            node = node[part]
        x = np.asarray(node)
        self.sd[key] = _t(x if layout[0] is None else layout[0](x))

    def extra(self, key: str, make: Callable[[StateDict], torch.Tensor]) -> None:
        """A state-dict entry the JAX tree does not hold."""
        self.sd[key] = make(self.sd)


class _Writer:
    """State dict -> JAX tree of float32 arrays."""

    def __init__(self, sd: Mapping[str, torch.Tensor]):
        self.sd, self.tree, self.used = sd, {}, set()

    def has(self, key: str, path: Path) -> bool:
        return key in self.sd or any(k.startswith(key + ".") for k in self.sd)

    def leaf(self, key: str, path: Path, layout=_SAME) -> None:
        x = self.sd[key].detach().float().cpu().numpy()
        self.used.add(key)
        node = self.tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = x if layout[1] is None else np.ascontiguousarray(layout[1](x))

    def extra(self, key: str, make) -> None:
        self.used.add(key)

    def result(self) -> Dict[str, Any]:
        left = sorted(set(self.sd) - self.used)
        if left:
            raise KeyError(f"{len(left)} state-dict keys have no place in the JAX tree: "
                           f"{left[:5]}")
        return self.tree


def _read(tree: Mapping, walk, *args) -> StateDict:
    m = _Reader(tree)
    walk(m, *args)
    return m.sd


def _write(sd: Mapping[str, torch.Tensor], walk, *args) -> Dict[str, Any]:
    m = _Writer(sd)
    walk(m, *args)
    return m.result()


def _conv(m, key: str, path: Path) -> None:
    m.leaf(key + ".weight", path + ("kernel",), _CONV)
    m.leaf(key + ".bias", path + ("bias",))


def _dense(m, key: str, path: Path) -> None:
    m.leaf(key + ".weight", path + ("kernel",), _DENSE)
    if m.has(key + ".bias", path + ("bias",)):
        m.leaf(key + ".bias", path + ("bias",))


def _norm(m, key: str, path: Path, kind: str) -> None:
    m.leaf(key + ".weight", path + (kind, "scale"))
    m.leaf(key + ".bias", path + (kind, "bias"))


def _resnet(m, key: str, path: Path) -> None:
    _norm(m, key + ".norm1", path + ("norm1",), _GN)
    _conv(m, key + ".conv1", path + ("conv1",))
    if m.has(key + ".time_emb_proj", path + ("time_emb_proj",)):
        _dense(m, key + ".time_emb_proj", path + ("time_emb_proj",))
    _norm(m, key + ".norm2", path + ("norm2",), _GN)
    _conv(m, key + ".conv2", path + ("conv2",))
    if m.has(key + ".conv_shortcut", path + ("conv_shortcut",)):
        _conv(m, key + ".conv_shortcut", path + ("conv_shortcut",))


def _spatial_transformer(m, key: str, path: Path) -> None:
    _norm(m, key + ".norm", path + ("norm",), _GN)
    _conv(m, key + ".proj_in", path + ("proj_in",))
    _conv(m, key + ".proj_out", path + ("proj_out",))
    d = 0
    while m.has(f"{key}.transformer_blocks.{d}", path + (f"block_{d}",)):
        bk, bp = f"{key}.transformer_blocks.{d}", path + (f"block_{d}",)
        for n in ("norm1", "norm2", "norm3"):
            _norm(m, f"{bk}.{n}", bp + (n,), _LN)
        for a in ("attn1", "attn2"):
            for n in ("to_q", "to_k", "to_v"):
                _dense(m, f"{bk}.{a}.{n}", bp + (a, n))
            _dense(m, f"{bk}.{a}.to_out.0", bp + (a, "to_out"))
        _dense(m, f"{bk}.ff.net.0.proj", bp + ("ff", "proj_in"))
        _dense(m, f"{bk}.ff.net.2", bp + ("ff", "proj_out"))
        d += 1


def _unet(m, config: UNetConfig) -> None:
    _conv(m, "conv_in", ("conv_in",))
    _dense(m, "time_embedding.linear_1", ("time_linear_1",))
    _dense(m, "time_embedding.linear_2", ("time_linear_2",))
    n = len(config.block_out_channels)
    for i in range(n):
        for j in range(config.layers_per_block):
            _resnet(m, f"down_blocks.{i}.resnets.{j}", (f"down_{i}_resnet_{j}",))
            if config.cross_attn[i]:
                _spatial_transformer(m, f"down_blocks.{i}.attentions.{j}", (f"down_{i}_attn_{j}",))
        if i < n - 1:
            _conv(m, f"down_blocks.{i}.downsamplers.0.conv", (f"down_{i}_downsample", "conv"))
    _resnet(m, "mid_block.resnets.0", ("mid_resnet_0",))
    _spatial_transformer(m, "mid_block.attentions.0", ("mid_attn",))
    _resnet(m, "mid_block.resnets.1", ("mid_resnet_1",))
    rev_ca = tuple(reversed(config.cross_attn))
    for i in range(n):
        for j in range(config.layers_per_block + 1):
            _resnet(m, f"up_blocks.{i}.resnets.{j}", (f"up_{i}_resnet_{j}",))
            if rev_ca[i]:
                _spatial_transformer(m, f"up_blocks.{i}.attentions.{j}", (f"up_{i}_attn_{j}",))
        if i < n - 1:
            _conv(m, f"up_blocks.{i}.upsamplers.0.conv", (f"up_{i}_upsample", "conv"))
    _norm(m, "conv_norm_out", ("norm_out",), _GN)
    _conv(m, "conv_out", ("conv_out",))


def unet_from_jax(params: Mapping, config: UNetConfig = SD15_CONFIG) -> StateDict:
    """JAX ``UNet2DCondition`` params -> port ``UNet2DCondition`` state dict."""
    return _read(params, _unet, config)


def unet_to_jax(sd: Mapping[str, torch.Tensor], config: UNetConfig = SD15_CONFIG) -> dict:
    """Port ``UNet2DCondition`` state dict (no injection blocks) -> JAX params."""
    return _write(sd, _unet, config)


def _vae_mid(m, key: str, path: Path) -> None:
    _resnet(m, key + ".resnets.0", path + ("resnet_0",))
    _resnet(m, key + ".resnets.1", path + ("resnet_1",))
    ak, ap = key + ".attentions.0", path + ("attn",)
    _norm(m, ak + ".group_norm", ap + ("group_norm",), _GN)
    for n in ("query", "key", "value", "proj_attn"):
        _dense(m, f"{ak}.{n}", ap + (n,))


def _vae(m, config: VAEConfig) -> None:
    n = len(config.block_out_channels)
    enc, dec = ("encoder",), ("decoder",)
    _conv(m, "encoder.conv_in", enc + ("conv_in",))
    for i in range(n):
        for j in range(config.layers_per_block):
            _resnet(m, f"encoder.down_blocks.{i}.resnets.{j}", enc + (f"down_{i}_resnet_{j}",))
        if i < n - 1:
            _conv(m, f"encoder.down_blocks.{i}.downsamplers.0.conv",
                  enc + (f"down_{i}_downsample", "conv"))
    _vae_mid(m, "encoder.mid_block", enc + ("mid",))
    _norm(m, "encoder.conv_norm_out", enc + ("norm_out",), _GN)
    _conv(m, "encoder.conv_out", enc + ("conv_out",))
    _conv(m, "decoder.conv_in", dec + ("conv_in",))
    _vae_mid(m, "decoder.mid_block", dec + ("mid",))
    for i in range(n):
        for j in range(config.layers_per_block + 1):
            _resnet(m, f"decoder.up_blocks.{i}.resnets.{j}", dec + (f"up_{i}_resnet_{j}",))
        if i < n - 1:
            _conv(m, f"decoder.up_blocks.{i}.upsamplers.0.conv",
                  dec + (f"up_{i}_upsample", "conv"))
    _norm(m, "decoder.conv_norm_out", dec + ("norm_out",), _GN)
    _conv(m, "decoder.conv_out", dec + ("conv_out",))
    _conv(m, "quant_conv", ("quant_conv",))
    _conv(m, "post_quant_conv", ("post_quant_conv",))


def vae_from_jax(params: Mapping, config: VAEConfig = SD15_VAE_CONFIG) -> StateDict:
    """JAX ``AutoencoderKL`` params -> port ``AutoencoderKL`` state dict."""
    return _read(params, _vae, config)


def vae_to_jax(sd: Mapping[str, torch.Tensor], config: VAEConfig = SD15_VAE_CONFIG) -> dict:
    """Port ``AutoencoderKL`` state dict -> JAX params."""
    return _write(sd, _vae, config)


def _clip_text(m, num_layers: int) -> None:
    p = "text_model."
    m.leaf(p + "embeddings.token_embedding.weight", ("token_embedding", "embedding"))
    m.leaf(p + "embeddings.position_embedding.weight", ("position_embedding",))
    for i in range(num_layers):
        lk, lp = f"{p}encoder.layers.{i}.", (f"layer_{i}",)
        _norm(m, lk + "layer_norm1", lp + ("layer_norm1",), _LN)
        _norm(m, lk + "layer_norm2", lp + ("layer_norm2",), _LN)
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(m, f"{lk}self_attn.{n}", lp + ("self_attn", n))
        _dense(m, lk + "mlp.fc1", lp + ("fc1",))
        _dense(m, lk + "mlp.fc2", lp + ("fc2",))
    _norm(m, p + "final_layer_norm", ("final_layer_norm",), _LN)


def clip_text_from_jax(params: Mapping, num_layers: int = 12) -> StateDict:
    """JAX ``CLIPTextEncoder`` params -> port ``CLIPTextEncoder`` state dict."""
    return _read(params, _clip_text, num_layers)


def clip_text_to_jax(sd: Mapping[str, torch.Tensor], num_layers: int = 12) -> dict:
    """Port ``CLIPTextEncoder`` state dict -> JAX params."""
    return _write(sd, _clip_text, num_layers)


def _lgp(m) -> None:
    for i, li in enumerate((0, 3, 6, 9, 12)):
        _dense(m, f"layers.{li}", ("params", f"dense_{i}"))
    for i, bi in enumerate((2, 5, 8, 11)):
        m.leaf(f"layers.{bi}.weight", ("params", f"bn_{i}", "scale"))
        m.leaf(f"layers.{bi}.bias", ("params", f"bn_{i}", "bias"))
        m.leaf(f"layers.{bi}.running_mean", ("batch_stats", f"bn_{i}", "mean"))
        m.leaf(f"layers.{bi}.running_var", ("batch_stats", f"bn_{i}", "var"))
        m.extra(f"layers.{bi}.num_batches_tracked",
                lambda sd: torch.tensor(0, dtype=torch.long))


def lgp_from_jax(params: Mapping, batch_stats: Mapping) -> StateDict:
    """JAX ``LatentEdgePredictor`` (params, batch_stats) -> port
    ``LatentEdgePredictor`` state dict (the ``edge_predictor.pt`` layout)."""
    return _read({"params": params, "batch_stats": batch_stats}, _lgp)


def lgp_to_jax(sd: Mapping[str, torch.Tensor]) -> dict:
    """Port ``LatentEdgePredictor`` state dict -> the JAX variables
    ``{"params": ..., "batch_stats": ...}`` (``num_batches_tracked`` has no
    place there)."""
    return _write(sd, _lgp)


def _clip_vision(m, num_layers: int, prefix: str) -> None:
    p = prefix
    m.leaf(p + "embeddings.class_embedding", ("class_embedding",))
    m.leaf(p + "embeddings.patch_embedding.weight", ("patch_embedding", "kernel"), _CONV)
    m.leaf(p + "embeddings.position_embedding.weight", ("position_embedding",))
    _norm(m, p + "pre_layrnorm", ("pre_layrnorm",), _LN)
    for i in range(num_layers):
        lk, lp = f"{p}encoder.layers.{i}.", (f"layer_{i}",)
        _norm(m, lk + "layer_norm1", lp + ("layer_norm1",), _LN)
        _norm(m, lk + "layer_norm2", lp + ("layer_norm2",), _LN)
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(m, f"{lk}self_attn.{n}", lp + (n,))
        _dense(m, lk + "mlp.fc1", lp + ("fc1",))
        _dense(m, lk + "mlp.fc2", lp + ("fc2",))
    m.extra(p + "post_layernorm.weight", lambda sd: torch.ones_like(sd[p + "pre_layrnorm.weight"]))
    m.extra(p + "post_layernorm.bias", lambda sd: torch.zeros_like(sd[p + "pre_layrnorm.bias"]))


def clip_vision_from_jax(params: Mapping, num_layers: int = 24,
                         prefix: str = "vision_model.") -> StateDict:
    """JAX ``CLIPVisionEncoder`` params -> port ``CLIPVisionEncoder`` state
    dict (transformers ``CLIPVisionModel`` names under ``prefix``).
    ``post_layernorm`` is not in the JAX tree (only the safety checker's
    pooled output reads it): it comes out as the identity, scale 1, bias 0."""
    return _read(params, _clip_vision, num_layers, prefix)


def clip_vision_to_jax(sd: Mapping[str, torch.Tensor], num_layers: int = 24) -> dict:
    """Port ``CLIPVisionEncoder`` state dict -> JAX params (the
    ``sketch_encoder_model.npz`` tree); ``post_layernorm`` is left out."""
    return _write(sd, _clip_vision, num_layers, "vision_model.")


def _injection(m, config: UNetConfig) -> None:
    outers = []
    for i, ca in enumerate(config.cross_attn):
        outers += [f"down_{i}_attn_{j}" for j in range(config.layers_per_block)] if ca else []
    outers.append("mid_attn")
    for i, ca in enumerate(reversed(config.cross_attn)):
        outers += [f"up_{i}_attn_{j}" for j in range(config.layers_per_block + 1)] if ca else []
    for outer, (path, _) in zip(outers, injection_sites(config)):
        n, b = sat_name(path), (outer, "block_0")
        if m.has(n + ".sketch_proj", b + ("sketch_proj",)):
            _dense(m, n + ".sketch_proj", b + ("sketch_proj",))
        _norm(m, n + ".sketch_norm", b + ("sketch_norm",), _LN)
        for proj in ("to_q", "to_k", "to_v"):
            _dense(m, f"{n}.sketch_attn.{proj}", b + ("sketch_attn", proj))
        _dense(m, n + ".sketch_attn.to_out.0", b + ("sketch_attn", "to_out"))
        m.leaf(n + ".sketch_conv.weight", b + ("sketch_conv", "kernel"), _CONV1D)
        m.leaf(n + ".sketch_conv.bias", b + ("sketch_conv", "bias"))


def injection_from_jax(inj_params: Mapping, config: UNetConfig) -> StateDict:
    """JAX injection subtree (``down_{i}_attn_{j}`` / ``mid_attn`` /
    ``up_{i}_attn_{j}`` -> ``block_0`` -> ``sketch_*``) -> the state dict of
    the port's ``unet.sat``: the reference's ``sketch_attn_model.pt``
    layout."""
    return _read(inj_params, _injection, config)


def injection_to_jax(sd: Mapping[str, torch.Tensor], config: UNetConfig) -> dict:
    """The state dict of ``unet.sat`` -> the JAX injection subtree (the
    ``sketch_attn_model.npz`` tree)."""
    return _write(sd, _injection, config)


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


def _anime2sketch(m, num_downs: int) -> None:
    """The Sequential index of each level's down and up conv is 0 and 3 at
    the outermost level, 1 and 3 at the innermost, 1 and 5 between, and the
    submodule sits at 1 (outermost) or 3; both kernels go (kh, kw, a, b) <->
    (b, a, kh, kw)."""
    path, key = ("model",), "model.model"
    for level in range(num_downs):
        innermost = level == num_downs - 1
        down_i, up_i, sub_i = (0, 3, 1) if level == 0 else (1, 3, None) if innermost else (1, 5, 3)
        _conv(m, f"{key}.{down_i}", path + ("downconv",))
        _conv(m, f"{key}.{up_i}", path + ("upconv",))
        if sub_i is not None:
            path, key = path + ("submodule",), f"{key}.{sub_i}.model"


def anime2sketch_from_jax(params: Mapping, num_downs: int = 8) -> StateDict:
    """JAX ``UnetGenerator`` params -> port ``UnetGenerator`` state dict (the
    ``netG.pth`` layout). Inverts ``convert_torch_anime2sketch``."""
    return _read(params, _anime2sketch, num_downs)


def anime2sketch_to_jax(sd: Mapping[str, torch.Tensor], num_downs: int = 8) -> dict:
    """Port ``UnetGenerator`` state dict (``netG.pth``, no ``module.``
    prefix) -> JAX params (the ``anime2sketch.npz`` tree)."""
    return _write(sd, _anime2sketch, num_downs)
