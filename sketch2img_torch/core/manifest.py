"""Checkpoint key inventories — counterpart of ``sketch2img_tpu/core/manifest.py``.

``assets/manifests/*.json`` (byte-identical copies of the JAX package's) hold
the key -> shape inventory of every published checkpoint the port loads: the
diffusers SD1.5 UNet, VAE and CLIP text encoder, the safety checker,
``edge_predictor.pt``, ``netG.pth``, ``sketch_attn_model.pt`` and the CLIP
ViT-L/14 of ``sketch_encoder_model.pt``. The port's modules keep the
checkpoints' parameter names, so a full-size load holds the state dict to
the manifest (``check_state_dict``) before ``load_state_dict(strict=True)``:
a drifted checkpoint fails with ``ConversionError`` listing every missing
and every unexpected key at once, where PyTorch's strict load would name
them without the published inventory to tell a renamed key from a foreign
one.
"""

from __future__ import annotations

import fnmatch
import json
import os
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

import torch

MANIFEST_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets", "manifests")

#: keys that may appear in real checkpoints but carry no loadable weight —
#: non-persistent-buffer leftovers from old torch/transformers versions.
DEFAULT_IGNORE: Tuple[str, ...] = (
    "*position_ids",          # transformers <4.31 persistent buffer
    "*num_batches_tracked",   # torch BatchNorm bookkeeping
)


class ConversionError(RuntimeError):
    """A checkpoint's key inventory doesn't match what the loader expects."""


def manifest_path(name: str) -> str:
    return os.path.join(MANIFEST_DIR, name + ".json")


def load_manifest(name: str) -> Dict[str, List[int]]:
    """A committed manifest: {key: shape list}, ``_meta`` stripped."""
    with open(manifest_path(name)) as f:
        data = json.load(f)
    return {k: v for k, v in data.items() if not k.startswith("_")}


def load_manifest_meta(name: str) -> dict:
    with open(manifest_path(name)) as f:
        return json.load(f).get("_meta", {})


def zeros_state_dict(manifest: Mapping[str, Sequence[int]],
                     dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """A synthetic checkpoint with the manifest's exact keys and shapes, on
    the meta device (no memory, so the full UNet inventory costs nothing)."""
    return {k: torch.zeros(tuple(shape), dtype=dtype, device="meta")
            for k, shape in manifest.items()}


def diff_keys(manifest: Mapping[str, Sequence[int]], state_dict: Mapping,
              ignore: Iterable[str] = DEFAULT_IGNORE) -> Tuple[List[str], List[str]]:
    """(missing, unexpected) of ``state_dict`` against the manifest."""
    def keep(k):
        return not any(fnmatch.fnmatch(k, pat) for pat in ignore)

    mk = {k for k in manifest if keep(k)}
    sk = {k for k in state_dict if keep(k)}
    return sorted(mk - sk), sorted(sk - mk)


def check_state_dict(name: str, state_dict: Mapping, *, what: str = "checkpoint",
                     strip_prefix: str = "") -> None:
    """Raise ``ConversionError`` with the full lists unless ``state_dict``
    has exactly the keys of manifest ``name`` (less ``DEFAULT_IGNORE`` and
    the manifest's optional keys) with its shapes. ``strip_prefix``: a
    prefix the loader accepts with or without (``netG.pth``'s
    DataParallel ``module.``), taken off both sides first."""
    manifest = load_manifest(name)
    optional = load_manifest_meta(name).get("optional_keys", [])

    def bare(k):
        return k[len(strip_prefix):] if strip_prefix and k.startswith(strip_prefix) else k

    manifest = {bare(k): v for k, v in manifest.items()}
    keys = {bare(k): v for k, v in state_dict.items()}
    missing, unexpected = diff_keys(manifest, keys, DEFAULT_IGNORE + tuple(map(bare, optional)))
    shapes = sorted(k for k in set(manifest) & set(keys)
                    if list(keys[k].shape) != list(manifest[k]))
    if missing or unexpected or shapes:
        raise ConversionError(
            f"{what} does not match the {name} manifest (assets/manifests/{name}.json): "
            f"{len(missing)} missing key(s) {missing}; {len(unexpected)} unexpected key(s) "
            f"{unexpected}; {len(shapes)} key(s) of another shape "
            f"{[(k, list(keys[k].shape), manifest[k]) for k in shapes]}")
