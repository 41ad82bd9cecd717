"""ImageStore — a copy of ``sketch2img_tpu/data/dataset.py`` (the port imports
nothing of the JAX package): PIL + numpy, NHWC float32 pixels in [-1, 1]
that the trainers move to the device and permute to NCHW. The process rank
is passed in (``rank``), not read from a runtime.

Recursive image-folder dataset with sidecar ``.txt`` captions, tag
filtering/dropout, resize+crop+normalize transforms, no-pad tokenize with
pad-in-collate, optional latent cache, duplicate entries via random hex
prefixes.
"""

from __future__ import annotations

import binascii
import json
import os
import random
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
from PIL import Image

from sketch2img_torch.data.tags import process_tags

_IMG_SUFFIXES = [".jpg", ".png", ".webp", ".bmp", ".gif", ".jpeg", ".tiff"]


def _resize_shorter(img: Image.Image, size: int) -> Image.Image:
    """torchvision Resize(size) semantics: shorter side -> size, keep AR."""
    w, h = img.size
    if w <= h:
        nw, nh = size, max(size, int(round(h * size / w)))
    else:
        nw, nh = max(size, int(round(w * size / h))), size
    return img.resize((nw, nh), Image.LANCZOS)


def _crop(img: Image.Image, size: int, center: bool, rng: random.Random) -> Image.Image:
    w, h = img.size
    if center:
        left, top = (w - size) // 2, (h - size) // 2
    else:
        left = rng.randint(0, max(0, w - size))
        top = rng.randint(0, max(0, h - size))
    return img.crop((left, top, left + size, top + size))


class ImageStore:
    """See module docstring. API mirrors the reference where meaningful:
    ``update_store``, ``tokenize``, ``read_img``, ``collate_fn``,
    ``cache_latents``, ``__len__``, ``__getitem__``."""

    def __init__(
        self,
        img_path: Sequence,
        size: int = 512,
        center_crop: bool = False,
        max_length: int = 225,
        ucg: float = 0.0,
        rank: int = 0,
        seed: int = 42,
        process_tags: bool = True,
        tokenizer: Any = None,
        important_tags: Sequence[str] = (),
        allow_duplicates: bool = False,
        **kwargs,
    ):
        self.size = size
        self.filter_tags = process_tags
        self.center_crop = center_crop
        self.ucg = ucg
        self.max_length = max_length
        self.tokenizer = tokenizer
        self.rank = rank
        self.dataset = img_path
        self.use_latent_cache = False
        self.allow_duplicates = allow_duplicates
        self.important_tags = list(important_tags)
        self.rng = random.Random(seed)

        self.yandere_tags: Dict = {}
        self.latents_cache: Dict[str, np.ndarray] = {}
        # https://huggingface.co/datasets/nyanko7/yandere-images (dataset.py:58-62)
        if Path("yandere-tags.json").is_file():
            with open("yandere-tags.json") as f:
                self.yandere_tags = json.loads(f.read())

        self.update_store()

    # -- corpus scan (dataset.py:66-103) --------------------------------

    def prompt_resolver(self, x) -> tuple:
        fp = os.path.splitext(str(x))[0]
        with open(fp + ".txt") as f:
            return str(x), f.read()

    def update_store(self) -> None:
        self.entries: List[tuple] = []
        folders: List = []
        for entry in self.dataset:
            if self.allow_duplicates and not isinstance(entry, str):
                folders.extend([entry[0] for _ in range(entry[1])])
            else:
                folders.append(entry)

        for entry in folders:
            for x in sorted(Path(entry).rglob("*")):
                if not (x.is_file() and x.suffix in _IMG_SUFFIXES):
                    continue
                img, prompt = self.prompt_resolver(x)
                _, skip = self.process_tags(prompt)
                if skip:
                    continue
                if self.allow_duplicates:
                    prefix = binascii.hexlify(os.urandom(5)).decode()
                    img = f"{prefix}@{img}"
                self.entries.append((img, prompt))

        self._length = len(self.entries)
        self.rng.shuffle(self.entries)

    # -- per-item processing ---------------------------------------------

    def process_tags(self, tags):
        if not self.filter_tags:
            return tags, False
        return process_tags(
            tags,
            yandere_tags=self.yandere_tags,
            important_tags=self.important_tags,
            rng=self.rng,
        )

    def read_img(self, filepath: str) -> Image.Image:
        if self.allow_duplicates and "@" in filepath:
            filepath = filepath[filepath.index("@") + 1:]
        img = Image.open(filepath)
        if img.mode != "RGB":
            img = img.convert("RGB")
        return img

    def transform(self, img: Image.Image) -> np.ndarray:
        """Resize(LANCZOS) + (center|random) crop + [0,1] + Normalize(0.5)
        (dataset.py:45-52). Returns (H, W, 3) float32 NHWC in [-1, 1]."""
        img = _resize_shorter(img, self.size)
        img = _crop(img, self.size, self.center_crop, self.rng)
        arr = np.asarray(img, np.float32) / 255.0
        return (arr - 0.5) / 0.5

    def tokenize(self, prompt: str) -> List[int]:
        """No padding here — handled in collate_fn (dataset.py:114-123)."""
        return self.tokenizer(
            prompt, padding="do_not_pad", truncation=True,
            max_length=self.max_length,
        ).input_ids

    def cache_latents(self, encode_fn, sketch_fn=None, *,
                      key: str = "latent_dist",
                      sketch_key: str = "sketch_latent_dist") -> None:
        """Optionally precompute latents: encode_fn(pixels NHWC (1,H,W,3))
        -> (1,h,w,C) — typically the VAE's (mean ‖ logvar) moments so each
        train step still draws a fresh latent sample (implements the
        dataset.py:105-112 path the reference never wires up — here it
        actually works). ``sketch_fn`` (same signature) additionally caches
        the anime2sketch->VAE sketch moments the LGP trainer needs, removing
        both the GAN and every VAE encode from the train step.

        NOTE: caching fixes ONE crop per image for the whole run. With
        ``center_crop=False`` the uncached path re-draws a random crop
        every epoch, so enabling the cache trades that augmentation for
        throughput (latent sampling stays stochastic either way)."""
        if not self.center_crop:
            print("cache_latents: random-crop augmentation is frozen to one "
                  "crop per image for this run (center_crop=False)",
                  flush=True)
        self.use_latent_cache = True
        self.cache_key, self.sketch_cache_key = key, sketch_key
        self.sketch_cache: Dict[str, np.ndarray] = {}
        for img_path, _ in self.entries:
            px = self.transform(self.read_img(img_path))[None]
            self.latents_cache[img_path] = np.asarray(encode_fn(px))[0]
            if sketch_fn is not None:
                self.sketch_cache[img_path] = np.asarray(sketch_fn(px))[0]

    # -- batching ---------------------------------------------------------

    def collate_fn(self, examples: List[dict], pad_to: Optional[int] = None) -> dict:
        """Pad ids to batch max (or ``pad_to`` for static jit shapes) with the
        tokenizer pad id; stack pixels (dataset.py:204-211)."""
        pad_id = getattr(self.tokenizer, "pad_token_id", 0) or 0
        ids = [e["prompt_ids"] for e in examples]
        width = pad_to or max(len(r) for r in ids)
        input_ids = np.full((len(ids), width), pad_id, np.int32)
        for i, r in enumerate(ids):
            input_ids[i, : len(r)] = r[:width]
        out = {"input_ids": input_ids}
        for k in examples[0]:
            if k == "prompt_ids":
                continue
            name = "pixels" if k == "images" else k
            out[name] = np.stack([e[k] for e in examples]).astype(np.float32)
        return out

    # -- aspect-ratio bucketing (the reference's dead arb: block, made real) --

    def enable_arb(self, arb_config: Optional[dict] = None) -> dict:
        """Assign every entry to an AR bucket (data/arb.py). Returns
        {index: (w, h)}. Use with BucketBatcher + collate of bucketed items."""
        from sketch2img_torch.data.arb import assign_bucket, generate_buckets

        cfg = dict(arb_config or {})
        buckets = generate_buckets(
            base_res=cfg.get("base_res", (self.size, self.size)),
            max_size=cfg.get("max_size", (768, 512)),
            divisible=cfg.get("divisible", 64),
            min_dim=cfg.get("min_dim", 256),
            dim_limit=cfg.get("dim_limit", 1024),
        )
        self.arb_assignments = {}
        for idx, (path, _) in enumerate(self.entries):
            with Image.open(self._real_path(path)) as im:
                w, h = im.size
            bucket = assign_bucket(w, h, buckets, cfg.get("max_ar_error", 4.0))
            if bucket is not None:
                self.arb_assignments[idx] = bucket
        return self.arb_assignments

    def _real_path(self, filepath: str) -> str:
        if self.allow_duplicates and "@" in filepath:
            return filepath[filepath.index("@") + 1:]
        return filepath

    def transform_bucket(self, img: Image.Image, bucket) -> np.ndarray:
        """Resize-to-cover the bucket resolution, then crop. -> (H, W, 3)."""
        bw, bh = bucket
        w, h = img.size
        s = max(bw / w, bh / h)
        img = img.resize((max(bw, int(round(w * s))), max(bh, int(round(h * s)))),
                         Image.LANCZOS)
        w, h = img.size
        if self.center_crop:
            left, top = (w - bw) // 2, (h - bh) // 2
        else:
            left = self.rng.randint(0, max(0, w - bw))
            top = self.rng.randint(0, max(0, h - bh))
        arr = np.asarray(img.crop((left, top, left + bw, top + bh)), np.float32) / 255.0
        return (arr - 0.5) / 0.5

    def get_bucketed(self, index: int, bucket) -> dict:
        path, prompt = self.entries[index % self._length]
        if self.ucg and self.rng.random() < self.ucg:
            prompt = ""
        return {
            "images": self.transform_bucket(self.read_img(path), bucket),
            "prompt_ids": self.tokenize(prompt),
        }

    def __len__(self) -> int:
        return self._length

    def __getitem__(self, index: int) -> dict:
        path, prompt = self.entries[index % self._length]
        example: Dict[str, Any] = {}
        if self.use_latent_cache:
            example[self.cache_key] = self.latents_cache[path]
            if self.sketch_cache:
                example[self.sketch_cache_key] = self.sketch_cache[path]
        else:
            example["images"] = self.transform(self.read_img(path))
        if self.ucg and self.rng.random() < self.ucg:
            prompt = ""
        example["prompt_ids"] = self.tokenize(prompt)
        return example
