"""Seeded inputs of the cells: prompts, sketches, the per-request seeds,
the training images with their captions, and the stand-in tokenizer.

Why it is here: the benchmark makes every input from ``--seed`` and hands
the same ones to the port and to the reference. Request ``i`` of a run is
a pure function of (seed, i), so the output check can rebuild the inputs
of any request it samples. ``StandInTokenizer`` and the stroke sketch are
copies of ``chip_smoke.py``'s, so later changes to that file cannot move
them: no CLIP vocabulary ships with the repository, and the text encoder
always sees padded ids, so its work does not depend on which ids they are.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

TAGS = ("1girl solo long_hair looking_at_viewer smile short_hair open_mouth blue_eyes "
        "skirt brown_hair hat dress thighhighs ribbon sitting outdoors sky tree flower "
        "school_uniform jacket holding standing cloud sword wings water lineart sketch "
        "monochrome greyscale traditional_media upper_body full_body from_side").split()


class StandInTokenizer:
    """[bos] + byte-derived ids + [eos], eos-padded to ``max_length``."""

    pad_token_id = 49407

    class _Out:
        def __init__(self, ids):
            self.input_ids = ids

    def __call__(self, text, padding=None, truncation=None, max_length=77):
        def encode(s):
            ids = [49406] + [256 + (ord(ch) % 1000) for ch in s][: max_length - 2] + [49407]
            return ids + [self.pad_token_id] * (max_length - len(ids))

        return self._Out(encode(text) if isinstance(text, str) else [encode(s) for s in text])


def rng_for(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2 ** 63)] + [k % (2 ** 32) for k in key])


def prompt(rng: np.random.Generator, n_tags: int = 12) -> str:
    return ", ".join(rng.choice(TAGS, n_tags, replace=False))


def request_seed(rng: np.random.Generator) -> int:
    """A non-zero int32 seed (0 asks the pipelines for a random one)."""
    return int(rng.integers(1, 2 ** 31 - 1))


def stroke_sketch(rng: np.random.Generator, px: int, strokes: int = 6) -> np.ndarray:
    """(px, px) float32 sketchpad in [0, 1]: ``strokes`` straight bars, each
    12/512 of the pad wide, at seeded places, on a zero pad."""
    pad = np.zeros((px, px), np.float32)
    w = max(1, px * 12 // 512)
    for _ in range(strokes):
        a, b = sorted(rng.integers(px // 8, px - px // 8, 2))
        c = int(rng.integers(px // 8, px - px // 8 - w))
        if rng.random() < 0.5:
            pad[a:b + w, c:c + w] = 1.0
        else:
            pad[c:c + w, a:b + w] = 1.0
    return pad


def caption(rng: np.random.Generator) -> str:
    """A tag list long enough to fill 225 ids (three text windows)."""
    return ", ".join(rng.choice(TAGS, 30, replace=True))


def training_images(seed: int, start: int, count: int, size: int, device) -> torch.Tensor:
    """(count, size, size, 3) uint8 images ``start`` .. ``start + count`` of
    a run: smooth colour fields with a dozen dark strokes each, made on
    ``device`` (image i depends on (seed, i) alone)."""
    out = []
    for i in range(start, start + count):
        g = torch.Generator(device=device).manual_seed((int(seed) * 7919 + i) % (2 ** 62))
        coarse = torch.rand(1, 3, 10, 10, generator=g, device=device)
        img = torch.nn.functional.interpolate(coarse, size=(size, size), mode="bilinear",
                                              align_corners=False)[0]
        pos = torch.rand(12, 2, generator=g, device=device)
        for r, c in (pos * torch.tensor([size - 8, size * 0.6], device=device)).long().tolist():
            img[:, r:r + max(1, size // 128), c:c + size * 2 // 5] = 0.05
        out.append(img)
    return (torch.stack(out).permute(0, 2, 3, 1) * 255).round().to(torch.uint8)


def write_dataset(folder: str, seed: int, count: int, size: int, device,
                  chunk: int = 64) -> List[str]:
    """``count`` JPEG images (quality 95) with ``.txt`` captions in
    ``folder``; -> the image paths in index order."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    paths = [os.path.join(folder, f"im{i:05d}.jpg") for i in range(count)]

    def save(args):
        i, arr = args
        Image.fromarray(arr).save(paths[i], quality=95)
        with open(paths[i][:-4] + ".txt", "w") as f:
            f.write(caption(rng_for(seed, 3, i)))

    with ThreadPoolExecutor(4) as pool:
        for start in range(0, count, chunk):
            n = min(chunk, count - start)
            arrs = training_images(seed, start, n, size, device).cpu().numpy()
            list(pool.map(save, [(start + j, arrs[j]) for j in range(n)]))
    return paths
