"""Danbooru/yandere tag processing — a copy of ``sketch2img_tpu/data/tags.py``
(the port imports nothing of the JAX package).

Pure host-side string logic; uses the caller's ``random.Random`` instance so
tag dropout is reproducible under a seeded RNG.
"""

from __future__ import annotations

import random as _random
from typing import Dict, List, Optional, Sequence, Tuple

_BAD_META_TAGS = [
    "absurdres", "highres", "translation_request", "translated", "commentary",
    "commentary_request", "commentary_typo", "character_request", "bad_id",
    "bad_link", "bad_pixiv_id", "bad_twitter_id", "bad_tumblr_id",
    "bad_deviantart_id", "bad_nicoseiga_id", "md5_mismatch", "cosplay_request",
    "artist_request", "wide_image", "author_request", "artist_name",
]

_SKIP_TAGS = ["comic", "panels", "everyone", "sample_watermark", "text_focus",
              "text", "tagme"]


def process_tags(
    tags,
    *,
    yandere_tags: Optional[Dict] = None,
    important_tags: Sequence[str] = (),
    min_tags: int = 24,
    max_tags: int = 72,
    type_dropout: float = 0.75,
    keep_important: float = 1.00,
    keep_jpeg_artifacts: bool = True,
    sort_tags: bool = False,
    rng: Optional[_random.Random] = None,
) -> Tuple[str, bool]:
    """-> ("Tags: ...", skip_image), the reference dataset's process_tags."""
    rng = rng or _random
    yandere_tags = yandere_tags or {}

    if isinstance(tags, str):
        tags = tags.replace(",", " ").split(" ")
        tags = [t.strip() for t in tags if t != ""]
    final_tags: Dict[str, bool] = {}

    tag_dict = {tag: True for tag in tags}
    pure_tag_dict = {tag.split(":", 1)[-1]: tag for tag in tags}
    for bad_tag in _BAD_META_TAGS:
        if bad_tag in pure_tag_dict:
            del tag_dict[pure_tag_dict[bad_tag]]

    if ("rating:questionable" in tag_dict or "rating:explicit" in tag_dict
            or "nsfw" in tag_dict):
        final_tags["nsfw"] = True

    base_chosen: List[str] = []
    skip_image = False

    for tag in tag_dict.keys():
        if len(yandere_tags) <= 0 or tag not in yandere_tags:
            continue
        if int(yandere_tags[tag]["type"]) in [1, 3, 4, 5] and rng.random() < keep_important:
            base_chosen.append(tag)

    for tag in tag_dict.keys():
        parts = tag.split(":", 1)
        if parts[0] in important_tags and rng.random() < keep_important:
            base_chosen.append(tag)
        if parts[0] in ["artist", "copyright", "character"] and rng.random() < keep_important:
            base_chosen.append(tag)
        if (len(parts[-1]) > 1 and parts[-1][0] in ["1", "2", "3", "4", "5", "6"]
                and parts[-1][1:] in ["boy", "boys", "girl", "girls"]):
            base_chosen.append(tag)
        if parts[-1] in ["6+girls", "6+boys", "bad_anatomy", "bad_hands"]:
            base_chosen.append(tag)

    tag_count = min(rng.randint(min_tags, max_tags), len(tag_dict.keys()))
    base_chosen_set = set(base_chosen)
    chosen_tags = base_chosen + [
        t for t in rng.sample(list(tag_dict.keys()), tag_count)
        if t not in base_chosen_set
    ]
    if sort_tags:
        chosen_tags = sorted(chosen_tags)

    for tag in chosen_tags:
        tag = tag.replace(",", "").replace("_", " ")
        if rng.random() < type_dropout:
            if tag.startswith("artist:"):
                tag = tag[7:]
            elif tag.startswith("copyright:"):
                tag = tag[10:]
            elif tag.startswith("character:"):
                tag = tag[10:]
            elif tag.startswith("general:"):
                tag = tag[8:]
        if tag.startswith("meta:"):
            tag = tag[5:]
        final_tags[tag] = True

    for bad_tag in _SKIP_TAGS:
        if bad_tag in pure_tag_dict:
            skip_image = True
    if not keep_jpeg_artifacts and "jpeg_artifacts" in tag_dict:
        skip_image = True

    return "Tags: " + ", ".join(list(final_tags.keys())), skip_image
