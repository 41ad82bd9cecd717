"""YAML run-config loader — OmegaConf-substitute with attribute access.

A copy of ``sketch2img_tpu/core/config.py`` (the port imports nothing of the
JAX package): OmegaConf's dot-access surface over plain PyYAML, with the
config schema (name/model_path/train_epochs/batch_size/resolution/seed,
dataset/optimizer/monitor blocks — train.yaml:1-58).
"""

from __future__ import annotations

from typing import Any, Mapping

import yaml


class Config(dict):
    """dict with recursive attribute access (cfg.dataset.img_path)."""

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return Config(v) if isinstance(v, Mapping) and not isinstance(v, Config) else v

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node


def load_config(path: str) -> Config:
    with open(path) as f:
        return Config(yaml.safe_load(f))
