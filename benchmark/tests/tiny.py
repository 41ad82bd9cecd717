"""Tiny configurations and traffic for the CPU tests: the real cells' files
with every width cut down, run through the same harness on the CPU."""

from __future__ import annotations

import copy

from benchmark.harness import core

TINY = {
    "unet": {"block_out_channels": [32, 32, 64, 64], "layers_per_block": 2,
             "attention_head_dim": 2, "cross_attention_dim": 32, "in_channels": 4,
             "out_channels": 4, "sample_size": 8},
    "vae": {"block_out_channels": [32, 32, 32, 32], "layers_per_block": 1,
            "latent_channels": 4, "scaling_factor": 0.18215},
    "text_encoder": {"vocab_size": 49408, "hidden_size": 32, "num_hidden_layers": 1,
                     "num_attention_heads": 2, "intermediate_size": 64,
                     "max_position_embeddings": 77},
    "safety_checker": {"image_size": 28, "patch_size": 14, "hidden_size": 32,
                       "num_hidden_layers": 1, "num_attention_heads": 2,
                       "intermediate_size": 64, "projection_dim": 16, "concepts": 3,
                       "special": 1},
    "vision": {"image_size": 28, "patch_size": 14, "hidden_size": 32, "num_hidden_layers": 1,
               "num_attention_heads": 2, "intermediate_size": 64},
    "lgp": {"widths": [512, 256, 128, 64], "output_dim": 4},
    "anime2sketch": {"num_downs": 5, "ngf": 4},
}


def tiny_cell(name: str, **traffic) -> core.Cell:
    """The cell ``name`` of BENCHMARK.json with its configuration's widths
    cut to TINY (float32 throughout) and ``traffic`` overriding its mix."""
    cell = core.find_cell(name)
    cfg = copy.deepcopy(cell.config)
    for key in list(cfg):
        if key in TINY:
            cfg[key] = copy.deepcopy(TINY[key])
    cfg["dtypes"] = {k: "float32" for k in cfg["dtypes"]}
    tr = copy.deepcopy(cell.traffic)
    tr.update(traffic)
    return core.Cell(cell.name, cfg, tr, cell.limits, cell.chips, cell.end_to_end,
                     cell.per_layer)
