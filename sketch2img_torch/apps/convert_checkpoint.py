"""One-time checkpoint conversion — counterpart of
``sketch2img_tpu/apps/convert_checkpoint.py``: a diffusers-format SD1.x
directory (plus an optional ``edge_predictor.pt`` and an optional anime2sketch
``netG.pth``) -> a native npz directory (``SDComponents.save_native``, and
``anime2sketch.npz`` with ``--netg``), float32, which both packages'
``from_native`` load.

    python -m sketch2img_torch.apps.convert_checkpoint --model_path sd15/ \\
        --lgp_weights edge_predictor.pt --netg netG.pth --output native/
"""

from __future__ import annotations

import argparse
import os

import torch


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_path", type=str, required=True,
                        help="diffusers-format SD1.x dir")
    parser.add_argument("--lgp_weights", type=str, default=None,
                        help="edge_predictor.pt (optional)")
    parser.add_argument("--netg", type=str, default=None,
                        help="anime2sketch netG.pth (optional)")
    parser.add_argument("--output", type=str, required=True)
    args = parser.parse_args(argv)

    from sketch2img_torch.core.convert import anime2sketch_to_jax
    from sketch2img_torch.models.anime2sketch import strip_module_prefix
    from sketch2img_torch.runtime import SDComponents
    from sketch2img_torch.train.checkpoint import export_params_npz

    c = SDComponents.from_diffusers_dir(args.model_path, compute_dtype=torch.float32)
    if args.lgp_weights:
        c.load_lgp_torch(args.lgp_weights)
    c.save_native(args.output)

    if args.netg:
        sd = torch.load(args.netg, map_location="cpu", weights_only=True)
        export_params_npz(os.path.join(args.output, "anime2sketch.npz"),
                          anime2sketch_to_jax(strip_module_prefix(sd.get("state_dict", sd))))

    print(f"wrote native checkpoint to {args.output}")


if __name__ == "__main__":
    main()
