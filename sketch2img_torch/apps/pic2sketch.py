"""anime2sketch standalone CLI — counterpart of
``sketch2img_tpu/apps/pic2sketch.py``: a picture -> its line sketch with
the anime2sketch generator (``netG.pth``).

    python -m sketch2img_torch.apps.pic2sketch --weights weights/netG.pth \\
        --input picture.png --output sketch.png --load_size 512
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


@torch.no_grad()
def pic2sketch(gan, image, load_size: int = 768):
    """PIL image -> PIL sketch of the same size: RGB, bicubic to
    ``load_size``^2, the generator (on its own device), 1 - output binarised
    at 0.5, tiled to three channels, LANCZOS back to the input size."""
    from PIL import Image

    from sketch2img_torch.models.anime2sketch import binarize_sketch

    size = image.size
    img = image.convert("RGB").resize((load_size, load_size), Image.BICUBIC)
    arr = (np.asarray(img, np.float32) / 255.0 - 0.5) / 0.5
    dev = next(gan.parameters()).device
    x = torch.from_numpy(np.ascontiguousarray(arr.transpose(2, 0, 1)[None])).to(dev)
    out = binarize_sketch(gan(x).float())[0, 0].cpu().numpy()
    out3 = np.tile(out[:, :, None], (1, 1, 3))
    return Image.fromarray((out3 * 255).astype(np.uint8)).resize(size, Image.LANCZOS)


def main(argv=None) -> None:
    from PIL import Image

    from sketch2img_torch.models.anime2sketch import load_netg

    parser = argparse.ArgumentParser()
    parser.add_argument("--weights", type=str, default="weights/netG.pth")
    parser.add_argument("--input", type=str, required=True)
    parser.add_argument("--output", type=str, default="output.png")
    parser.add_argument("--load_size", type=int, default=512)
    args = parser.parse_args(argv)

    gan = load_netg(args.weights)
    img = pic2sketch(gan, Image.open(args.input), args.load_size)
    img.save(args.output)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
