"""LGP sketch-guided demo — counterpart of ``sketch2img_tpu/apps/app.py``.

``build_pipeline`` loads a diffusers-format SD1.x directory and an
``edge_predictor.pt`` into a ``SketchGuidedPipeline`` (bf16 weights, LGP
fp32); ``inference`` is the demo's callback (the Gradio controls: prompt and
negative, guidance, steps, size, seed, sketchpad and strength). ``main()``
serves the Gradio UI when gradio is installed, and with ``--prompt`` renders
one image headless:

    python -m sketch2img_torch.apps.app --model_path sd15/ \\
        --lgp_weights edge_predictor.pt --prompt "1girl" --sketch sketch.png
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def build_pipeline(model_path: str, lgp_weights: str, mesh=None, **components_kw):
    """``SDComponents.from_diffusers_dir(model_path, **components_kw)`` (bf16
    on the card unless ``compute_dtype``/``device`` say otherwise), then the
    LGP from ``lgp_weights``, wrapped in a ``SketchGuidedPipeline`` over
    ``mesh`` (a ``parallel.make_mesh()`` mesh, or None for one device)."""
    from sketch2img_torch.runtime import SDComponents, SketchGuidedPipeline

    c = SDComponents.from_diffusers_dir(model_path, **components_kw)
    c.load_lgp_torch(lgp_weights)
    return SketchGuidedPipeline(c, mesh=mesh)


def inference(pipe, prompt, guidance, steps, width=512, height=512, seed=0,
              strength=0.5, neg_prompt="", spimg=None):
    """The demo's callback -> (uint8 (H, W, 3) image, None). ``spimg``: a
    uint8 or float grayscale sketchpad (taken to [0, 1]); ``strength`` is
    accepted and unused, as in the JAX demo."""
    sketch = None
    if spimg is not None:
        arr = np.asarray(spimg, np.float32)
        if arr.max() > 1.0:
            arr = arr / 255.0
        sketch = arr
    img = pipe(
        prompt,
        negative_prompt=neg_prompt,
        num_inference_steps=int(steps),
        guidance_scale=guidance,
        width=int(width),
        height=int(height),
        seed=int(seed),
        sketch_image=sketch,
    )
    return (img * 255).astype(np.uint8), None


def launch_gradio(pipe):
    import gradio as gr

    with gr.Blocks() as demo:
        gr.HTML("<h1>sketch2img (PyTorch/CUDA)</h1>")
        with gr.Row():
            with gr.Column(scale=55):
                prompt = gr.Textbox(label="Prompt", max_lines=2)
                neg_prompt = gr.Textbox(label="Negative Prompt", max_lines=2)
                generate = gr.Button(value="Generate")
                image_out = gr.Image(height=512)
                error_output = gr.Markdown()
            with gr.Column(scale=45):
                with gr.Tab("Options"):
                    guidance = gr.Slider(label="Guidance scale", value=7.5, maximum=15)
                    steps = gr.Slider(label="Steps", value=25, minimum=2, maximum=75, step=1)
                    width = gr.Slider(label="Width", value=512, minimum=64, maximum=1024, step=8)
                    height = gr.Slider(label="Height", value=512, minimum=64, maximum=1024,
                                       step=8)
                    seed = gr.Slider(0, 2147483647, label="Seed (0 = random)", value=0, step=1)
                with gr.Tab("SketchPad"):
                    sp = gr.Sketchpad()
                    strength = gr.Slider(label="Transformation strength", minimum=0, maximum=1,
                                         step=0.01, value=0.5)

        inputs = [prompt, guidance, steps, width, height, seed, strength, neg_prompt, sp]

        def _fn(*a):
            return inference(pipe, *a)

        generate.click(_fn, inputs=inputs, outputs=[image_out, error_output])
        prompt.submit(_fn, inputs=inputs, outputs=[image_out, error_output])
    demo.launch(debug=True, share=False)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--lgp_weights", type=str, default="edge_predictor.pt")
    parser.add_argument("--prompt", type=str, default=None,
                        help="headless: render one image and exit")
    parser.add_argument("--negative_prompt", type=str, default="")
    parser.add_argument("--sketch", type=str, default=None)
    parser.add_argument("--steps", type=int, default=25)
    parser.add_argument("--guidance", type=float, default=7.5)
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--height", type=int, default=512)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--output", type=str, default="output.png")
    args = parser.parse_args(argv)

    start = time.time()
    pipe = build_pipeline(args.model_path, args.lgp_weights)
    print(f"pipeline built in {time.time() - start:.2f} seconds")

    if args.prompt is not None:
        from PIL import Image

        spimg = None
        if args.sketch:
            spimg = np.asarray(Image.open(args.sketch).convert("L"))
        img, _ = inference(pipe, args.prompt, args.guidance, args.steps, args.width,
                           args.height, args.seed, neg_prompt=args.negative_prompt,
                           spimg=spimg)
        Image.fromarray(img).save(args.output)
        print(f"wrote {args.output}")
        return

    try:
        import gradio  # noqa: F401
    except ImportError:
        parser.error("gradio not installed — pass --prompt for headless mode")
    launch_gradio(pipe)


if __name__ == "__main__":
    main()
