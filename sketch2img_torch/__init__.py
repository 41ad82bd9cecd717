"""sketch2img_torch — the PyTorch/CUDA port of sketch2img_tpu.

Same sub-package layout as the JAX package (core, data, ops, models,
pipelines, apps, utils) with PyTorch idiom inside: nn.Modules with
diffusers parameter names in NCHW, an explicit ``device`` and
``torch.Generator``, and hand-written CUDA kernels (``csrc/``) for the
flash attention and the fused GroupNorm+SiLU. Entry
points run on ``device="cuda"`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
