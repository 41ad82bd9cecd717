"""Two-process (gloo, CPU) scenarios of the PyTorch port's distribution, and
the tiny port-only stacks they and their one-process references share.

``python tests/torch_dist_workers.py SCENARIO RANK WORLD INIT_FILE OUT_DIR``
joins a gloo group through the rendezvous file, runs the scenario on this
rank and ``torch.save``s what it computed to ``OUT_DIR/SCENARIO_RANK.pt``.
``spawn`` starts every rank of a scenario at once and waits for them. The
module imports nothing of JAX, so a worker starts in the time PyTorch takes
to import.
"""

import copy
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PX = 32  # image side of every scenario (16^2 latents: a flash site at level 0)
TRAIN_BATCH = 4  # the trainers' global batch
VISION_KW = dict(image_size=224, patch_size=14, hidden_size=32, num_layers=2, num_heads=4,
                 intermediate_size=64)


def spawn(scenario: str, tmp_path, world: int = 2, timeout: float = 240.0) -> list:
    """Run ``scenario`` on ``world`` gloo ranks (one process each, started
    together). -> each rank's saved results, in rank order."""
    init = os.path.join(str(tmp_path), f"rdzv_{scenario}")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([REPO, HERE]),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), scenario, str(r),
                               str(world), init, str(tmp_path)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            p.kill()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {scenario} failed:\n{out}\n{err}"
    return [torch.load(os.path.join(str(tmp_path), f"{scenario}_{r}.pt"), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# tiny stacks (port only, fp32, CPU)
# ---------------------------------------------------------------------------


def components(seed: int = 0):
    """A tiny SD stack with an LGP and a stand-in tokenizer, drawn from
    ``seed`` (the same weights on every rank and in the test process)."""
    from fakes import FakeTokenizer
    from sketch2img_torch.models.clip_text import CLIPTextConfig
    from sketch2img_torch.models.unet import UNetConfig
    from sketch2img_torch.models.vae import VAEConfig
    from sketch2img_torch.runtime import SDComponents

    c = SDComponents.random_init(
        seed=seed, compute_dtype=torch.float32, random_weights=True, device="cpu",
        unet_config=UNetConfig(block_out_channels=(32, 32, 64), cross_attn=(True, True, False),
                               layers_per_block=1, num_heads=2, cross_attention_dim=32),
        vae_config=VAEConfig(block_out_channels=(32, 64), layers_per_block=1),
        text_config=CLIPTextConfig(vocab_size=100, hidden_size=32, intermediate_size=64,
                                   num_layers=2, num_heads=4))
    c.tokenizer = FakeTokenizer()
    return c


def vision_config():
    from sketch2img_torch.models.clip_vision import CLIPVisionConfig

    return CLIPVisionConfig(**VISION_KW)


def gan(seed: int = 4):
    from sketch2img_torch.models.anime2sketch import create_anime2sketch

    torch.manual_seed(seed)
    return create_anime2sketch(5, 4).eval().requires_grad_(False)


def train_batch(seed: int = 0) -> dict:
    """The trainers' global batch (B=4): token ids and NCHW pixels."""
    rng = np.random.RandomState(seed)
    return {"input_ids": torch.from_numpy(rng.randint(0, 100, (TRAIN_BATCH, 12))).long(),
            "pixels": torch.from_numpy(rng.uniform(-1, 1, (TRAIN_BATCH, 3, PX, PX))
                                       .astype(np.float32))}


def train_steps(c, g, batch: dict, mesh=None) -> dict:
    """One LGP step and one injection step with SGD (lr 1024: the update
    carries the gradient at full precision) from fixed weights and draw
    generators, on ``batch`` (this rank's rows under ``mesh``). -> losses,
    the updated trainables and the LGP's BatchNorm running statistics."""
    from sketch2img_torch.apps.train_attn_inject import injected_unet
    from sketch2img_torch.models.clip_vision import CLIPVisionEncoder
    from sketch2img_torch.models.lgp import LatentEdgePredictor, sync_batch_stats
    from sketch2img_torch.models.unet import tap_channels
    from sketch2img_torch.train.train_attn_inject import inject_train_step, mark_trainables
    from sketch2img_torch.train.train_lgp import Frozen, lgp_train_step

    frozen = Frozen(c.unet, c.vae, c.text_encoder, g, c.schedule)
    torch.manual_seed(7)
    lgp = LatentEdgePredictor(input_dim=tap_channels(c.unet.config) + 4 + 36)
    if mesh is not None:
        sync_batch_stats(lgp, mesh.data_group)
    opt = torch.optim.SGD(lgp.parameters(), lr=1024.0)
    lgp_loss = lgp_train_step(lgp, opt, frozen, batch, mesh=mesh, sketch_fixed_size=PX,
                              generator=torch.Generator().manual_seed(8))
    torch.manual_seed(9)
    clip = CLIPVisionEncoder(vision_config())
    unet = injected_unet(c, clip.config.hidden_size, seed=10)
    trainables = mark_trainables(unet, clip)
    opt = torch.optim.SGD(trainables.values(), lr=1024.0)
    inj_loss = inject_train_step(unet, clip, opt, Frozen(None, c.vae, c.text_encoder, g,
                                                         c.schedule),
                                 batch, mesh=mesh, sketch_fixed_size=PX,
                                 clip_image_size=VISION_KW["image_size"],
                                 generator=torch.Generator().manual_seed(11))
    return {"lgp_loss": float(lgp_loss), "inject_loss": float(inj_loss),
            "lgp": {k: v.clone() for k, v in lgp.state_dict().items()},
            "inject": {k: v.detach().clone() for k, v in trainables.items()}}


def write_images(folder: str, n: int = 2 * TRAIN_BATCH) -> str:
    """``n`` captioned images (an epoch of two global batches)."""
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    rng = np.random.RandomState(0)
    for i in range(n):
        Image.fromarray(rng.randint(0, 255, (36 + 2 * i, 40, 3), np.uint8)).save(
            os.path.join(folder, f"{i}.png"))
        with open(os.path.join(folder, f"{i}.txt"), "w") as f:
            f.write(f"1girl solo tag{i}")
    return folder


def train_app(c, g, folder: str, out: str, mesh=None):
    """``train_lgp`` for one epoch (two global batches of 4) on ``folder``,
    checkpoints and exports under ``out``. -> its ``TrainResult``."""
    from sketch2img_torch.apps.train_lgp import train_lgp

    cfg = dict(name="tiny", train_epochs=1, batch_size=TRAIN_BATCH, resolution=PX, seed=3,
               dataset=dict(img_path=[folder], center_crop=True, max_length=12,
                            process_tags=False),
               optimizer=dict(name="adamw", params=dict(lr=1e-3, weight_decay=1e-2, eps=1e-8)),
               checkpoint_dir=os.path.join(out, "checkpoints"),
               output_dir=os.path.join(out, "out"), checkpoint_every=100, log_every=1)
    return train_lgp(cfg, c, g, sketch_fixed_size=PX, device="cpu", mesh=mesh,
                     log=lambda msg: None)


def sketch(flip: bool = False) -> np.ndarray:
    s = np.zeros((PX, PX), np.float32)
    s[8:24, 14:18] = 1.0
    return s[::-1].copy() if flip else s


def pipeline_calls(pipe, inject) -> dict:
    """The data-parallel scenario's calls (the test process makes them
    without a mesh): text-to-image at batch 2, the injection route at batch
    2, two guided steps at batch 2, and batch 3 with per-image seeds (one
    pad row at two ranks) with its callback's latents."""
    kw = dict(width=PX, height=PX)
    out = {"text2img": pipe(["a", "b"], num_inference_steps=2, seed=3, **kw),
           "inject": inject(["a", "b"], num_inference_steps=2, seed=[4, 5], strength=[0.5, 0.8],
                            spimg=[sketch(), sketch(True)], **kw),
           "guided": pipe(["a", "b"], num_inference_steps=2, seed=[6, 7],
                          sketch_image=[sketch(), sketch(True)], **kw)}
    seen = []
    out["padded"] = pipe(["p", "q", "r"], num_inference_steps=2, seed=[8, 9, 10],
                         callback=lambda i, t, x: seen.append(x.clone()), **kw)
    out["callback"] = seen
    return out


def guided_pass(c, seed: int = 12) -> tuple:
    """The differentiated half of a guided step on fixed inputs: eps and
    the gradient of the LGP loss w.r.t. the latent."""
    from sketch2img_torch.core.schedulers import get_noise_level
    from sketch2img_torch.models.lgp import lgp_fused_apply

    gen = torch.Generator().manual_seed(seed)
    h = PX // c.vae_scale_factor
    x = torch.randn(2, 4, h, h, generator=gen).requires_grad_(True)
    target = 0.2 * torch.randn(2, 4, h, h, generator=gen)
    ctx = torch.randn(2, 77, 32, generator=gen)
    t = torch.tensor([801, 501])
    eps, taps = c.unet(x, t, ctx, capture_taps=True)
    out = lgp_fused_apply(c.lgp, taps, get_noise_level(c.schedule, x.detach(), t), h, h)
    (g,) = torch.autograd.grad(torch.mean((target - out) ** 2), x)
    return eps.detach(), g


# ---------------------------------------------------------------------------
# the scenarios, one rank each
# ---------------------------------------------------------------------------


def scenario_train(mesh, out_dir) -> dict:
    c, g = components(), gan()
    out = train_steps(c, g, {k: v[mesh.data_index::mesh.shape["data"]]
                             for k, v in train_batch().items()}, mesh)
    run = train_app(c, g, os.path.join(out_dir, "images"), os.path.join(out_dir, "app"), mesh)
    out["app"] = {"losses": run.losses, "checkpoint": run.checkpoint, "exports": run.exports}
    return out


def scenario_pipeline(mesh, out_dir) -> dict:
    from sketch2img_torch.apps.clip_guided_inf import ClipGuidedPipeline
    from sketch2img_torch.runtime import SketchGuidedPipeline

    c = components()
    pipe = SketchGuidedPipeline(c, mesh=mesh)
    inject = ClipGuidedPipeline(components=c, clip_config=vision_config(), mesh=mesh)
    out = pipeline_calls(pipe, inject)
    try:
        pipe(["a", "b", "c"], num_inference_steps=1, seed=3, width=PX, height=PX)
    except ValueError as e:
        out["scalar_seed_error"] = str(e)
    out["dp"] = pipe._dp
    return out


def scenario_tp(mesh, out_dir) -> dict:
    from sketch2img_torch.ops import attention
    from sketch2img_torch.runtime import SketchGuidedPipeline

    c = components()
    pipe = SketchGuidedPipeline(c, mesh=mesh)
    heads = sorted({m.heads for m in c.unet.modules() if hasattr(m, "tp_size")})
    eps, g = guided_pass(c)
    img = pipe("a", num_inference_steps=2, seed=3, width=PX, height=PX, sketch_image=sketch())
    attention.set_tensor_parallel_context(None)
    return {"eps": eps, "grad": g, "image": img, "local_heads": heads,
            "to_q": c.unet.down_blocks[0].attentions[0].transformer_blocks[0]
            .attn1.to_q.weight.clone()}


def main(argv) -> None:
    scenario, rank, world, init, out_dir = argv
    torch.set_num_threads(1)
    from sketch2img_torch.parallel.mesh import initialize_distributed, make_mesh

    initialize_distributed("cpu", init_method="file://" + init, rank=int(rank),
                           world_size=int(world))
    mesh = make_mesh(model_parallel=int(world) if scenario == "tp" else 1)
    out = {"scenario_train": scenario_train, "scenario_pipeline": scenario_pipeline,
           "scenario_tp": scenario_tp}["scenario_" + scenario](mesh, out_dir)
    torch.save(copy.deepcopy(out), os.path.join(out_dir, f"{scenario}_{rank}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
