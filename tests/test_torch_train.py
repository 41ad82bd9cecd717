"""The trainers of the PyTorch port against the JAX package.

One LGP step and one injection step, with plain SGD on both sides (Adam
would turn a one-bit difference of a near-zero gradient into a full step)
and the JAX step's own random draws fed to the port's: the loss, every
gradient (the JAX one as (old - new) / lr, with lr = 1024 so that the
subtraction keeps the gradient's precision) and the LGP's updated
BatchNorm statistics. Then the LGP BatchNorm's running variance (flax's
biased update), the static text chunking, the cached-latent steps, and the
two apps' library functions on a tiny stack on the CPU: checkpoint round
trip, resume against an uninterrupted run, checkpoint-on-signal, the
exported ``.pt`` files (``save_torch``) loaded strictly by the JAX
package's loaders, the npz exports loaded by its ``load_params_npz`` with
the key paths its trainers write, and the network options (wandb and the
hub push used by the LGP trainer, ignored by the injection trainer, as in
the JAX apps).

Weights come from tests/torch_port_stack.py (JAX parameters converted from
the port's state dicts, no flax init); fp32 on the CPU.
"""

import copy
import os
import signal
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from sketch2img_torch.apps.train_attn_inject import train_attn_inject
from sketch2img_torch.apps.train_lgp import train_lgp
from sketch2img_torch.core.schedulers import make_schedule
from sketch2img_torch.models.anime2sketch import create_anime2sketch
from sketch2img_torch.models.lgp import BatchNorm
from sketch2img_torch.runtime import SDComponents
from sketch2img_torch.train import checkpoint as tckpt
from sketch2img_torch.train.train_attn_inject import (
    inject_inputs,
    inject_train_step,
    mark_trainables,
    sketch_to_clip_pixels,
)
from sketch2img_torch.train.train_lgp import (
    Frozen,
    encode_tokens_static,
    generate_sketch,
    lgp_inputs,
    lgp_train_step,
)
from sketch2img_tpu.apps.clip_guided_inf import load_attn_weights, load_clip_weights
from sketch2img_tpu.core.export import load_torch_state
from sketch2img_tpu.core.manifest import strict_convert
from sketch2img_tpu.core.schedulers import make_schedule as j_make_schedule
from sketch2img_tpu.models import unet as junet
from sketch2img_tpu.models.anime2sketch import UnetGenerator, convert_torch_anime2sketch
from sketch2img_tpu.models.clip_vision import convert_torch_clip_vision
from sketch2img_tpu.models.lgp import convert_torch_lgp
from sketch2img_tpu.models.vae import AutoencoderKL as JAutoencoderKL
from sketch2img_tpu.core.export import convert_torch_sat
from sketch2img_tpu.train.train_attn_inject import (
    init_inject_train_state,
    make_inject_train_step,
)
from sketch2img_tpu.train.train_lgp import encode_tokens_static as j_encode_tokens_static
from sketch2img_tpu.train.checkpoint import load_params_npz as j_load_params_npz
from sketch2img_tpu.train.train_lgp import init_lgp_train_state, make_lgp_train_step

from fakes import FakeTokenizer
from torch_port_stack import (
    CLIP_KW, VISION_KW, clip_pair, clip_vision_pair, injected_unet_pair, lgp_pair, nchw, t,
    unet_pair, vae_pair,
)
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

B, PX, SKETCH = 2, 32, 32  # batch, image size, the generator's input size
SGD_LR = 1024.0  # a power of two: (old - new) / lr recovers the JAX gradient exactly
HIDDEN = CLIP_KW["hidden_size"]  # text and CLIP-vision width, the UNets' context dims


@pytest.fixture(scope="module")
def models():
    """Port modules and their JAX twins (parameters converted from the
    port's): UNet (with taps), VAE, text encoder, LGP, anime2sketch (5
    levels, ngf 4), clip-injected UNet and the ViT (224/14, 2 layers)."""
    m = {}
    m["unet"] = unet_pair(0, cross_attention_dim=HIDDEN)
    m["vae"] = vae_pair(1)
    m["text"] = clip_pair(2)
    m["lgp"] = lgp_pair(3)
    torch.manual_seed(4)
    gan = create_anime2sketch(5, 4).eval().requires_grad_(False)
    m["gan"] = (gan, UnetGenerator(3, 1, 5, 4), convert_torch_anime2sketch(gan.state_dict(), 5))
    m["inj"] = injected_unet_pair("clip", 5, VISION_KW["hidden_size"], cross_attention_dim=HIDDEN)
    m["vision"] = clip_vision_pair(6)
    return m


def _jax_fns(m):
    (_, jvae, _), (_, jtext, _), (_, jgan, _) = m["vae"], m["text"], m["gan"]
    return dict(
        vae_encode=lambda p, img: jvae.apply({"params": p}, img, method=JAutoencoderKL.encode),
        text_apply=lambda p, ids: jtext.apply({"params": p}, ids),
        gan_apply=lambda p, img: jgan.apply({"params": p}, img))


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return {"input_ids": rng.randint(0, CLIP_KW["vocab_size"], (B, 12)).astype(np.int32),
            "pixels": rng.uniform(-1, 1, (B, PX, PX, 3)).astype(np.float32)}


def _port_batch(batch):
    return {"input_ids": torch.from_numpy(batch["input_ids"]).long(),
            "pixels": t(nchw(batch["pixels"]))}


def _draws(key, names, latent_shape):
    """The JAX step's own draws from ``key`` (its split order), as the
    port's NCHW ``draws``."""
    keys = jax.random.split(key, len(names) + 1)
    out = {n: t(nchw(jax.random.normal(k, latent_shape, jnp.float32)))
           for n, k in zip(names, keys)}
    out["t"] = torch.from_numpy(np.array(jax.random.randint(keys[-1], (B,), 0, 1000)))
    return out


def _close(got, want, rel, name="", floor=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), floor), err_msg=name)


def _tree_close(got_tree, want_tree, rel):
    """Leaf by leaf to ``rel`` of the leaf's largest entry, or of a
    thousandth of the tree's largest where a leaf's is smaller (a key
    projection's bias gets a zero gradient up to rounding: softmax ignores
    a shift common to all keys)."""
    flat = dict(jax.tree_util.tree_leaves_with_path(want_tree))
    got = jax.tree_util.tree_leaves_with_path(got_tree)
    assert len(got) == len(flat) > 0
    floor = 1e-3 * max(np.abs(np.asarray(v)).max() for v in flat.values())
    for path, g in got:
        _close(g, flat[path], rel, jax.tree_util.keystr(path), floor)


# ---------------------------------------------------------------------------
# one step against the JAX package's step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lgp_steps(models):
    """One LGP step on each side from the same weights, batch and draws.
    -> (JAX: loss, grads, batch_stats; port: loss, grads (a state dict),
    the stepped LGP)."""
    (unet, junet_mod, unet_params), (vae, _, vae_params) = models["unet"], models["vae"]
    (text, _, text_params), (lgp, jlgp_mod, lgp_vars) = models["text"], models["lgp"]
    gan, _, gan_params = models["gan"]
    fns = _jax_fns(models)
    tx = optax.sgd(SGD_LR)
    step = make_lgp_train_step(
        lambda v, f, nl, train: jlgp_mod.apply(v, f, nl, train=train, mutable=["batch_stats"]),
        lambda p, x, tt, ctx: junet_mod.apply({"params": p}, x, tt, ctx, capture_taps=True),
        fns["vae_encode"], fns["text_apply"], fns["gan_apply"], j_make_schedule(), tx,
        sketch_fixed_size=SKETCH)
    state = init_lgp_train_state(lgp_vars, tx)
    frozen = {"unet": unet_params, "vae": vae_params, "text": text_params, "gan": gan_params}
    batch, key = _batch(0), jax.random.PRNGKey(7)
    new, metrics = jax.jit(step)(state, frozen, {k: jnp.asarray(v) for k, v in batch.items()},
                                 key)
    j_grads = jax.tree_util.tree_map(lambda a, b: (np.asarray(a) - np.asarray(b)) / SGD_LR,
                                     state.params, new.params)

    port = copy.deepcopy(lgp).requires_grad_(True)
    opt = torch.optim.SGD(port.parameters(), lr=SGD_LR)
    lat = (B, PX // 2, PX // 2, 4)
    loss = lgp_train_step(port, opt, Frozen(unet, vae, text, gan, make_schedule()),
                          _port_batch(batch), draws=_draws(key, ("latent", "sketch", "noise"), lat),
                          sketch_fixed_size=SKETCH)
    grads = {n: p.grad for n, p in port.named_parameters()}
    grads.update({n: b for n, b in port.state_dict().items() if "running" in n})
    return (float(metrics["loss"]), j_grads, new.batch_stats), (float(loss), grads, port)


@pytest.mark.parametrize("what", ["loss", "gradients", "batch_stats"])
def test_lgp_step_matches_jax(lgp_steps, what):
    """The SGD step of ``make_lgp_train_step`` with its own draws: loss to
    1e-5, each gradient to 1e-4 of its largest entry (``_tree_close``), and the BatchNorm
    statistics after the step (flax's momentum-0.9 update with the biased
    batch variance) to 1e-5 of their scale."""
    (j_loss, j_grads, j_stats), (loss, grads, port) = lgp_steps
    if what == "loss":
        assert loss == pytest.approx(j_loss, rel=1e-5)
        assert np.isfinite(loss) and loss > 0
    elif what == "gradients":
        params, _ = convert_torch_lgp(grads)  # the port's gradients in the JAX layout
        _tree_close(params, j_grads, 1e-4)
    else:
        _, stats = convert_torch_lgp(port.state_dict())
        _tree_close(stats, j_stats, 1e-5)


@pytest.fixture(scope="module")
def inject_steps(models):
    """One injection step on each side (SGD, the JAX step's draws). -> (JAX:
    loss, injection grads, CLIP grads; port: loss, the grads as the JAX
    trees, the base UNet's state before and after)."""
    (inj, jinj_mod, inj_params), (vis, jvis_mod, vis_params) = models["inj"], models["vision"]
    (vae, _, vae_params), (text, _, text_params) = models["vae"], models["text"]
    gan, _, gan_params = models["gan"]
    fns = _jax_fns(models)
    n_sites = junet.num_transformer_blocks(jinj_mod.config)
    tx = optax.sgd(SGD_LR)
    step = make_inject_train_step(
        lambda p, x, tt, ctx, s, sc: jinj_mod.apply({"params": p}, x, tt, ctx, injection_states=s,
                                                   injection_scale=sc),
        lambda p, px: jvis_mod.apply({"params": p}, px), fns["vae_encode"], fns["text_apply"],
        fns["gan_apply"], j_make_schedule(), tx, n_sites, sketch_fixed_size=SKETCH,
        clip_image_size=VISION_KW["image_size"])
    state, base = init_inject_train_state(inj_params, vis_params, tx)
    frozen = {"unet_base": base, "vae": vae_params, "text": text_params, "gan": gan_params}
    batch, key = _batch(1), jax.random.PRNGKey(9)
    new, metrics = jax.jit(step)(state, frozen, {k: jnp.asarray(v) for k, v in batch.items()},
                                 key)

    def diff(a, b):
        return jax.tree_util.tree_map(lambda x, y: (np.asarray(x) - np.asarray(y)) / SGD_LR, a, b)

    unet, clip = copy.deepcopy(inj), copy.deepcopy(vis)
    trainables = mark_trainables(unet, clip)
    base_before = {n: v.clone() for n, v in unet.state_dict().items() if not n.startswith("sat.")}
    opt = torch.optim.SGD(trainables.values(), lr=SGD_LR)
    loss = inject_train_step(unet, clip, opt, Frozen(None, vae, text, gan, make_schedule()),
                             _port_batch(batch),
                             draws=_draws(key, ("latent", "noise"), (B, PX // 2, PX // 2, 4)),
                             sketch_fixed_size=SKETCH, clip_image_size=VISION_KW["image_size"])
    sat_grads = convert_torch_sat({n: p.grad for n, p in unet.sat.named_parameters()},
                                  jinj_mod.config)
    clip_grads = convert_torch_clip_vision(
        {n: p.grad for n, p in clip.named_parameters() if p.requires_grad},
        num_layers=VISION_KW["num_layers"])
    base_after = {n: v for n, v in unet.state_dict().items() if not n.startswith("sat.")}
    return ((float(metrics["loss"]), diff(state.inj_params, new.inj_params),
             diff(state.clip_params, new.clip_params)),
            (float(loss), sat_grads, clip_grads, base_before, base_after))


@pytest.mark.parametrize("what", ["loss", "injection_gradients", "clip_gradients", "frozen_base"])
def test_inject_step_matches_jax(inject_steps, what):
    """The SGD step of ``make_inject_train_step``: loss to 1e-5, the
    injection blocks' and the ViT's gradients to 1e-4 of each tensor's
    largest entry (``_tree_close``); the base UNet bit-identical after the
    step."""
    (j_loss, j_inj, j_clip), (loss, sat_grads, clip_grads, before, after) = inject_steps
    if what == "loss":
        assert loss == pytest.approx(j_loss, rel=1e-5) and np.isfinite(loss)
    elif what == "injection_gradients":
        _tree_close(sat_grads, j_inj, 1e-4)
    elif what == "clip_gradients":
        _tree_close(clip_grads, j_clip, 1e-4)
    else:
        assert before.keys() == after.keys()
        assert all(torch.equal(before[n], after[n]) for n in before)


# ---------------------------------------------------------------------------
# pieces of the steps
# ---------------------------------------------------------------------------


def test_lgp_batchnorm_running_variance_follows_flax():
    """Eight rows: the unbiased variance is 8/7 of the biased one. The
    port's train-mode BatchNorm output and running statistics equal flax's
    (momentum 0.9, biased variance), not ``nn.BatchNorm1d``'s update."""
    x = np.random.RandomState(0).randn(8, 5).astype(np.float32) * 2 + 1
    bn = BatchNorm(5)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.5, 0.5)
        bn.running_var.fill_(0.9)
    ref = copy.deepcopy(bn)
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": jnp.asarray(bn.weight.detach().numpy()),
                            "bias": jnp.asarray(bn.bias.detach().numpy())},
                 "batch_stats": {"mean": jnp.zeros(5), "var": jnp.full(5, 0.9)}}
    want, new = flax_bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    bn.train()
    got = bn(torch.from_numpy(x))
    _close(got.detach().numpy(), want, 1e-6)
    _close(bn.running_mean.numpy(), new["batch_stats"]["mean"], 1e-6)
    _close(bn.running_var.numpy(), new["batch_stats"]["var"], 1e-6)
    torch.nn.BatchNorm1d.forward(ref.train(), torch.from_numpy(x))
    assert not np.allclose(ref.running_var.numpy(), bn.running_var.numpy(), rtol=1e-3)


def test_encode_tokens_static_matches_jax():
    """200 ids -> three 75-token windows wrapped in BOS/EOS, the last padded
    with EOS, encoded and concatenated: to 1e-5 of the scale, with the
    encoder's full vocabulary so that the BOS/EOS ids exist."""
    from sketch2img_tpu.models import clip_text as jclip

    from sketch2img_torch.models import clip_text as tclip

    kw = dict(CLIP_KW, vocab_size=49408)
    torch.manual_seed(0)
    port = tclip.CLIPTextEncoder(tclip.CLIPTextConfig(**kw)).eval()
    params = jclip.convert_torch_clip_text(port.state_dict(), num_layers=kw["num_layers"])
    jmod = jclip.CLIPTextEncoder(jclip.CLIPTextConfig(**kw))
    ids = np.random.RandomState(0).randint(0, 49406, (2, 200)).astype(np.int32)
    want = j_encode_tokens_static(jax.jit(lambda p, x: jmod.apply({"params": p}, x)), params,
                                  jnp.asarray(ids))
    with torch.no_grad():
        got = encode_tokens_static(port, torch.from_numpy(ids).long())
    assert got.shape == (2, 3 * 77, kw["hidden_size"])
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("trainer", ["lgp", "inject"])
def test_cached_latents_step_inputs_match_uncached(models, trainer):
    """The latent cache's moments (and sketches) reproduce the uncached
    step's inputs under the same draws, for the cache functions the apps
    build."""
    (vae, _, _), (text, _, _), (gan, _, _) = models["vae"], models["text"], models["gan"]
    frozen = Frozen(models["unet"][0], vae, text, gan, make_schedule())
    batch = _port_batch(_batch(2))
    draws = _draws(jax.random.PRNGKey(3), ("latent", "sketch", "noise"),
                   (B, PX // 2, PX // 2, 4))
    with torch.no_grad():
        moments = torch.cat(vae.encode(batch["pixels"]), dim=1)
        if trainer == "lgp":
            sketch = torch.cat(vae.encode(generate_sketch(gan, batch["pixels"], SKETCH)), dim=1)
            cached = {"input_ids": batch["input_ids"], "latent_dist": moments,
                      "sketch_latent_dist": sketch}
            fn, kw = lgp_inputs, dict(sketch_fixed_size=SKETCH)
        else:
            sketch = sketch_to_clip_pixels(gan, batch["pixels"], sketch_fixed_size=SKETCH,
                                           clip_image_size=48)
            cached = {"input_ids": batch["input_ids"], "latent_dist": moments,
                      "sketch_clip_pixels": sketch}
            fn, kw = inject_inputs, dict(sketch_fixed_size=SKETCH, clip_image_size=48)
    for a, b in zip(fn(frozen, batch, draws=draws, **kw),
                    fn(frozen, cached, cached_latents=True, draws=draws, **kw)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the apps' library functions on a tiny stack
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Six captioned images: three batches of two an epoch."""
    root = tmp_path_factory.mktemp("train_images")
    rng = np.random.RandomState(0)
    for i in range(6):
        Image.fromarray(rng.randint(0, 255, (36 + 2 * i, 40, 3), np.uint8)).save(root / f"{i}.png")
        (root / f"{i}.txt").write_text(f"1girl solo tag{i}")
    return str(root)


@pytest.fixture(scope="module")
def components(models):
    return SDComponents(unet=models["unet"][0], vae=models["vae"][0],
                        text_encoder=models["text"][0], schedule=make_schedule(),
                        device=torch.device("cpu"), tokenizer=FakeTokenizer())


def _config(tmp, folder, **extra):
    return dict(name="tiny", train_epochs=2, batch_size=2, resolution=PX, seed=3,
                dataset=dict(img_path=[folder], center_crop=True, max_length=12,
                             process_tags=False),
                optimizer=dict(name="adamw", params=dict(lr=1e-3, weight_decay=1e-2, eps=1e-8)),
                checkpoint_dir=str(tmp / "checkpoints"), output_dir=str(tmp / "out"),
                checkpoint_every=100, log_every=1, **extra)


def _train(kind, models, components, cfg, **kw):
    quiet = kw.pop("log", lambda msg: None)
    if kind == "lgp":
        return train_lgp(cfg, components, models["gan"][0], sketch_fixed_size=SKETCH,
                         device="cpu", log=quiet, **kw)
    return train_attn_inject(cfg, components, models["gan"][0], copy.deepcopy(models["vision"][0]),
                             sketch_fixed_size=SKETCH, device="cpu", log=quiet, **kw)


def _state(kind, result):
    mods = result.modules
    if kind == "lgp":
        return {"lgp": mods["lgp"].state_dict(), "optimizer": mods["optimizer"].state_dict()}
    return {"sat": mods["unet"].sat.state_dict(), "clip": mods["clip"].state_dict(),
            "optimizer": mods["optimizer"].state_dict()}


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def full_runs(models, components, folder, tmp_path_factory):
    """Each trainer uninterrupted for its two epochs (six steps), the LGP
    one with mid-training samples each epoch; the ``.pt`` exports too."""
    out = {}
    for kind in ("lgp", "inject"):
        tmp = tmp_path_factory.mktemp(f"full_{kind}")
        extra = {}
        if kind == "lgp":
            extra["sampling"] = dict(enabled=True, every_n_epochs=1, prompts=["a", "b"], steps=2,
                                     height=PX, width=PX, save_dir=str(tmp / "samples"))
        out[kind] = (tmp, _train(kind, models, components, _config(tmp, folder, **extra),
                                 save_torch=True))
    return out


@pytest.mark.parametrize("kind", ["lgp", "inject"])
def test_app_trains_checkpoints_and_exports(full_runs, kind):
    """Six finite steps; the last checkpoint holds the trained state (step,
    trainables, optimizer); the LGP run wrote its samples and one
    ``edge_predictor.npz`` and ``.pt`` per epoch, the injection run both
    npz and both ``.pt`` files."""
    tmp, result = full_runs[kind]
    assert result.step == 6 and len(result.losses) == 6 and np.isfinite(result.losses).all()
    assert not result.interrupted
    saved = tckpt.restore_train_state(str(tmp / "checkpoints"))
    assert saved["step"] == 6
    _assert_same({k: saved[k] for k in _state(kind, result)}, _state(kind, result))
    names = sorted(p.rsplit("/", 1)[-1] for p in result.exports)
    if kind == "lgp":
        assert names == ["edge_predictor.npz"] * 2 + ["edge_predictor.pt"] * 2
        assert sorted(p.name for p in (tmp / "samples").iterdir()) == [
            "epoch1_0.png", "epoch1_1.png", "epoch2_0.png", "epoch2_1.png"]
    else:
        assert names == ["sketch_attn_model.npz", "sketch_attn_model.pt",
                         "sketch_encoder_model.npz", "sketch_encoder_model.pt"]


@pytest.mark.parametrize("kind", ["lgp", "inject"])
def test_exports_load_strictly_in_jax(full_runs, models, kind):
    """The exported files through the JAX package's own strict loaders
    (``load_torch_state`` + ``convert_torch_lgp``; ``load_attn_weights``,
    ``load_clip_weights``) give the trained tensors exactly."""
    tmp, result = full_runs[kind]
    out = tmp / "out"
    if kind == "lgp":
        sd = load_torch_state(str(out / "edge_predictor.pt"))
        params, stats = strict_convert(convert_torch_lgp, sd, what="edge_predictor")
        want = convert_torch_lgp(result.modules["lgp"].state_dict())
        _tree_close(params, want[0], 0.0)
        _tree_close(stats, want[1], 0.0)
    else:
        cfg = models["inj"][1].config
        sat = load_attn_weights(str(out / "sketch_attn_model.pt"), cfg)
        _tree_close(sat, convert_torch_sat(result.modules["unet"].sat.state_dict(), cfg), 0.0)
        n = VISION_KW["num_layers"]
        vision = load_clip_weights(str(out / "sketch_encoder_model.pt"), n)
        _tree_close(vision, convert_torch_clip_vision(result.modules["clip"].state_dict(), n), 0.0)


@pytest.mark.parametrize("kind", ["lgp", "inject"])
def test_npz_exports_load_in_jax(full_runs, models, kind):
    """The npz exports (written with or without ``save_torch``) through the
    JAX package's ``load_params_npz``: the trees its trainers export
    (``{"params", "batch_stats"}`` of the LGP; the injection subtree and the
    ViT's params), key path for key path, holding the trained tensors
    exactly."""
    tmp, result = full_runs[kind]
    out = tmp / "out"
    if kind == "lgp":
        params, stats = convert_torch_lgp(result.modules["lgp"].state_dict())
        want = {"edge_predictor.npz": {"params": params, "batch_stats": stats}}
    else:
        cfg = models["inj"][1].config
        n = VISION_KW["num_layers"]
        want = {"sketch_attn_model.npz":
                    convert_torch_sat(result.modules["unet"].sat.state_dict(), cfg),
                "sketch_encoder_model.npz":
                    convert_torch_clip_vision(result.modules["clip"].state_dict(), n)}
    for name, tree in want.items():
        got = j_load_params_npz(str(out / name))
        assert (jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(tree)), name
        _tree_close(got, tree, 0.0)
        assert all(np.asarray(x).dtype == np.float32 for x in jax.tree_util.tree_leaves(got))


@pytest.mark.parametrize("kind", ["lgp", "inject"])
def test_resume_equals_uninterrupted_run(full_runs, models, components, folder, tmp_path, kind):
    """Two steps, then a resume from the checkpoint to the end, step six
    (the stream positioned mid-epoch 0, then across the boundary): the same
    losses and bit-identical trainables and optimizer as the uninterrupted
    run; only the newest ``keep`` checkpoints stay. The first call, cut
    mid-epoch, exports nothing per epoch."""
    cfg = _config(tmp_path, folder)
    first = _train(kind, models, components, cfg, max_steps=2)
    if kind == "lgp":
        assert first.exports == [] and not (tmp_path / "out").exists()
    resumed = _train(kind, models, components, cfg, resume=str(tmp_path / "checkpoints"))
    _, full = full_runs[kind]
    assert resumed.step == 6 and first.losses + resumed.losses == full.losses
    _assert_same(_state(kind, resumed), _state(kind, full))
    path = tckpt.save_train_state(str(tmp_path / "keep"), 1, {"step": 1})
    for s in (2, 3, 4):
        tckpt.save_train_state(str(tmp_path / "keep"), s, {"step": s}, keep=2)
    assert sorted(p.name for p in (tmp_path / "keep").iterdir()) == [
        "step_00000003.pt", "step_00000004.pt"]
    assert tckpt.latest_checkpoint(str(tmp_path / "keep")).endswith("step_00000004.pt")
    assert path.endswith("step_00000001.pt")


@pytest.mark.parametrize("kind", ["lgp", "inject"])
def test_signal_saves_and_stops_then_resume_finishes(models, components, folder, tmp_path, kind):
    """A SIGTERM during step 1 (sent from the log line) -> the step ends, a
    checkpoint is saved, the call returns interrupted; resuming finishes the
    two steps. The handlers are restored afterwards."""
    cfg = _config(tmp_path, folder)
    previous = signal.getsignal(signal.SIGTERM)

    def log(msg):
        if "step 1/" in msg:
            signal.raise_signal(signal.SIGTERM)

    stopped = _train(kind, models, components, cfg, max_steps=2, log=log)
    assert stopped.interrupted and stopped.step == 1
    assert stopped.checkpoint.endswith("step_00000001.pt")
    assert signal.getsignal(signal.SIGTERM) == previous
    done = _train(kind, models, components, cfg, max_steps=2,
                  resume=str(tmp_path / "checkpoints"))
    assert done.step == 2 and not done.interrupted and len(done.losses) == 1


@pytest.mark.parametrize("option", ["monitor.wandb_id", "monitor.huggingface_repo"])
def test_network_options_raise(models, components, folder, tmp_path, option, monkeypatch,
                               capsys):
    """The LGP trainer does what its JAX app does, with neither wandb nor the
    hub library importable here (no test touches the network):
    ``wandb_id`` imports wandb before any step, which raises; a
    ``huggingface_repo`` push after the epoch's export fails softly and
    training finishes. The injection trainer, whose JAX app reads neither
    option, ignores it and trains."""
    section, key = option.split(".")
    cfg = _config(tmp_path, folder, **{section: {key: "someone/something"}})
    monkeypatch.setitem(sys.modules, "wandb", None)
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    if key == "wandb_id":
        with pytest.raises(ImportError, match="wandb"):
            _train("lgp", models, components, cfg, max_steps=1)
    else:
        result = _train("lgp", models, components, cfg, max_steps=3)  # one whole epoch
        assert result.step == 3 and [os.path.basename(p) for p in result.exports] == [
            "edge_predictor.npz"]
        assert "[hub] publish to someone/something failed" in capsys.readouterr().out
    result = _train("inject", models, components, cfg, max_steps=1)
    assert result.step == 1 and np.isfinite(result.losses).all()
