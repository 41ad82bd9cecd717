"""Driver of LGP training: ``apps.train_lgp.train_lgp`` over a seeded
folder of captioned images, the trainer's own loop, loader and AdamW.

Set-up writes the images (JPEG, quality 95) and their tag-list captions
under ``TMPDIR``, makes the frozen SD modules, the anime2sketch generator
and the LGP's starting weights from the seed (the LGP's as the
``edge_predictor.pt`` file the trainer's ``network_weights`` reads), and
starts the trainer. Its first ``warmup_steps`` steps are set-up too; the
window is the steps that start in the next ``--seconds``. An optimizer
step hook (``torch.optim.optimizer.register_optimizer_step_post_hook``)
marks the steps and keeps what the output check reads, and, when the
window (and in a traced run the profiled steps after it) is over, sends
the process the SIGTERM on which the trainer saves a checkpoint and
returns: the stop path of a preempted job. ``train_images_per_s`` is
batch x steps over the summed ``TrainResult.step_seconds`` of the
window's steps.

The output check follows two runs of ``FOLLOWED`` steps. The start: steps
1-3 from the seeded weights and a fresh AdamW. The window: steps S to
S+2, S drawn from the seed inside the window (the window stays open until
they are done), from the LGP's weights and AdamW's moments and count as
the program held them after step S-1 (a snapshot taken then). The
reference trains on the batches the loader made for those steps (rebuilt
from the files, the loader's shuffles and the seed) with the trainer's
draws (made again from its seeded generator, in its order), and the check
compares each step's loss and LGP output, the first step's gradient (from
AdamW's first moment before and after it) and the weights' change over
the three steps, each of the last two by its worst leaf.
"""

from __future__ import annotations

import contextlib
import copy
import os
import random
import shutil
import signal
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.counts import flops as flop_counts
from benchmark.harness import core, inputs, models, trace
from benchmark.reference import pipeline as ref
from benchmark.reference import precision

TREES = ("unet", "vae", "text_encoder", "anime2sketch", "lgp")
FOLLOWED = 3  # steps the reference follows in each run it checks


def _moments(opt, name: str) -> List[torch.Tensor]:
    return [opt.state[p][name].detach().clone() if name in opt.state[p] else torch.zeros_like(p)
            for p in opt.param_groups[0]["params"]]


def _at_next_module_call(fn) -> None:
    """Run ``fn`` once, at the next call of any module."""
    handle = []

    def pre(module, args):
        handle.pop().remove()
        fn()
    handle.append(torch.nn.modules.module.register_module_forward_pre_hook(pre))


class Driver:
    def __init__(self, ctx, log):
        self.ctx, self.log = ctx, log
        self.cfg, self.tr = ctx.cfg, ctx.traffic
        self.attempted = self.failed = 0
        self.trace_summary = None
        self.unit_seconds: List[float] = []
        self.window_peak_bytes = None
        self.kernel_calls: Dict = {}
        self.work = self.profiled_work = None
        self.setup_s = None

    def setup(self) -> None:
        from sketch2img_torch import runtime
        from sketch2img_torch.core.schedulers import make_schedule
        from sketch2img_torch.utils.device import set_precision

        dev, cfg, tr = self.ctx.device, self.cfg, self.tr
        if tr["warmup_steps"] < FOLLOWED:
            raise ValueError(f"warmup_steps must cover the {FOLLOWED} followed first steps")
        set_precision()
        self.tmp = tempfile.mkdtemp(prefix="bench-train-")
        self.data_seed = inputs.request_seed(inputs.rng_for(self.ctx.seed, 4))
        self.paths = inputs.write_dataset(os.path.join(self.tmp, "images"), self.data_seed,
                                          tr["images"], tr["size"], dev)
        mods = {t: models.port_module(cfg, t, models.make_weights(cfg, self.ctx.seed, t, dev))
                for t in ("unet", "vae", "text_encoder", "anime2sketch")}
        self.comps = runtime.SDComponents(
            unet=mods["unet"], vae=mods["vae"], text_encoder=mods["text_encoder"],
            schedule=make_schedule(), device=dev, tokenizer=inputs.StandInTokenizer())
        self.gan = mods["anime2sketch"]
        self.lgp0 = models.make_weights(cfg, self.ctx.seed, "lgp", dev)
        self.lgp_file = os.path.join(self.tmp, "edge_predictor.pt")
        torch.save(self.lgp0, self.lgp_file)
        self.config = {
            "name": self.ctx.cell.name, "train_epochs": 1, "batch_size": tr["batch"],
            "resolution": tr["size"], "seed": self.data_seed,
            "dataset": {"img_path": [os.path.join(self.tmp, "images")], "center_crop": False,
                        "max_length": tr["max_length"], "ucg": 0.0, "process_tags": False,
                        "cache_latents": False},
            "optimizer": {"name": "adamw", "params": dict(tr["optimizer"])},
            "checkpoint_dir": os.path.join(self.tmp, "checkpoints"),
            "output_dir": os.path.join(self.tmp, "out"),
            "checkpoint_every": tr["checkpoint_every"], "log_every": 10 ** 9}

    def window_start(self) -> int:
        """S, the first followed step of the window (1-based), from the seed."""
        rng = inputs.rng_for(self.ctx.seed, 6)
        return self.tr["warmup_steps"] + 1 + int(rng.integers(0, self.tr["check"]["start_within"]))

    def runs(self) -> Dict[str, List[int]]:
        s = self.window_start()
        return {"start": list(range(1, FOLLOWED + 1)), "window": list(range(s, s + FOLLOWED))}

    # -- the window: the trainer's own loop -----------------------------------

    def _hook(self, seconds: float):
        dev, trace_on = self.ctx.device, self.ctx.trace
        warm, n_prof = self.tr["warmup_steps"], self.tr["profiled_steps"]
        runs = self.runs()
        first = {r[0]: name for name, r in runs.items()}
        last = {r[-1]: name for name, r in runs.items()}
        state = {"n": 0, "t0": None, "end": None, "stack": None}
        self.before = {"start": None}  # (weights, exp_avg, exp_avg_sq, count) before a run
        self.after: Dict[str, List[torch.Tensor]] = {}
        self.m_first: Dict[str, List[torch.Tensor]] = {}

        def post(opt, args, kw):
            state["n"] += 1
            n = state["n"]
            if n in first:  # AdamW's first moment after a run's first step
                self.m_first[first[n]] = _moments(opt, "exp_avg")
            if n in last:
                self.after[last[n]] = [p.detach().clone() for p in opt.param_groups[0]["params"]]
                self._capture(None)  # a global hook slows every module call
            if n + 1 == runs["window"][0]:
                self.before["window"] = (
                    [p.detach().clone() for p in opt.param_groups[0]["params"]],
                    _moments(opt, "exp_avg"), _moments(opt, "exp_avg_sq"), n)
                self._capture("window")
            if n == warm:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                    if trace_on:
                        torch.cuda.reset_peak_memory_stats(dev)
                self.setup_s = core.process_age_s()
                state["t0"] = time.perf_counter()
            elif n > warm and state["end"] is None and n >= runs["window"][-1] and \
                    time.perf_counter() >= state["t0"] + seconds:
                state["end"] = n
                if trace_on:
                    if dev.type == "cuda":
                        self.window_peak_bytes = torch.cuda.max_memory_allocated(dev)
                    _at_next_module_call(alone)
            if state["end"] is not None and trace_on and n == state["end"] + n_prof:
                _at_next_module_call(hosted)
            if state["end"] is not None and n == state["end"] + (2 * n_prof if trace_on else 0):
                if trace_on:
                    _at_next_module_call(stop)
                else:
                    signal.raise_signal(signal.SIGTERM)

        # The profiler starts and stops at the next step's first module call:
        # the optimizer runs its hooks inside its own profiler range, and a
        # profiler started or stopped inside an open range corrupts memory.
        def alone():
            stack = state["stack"] = contextlib.ExitStack()
            self._alone = stack.enter_context(trace.profiled(dev, cpu=False))

        def hosted():  # the same count of steps with the host and the ranges
            state["stack"].close()
            stack = state["stack"] = contextlib.ExitStack()
            self._ranges = stack.enter_context(trace.KernelRanges())
            self._hosted = stack.enter_context(trace.profiled(dev, cpu=True))

        def stop():
            state["stack"].close()
            signal.raise_signal(signal.SIGTERM)
        return state, post

    def _capture(self, run):
        """Keep the LGP's outputs under ``self.outs[run]`` (None: stop)."""
        from sketch2img_torch.models.lgp import LatentEdgePredictor

        if self._out_handle is not None:
            self._out_handle.remove()
            self._out_handle = None
        if run is None:
            return
        sink = self.outs.setdefault(run, [])

        def keep_output(module, args, out):
            if isinstance(module, LatentEdgePredictor):
                sink.append(out.detach().clone())
        self._out_handle = torch.nn.modules.module.register_module_forward_hook(keep_output)

    def window(self, seconds: float) -> Dict:
        from torch.optim.optimizer import register_optimizer_step_post_hook

        from sketch2img_torch.apps.train_lgp import train_lgp

        state, post = self._hook(seconds)
        self.outs: Dict[str, List[torch.Tensor]] = {}
        self._out_handle = None
        handle = register_optimizer_step_post_hook(post)
        self._capture("start")
        try:
            result = train_lgp(self.config, self.comps, self.gan, network_weights=self.lgp_file,
                               sketch_fixed_size=self.tr["sketch_fixed_size"],
                               device=self.ctx.device, log=lambda m: None)
        finally:
            handle.remove()
            self._capture(None)
        if state["end"] is None or not result.interrupted:
            raise RuntimeError(f"the trainer stopped after {result.step} steps, before the "
                               f"window closed: give the traffic more images")
        warm, end = self.tr["warmup_steps"], state["end"]
        self.losses = result.losses
        self.unit_seconds = result.step_seconds[warm:end]
        self.attempted = len(self.unit_seconds)
        self.failed = sum(not np.isfinite(x) for x in result.losses[warm:end])
        if self.ctx.trace:
            self.kernel_calls = dict(self._ranges.calls)
            self.trace_summary = trace.combine(trace.summarize(self._alone),
                                               trace.summarize(self._hosted))
            self.work = self.step_work()
            self.profiled_work = self.tr["profiled_steps"] * self.work
        return {"train_images_per_s": (self.tr["batch"] * len(self.unit_seconds)
                                       / sum(self.unit_seconds), "images/s")}

    def profile(self) -> None:
        """The traced steps ran in the trainer's loop after the window."""

    def step_work(self) -> flop_counts.Work:
        """The work of one step: the captions' 75-token windows through the
        text encoder, the generator at the fixed sketch size, the VAE
        encodes of the pixels and of their sketch, the UNet with taps, and
        the LGP's forward and backward to its weights."""
        c, cfg, tr = flop_counts.Counter(self.cfg), self.cfg, self.tr
        b, hw = tr["batch"], tr["size"] // 8
        windows = -(-tr["max_length"] // 75)
        n_ctx = cfg["text_encoder"]["max_position_embeddings"]
        return (windows * c.text(b, n_ctx) + c.anime2sketch(b, tr["sketch_fixed_size"])
                + 2 * c.vae_encode(b, tr["size"]) + c.unet_taps(b, hw, windows * n_ctx)
                + c.lgp(b, hw, "weights"))

    def release(self) -> None:
        self.comps = self.gan = None

    # -- the output check -----------------------------------------------------

    def batches(self, steps: List[int]) -> List[Dict[str, np.ndarray]]:
        """The loader's batches of ``steps`` (1-based), rebuilt: the sorted
        files shuffled by ``random.Random(seed)`` (the dataset), the epoch's
        permutation by ``random.Random(seed + 0)`` (the loader), pixels read
        as the dataset reads a square image of the training size."""
        from PIL import Image

        entries = sorted(self.paths)
        random.Random(self.data_seed).shuffle(entries)
        perm = list(range(len(entries)))
        random.Random(self.data_seed).shuffle(perm)
        tok, b = inputs.StandInTokenizer(), self.tr["batch"]
        out = []
        for k in steps:
            files = [entries[perm[j]] for j in range((k - 1) * b, k * b)]
            px = np.stack([np.asarray(Image.open(f).convert("RGB"), np.float32) / 255.0
                           for f in files])
            caps = [open(f[:-4] + ".txt").read() for f in files]
            out.append({"pixels": (px - 0.5) / 0.5,
                        "input_ids": np.asarray(tok(caps, max_length=self.tr["max_length"])
                                                .input_ids)})
        return out

    def draws(self, shape, steps: List[int]) -> List[Dict[str, torch.Tensor]]:
        """The trainer's draws for ``steps``, from its generator seeded as it
        seeds it, in its order: latent, sketch, noise, t, step after step."""
        dev = self.ctx.device
        gen = torch.Generator(device=dev).manual_seed(self.data_seed)
        out = {}
        for k in range(1, max(steps) + 1):
            d = {n: torch.randn(shape, generator=gen, device=dev)
                 for n in ("latent", "sketch", "noise")}
            d["t"] = torch.randint(0, 1000, (shape[0],), generator=gen, device=dev)
            if k in steps:
                out[k] = d
        return [out[k] for k in steps]

    def follow(self, m, start, batches, draws, lower: bool):
        """The reference's steps from ``start`` (weights, first and second
        moments, step count) -> (losses, LGP outputs, first gradient,
        change)."""
        opt_cfg = self.tr["optimizer"]
        weights, m1, m2, count = start
        params = list(m.lgp.parameters())
        with torch.no_grad():
            for p, w in zip(params, weights):
                p.copy_(w)
        m.lgp.requires_grad_(True)
        opt = ref.AdamW(params, opt_cfg["lr"], self.tr["lr_warmup_steps"],
                        opt_cfg["weight_decay"], opt_cfg["eps"], moments=(m1, m2), count=count)
        ac = ref.alphas_cumprod()
        losses, outs, grad1 = [], [], None
        dev = self.ctx.device
        for k in range(FOLLOWED):
            batch = {"pixels": torch.as_tensor(batches[k]["pixels"], device=dev)
                     .permute(0, 3, 1, 2).contiguous(),
                     "input_ids": batches[k]["input_ids"]}
            with (precision.tf32() if lower else contextlib.nullcontext()):
                loss, out = ref.lgp_loss(m, batch, draws[k], ac, self.tr["sketch_fixed_size"])
                loss.backward()
            losses.append(float(loss.detach()))
            outs.append(out.detach())
            if k == 0:
                grad1 = [p.grad.detach().clone() for p in params]
            opt.step()
        change = [p.detach() - w.float() for p, w in zip(params, weights)]
        return losses, outs, grad1, change

    def check(self):
        dev, cfg = self.ctx.device, self.cfg
        runs = self.runs()
        hw = self.tr["size"] // 8
        r32 = models.reference(cfg, self.ctx.seed, TREES, dev)
        names = [n for n, _ in r32.lgp.named_parameters()]
        zeros = [torch.zeros_like(p) for p in r32.lgp.parameters()]
        self.before["start"] = ([self.lgp0[n].float() for n in names], zeros, zeros, 0)
        sides = {"program": r32}
        if self.ctx.control:
            sides["control"] = models.lower_precision(cfg, r32)
            sides["control"].lgp = copy.deepcopy(r32.lgp)
        b1 = ref.AdamW.BETAS[0]
        nums: Dict[str, Dict[str, float]] = {k: {} for k in sides}

        def worst(side, key, value):
            nums[side][key] = max(nums[side].get(key, 0.0), value)

        for run, steps in runs.items():
            batches = self.batches(steps)
            draws = self.draws((self.tr["batch"], 4, hw, hw), steps)
            start = [t if isinstance(t, int) else [x.to(dev) for x in t]
                     for t in self.before[run]]
            results = {side: self.follow(m, start, batches, draws, side == "control")
                       for side, m in sides.items()}
            ref_losses, ref_outs, ref_grad, ref_change = results["program"]
            keep = leaf_keep(ref_grad, self.tr["still_leaf_share"])
            self.log(f"{run} (steps {steps}): leaves left out of the change (reference "
                     f"gradient under {self.tr['still_leaf_share']} of the median leaf's): "
                     f"{[n for n, k in zip(names, keep) if not k]}")
            got = {"program": (
                [self.losses[k - 1] for k in steps], [o.to(dev) for o in self.outs[run]],
                [(m - b1 * m0) / (1 - b1) for m, m0 in zip(self.m_first[run], start[1])],
                [a - w for a, w in zip(self.after[run], start[0])])}
            if "control" in results:
                got["control"] = results["control"]
            for side, (losses, outs, grad1, change) in got.items():
                worst(side, "loss_rel", max(abs(a - b) / abs(b)
                                            for a, b in zip(losses, ref_losses)))
                worst(side, "lgp_out_rel", max(ref.rel(a, b) for a, b in zip(outs, ref_outs))
                      if len(outs) == len(ref_outs) else ref.NO_MATCH)
                worst(side, "grad1_leaf_gap", ref.leaf_gaps(grad1, ref_grad, [True] * len(keep)))
                worst(side, "change3_leaf_gap", ref.leaf_gaps(change, ref_change, keep))
        shutil.rmtree(self.tmp, ignore_errors=True)
        return nums["program"], nums.get("control")


def leaf_keep(grads: List[torch.Tensor], share: float) -> List[bool]:
    """Leaves whose reference gradient is above ``share`` of the median
    leaf's norm: the others move under Adam by round-off alone."""
    norms = [float(g.double().norm()) for g in grads]
    med = float(np.median(norms))
    return [n > share * med for n in norms]
