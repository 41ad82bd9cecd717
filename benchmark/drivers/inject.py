"""Driver of the attention-injection request:
``apps.clip_guided_inf.ClipGuidedPipeline`` called by one client,
requests back to back, each a batch of prompts over one sketch.

Set-up builds the SD components, the injected UNet's blocks and the CLIP
ViT-L/14 sketch encoder from the seeded weights, then warms every shape
with one short request. ``images_per_s`` is the window's images over the
summed time of the requests that made them.

For the output check the driver records, per request, the text states
and the sketch's CLIP states given to ``sample_attn_injected``, its final
latents, the (x, x0_prev) -> (x_next, x0) of the sampler steps drawn for
checking, the returned images and the flags; after each request (its time
taken) the records move to host memory.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.counts import flops as flop_counts
from benchmark.harness import inputs, models, trace
from benchmark.harness.record import Recorder
from benchmark.reference import pipeline as ref
from benchmark.reference import precision

TREES = ("unet", "sat", "vae", "text_encoder", "safety_checker", "vision")


def _rec_sample(cur, args, kw, out):
    b = out.shape[0]
    cur["context"], cur["hidden"], cur["final"] = args[4], args[5][b:b + 1], out


class Driver:
    def __init__(self, ctx, log):
        self.ctx, self.log = ctx, log
        self.cfg, self.tr = ctx.cfg, ctx.traffic
        self.attempted = self.failed = 0
        self.trace_summary = None
        self.unit_seconds: List[float] = []
        self.images = 0
        self.window_peak_bytes = None
        self.kernel_calls: Dict = {}
        self.work = self.profiled_work = None

    def setup(self) -> None:
        from sketch2img_torch import runtime
        from sketch2img_torch.apps import clip_guided_inf
        from sketch2img_torch.core.schedulers import make_schedule
        from sketch2img_torch.pipelines import attn_injected
        from sketch2img_torch.utils.device import set_precision

        dev, cfg, seed = self.ctx.device, self.cfg, self.ctx.seed
        set_precision()
        mods = {t: models.port_module(cfg, t, models.make_weights(cfg, seed, t, dev))
                for t in ("unet", "vae", "text_encoder", "safety_checker")}
        comps = runtime.SDComponents(
            unet=mods["unet"], vae=mods["vae"], text_encoder=mods["text_encoder"],
            schedule=make_schedule(), device=dev, tokenizer=inputs.StandInTokenizer(),
            safety_checker=mods["safety_checker"])
        pipe = clip_guided_inf.ClipGuidedPipeline(
            components=comps, clip_config=models.vision_config(cfg["vision"]))
        with torch.no_grad():
            pipe.unet.sat.load_state_dict(models.make_weights(cfg, seed, "sat", dev), strict=True)
            pipe.clip.load_state_dict(models.make_weights(cfg, seed, "vision", dev), strict=True)
        self.pipe = pipe
        self.rec = Recorder()
        self.rec.wrap(clip_guided_inf, "sample_attn_injected", _rec_sample)

        def make_step(solver, schedule, num_steps, _make=attn_injected.make_sampler_step):
            ts, step = _make(solver, schedule, num_steps)

            def recorded(i, x, eps, x0_prev):
                out = step(i, x, eps, x0_prev)
                if i in self.rec.current["want"]:
                    self.rec.current["steps"][i] = (x, x0_prev, out[0], out[1])
                return out
            return ts, recorded
        self._make_step = (attn_injected, attn_injected.make_sampler_step)
        attn_injected.make_sampler_step = make_step
        self.request(-1, self.tr["warmup_steps"])
        self.rec.requests.clear()

    def request_inputs(self, i: int):
        rng = inputs.rng_for(self.ctx.seed, 1, i)
        prompts = [inputs.prompt(rng) for _ in range(self.tr["batch"])]
        return prompts, inputs.request_seed(rng), inputs.stroke_sketch(rng, self.tr["size"])

    def checked_steps(self, i: int) -> List[int]:
        rng = inputs.rng_for(self.ctx.seed, 5, i)
        return sorted(int(j) for j in rng.choice(self.tr["steps"], self.tr["check"]["steps"],
                                                 replace=False))

    def request(self, i: int, steps: int) -> np.ndarray:
        prompts, seed, sketch = self.request_inputs(i)
        self.rec.start(self.checked_steps(i) if steps == self.tr["steps"] else ())
        img = self.pipe(prompts, num_inference_steps=steps, guidance_scale=self.tr["guidance"],
                        width=self.tr["size"], height=self.tr["size"], seed=seed,
                        strength=self.tr["strength"], spimg=sketch)
        cur = self.rec.finish()
        cur.update(index=i, flags=self.pipe.last_nsfw_flags, returned=img)
        return img

    def window(self, seconds: float) -> Dict:
        dev = self.ctx.device
        if self.ctx.trace and dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        i = 0
        while i == 0 or time.perf_counter() < t0 + seconds:
            start = time.perf_counter()
            img = self.request(i, self.tr["steps"])
            self.unit_seconds.append(time.perf_counter() - start)
            self.rec.to_host()
            self.attempted += 1
            self.failed += int(not np.isfinite(img).all())
            self.images += img.shape[0]
            i += 1
        if self.ctx.trace and dev.type == "cuda":
            self.window_peak_bytes = torch.cuda.max_memory_allocated(dev)
        self.log(f"request seconds: {[round(t, 4) for t in self.unit_seconds]}")
        return {"images_per_s": (self.images / sum(self.unit_seconds), "images/s")}

    def profile(self) -> None:
        """``profiled_requests`` whole requests under the profiler recording
        the device alone, then as many recording the host's operations and
        the kernel ranges."""
        dev, n = self.ctx.device, self.tr["profiled_requests"]
        with trace.profiled(dev, cpu=False) as alone:
            for j in range(n):
                self.request(-2 - j, self.tr["steps"])
        with trace.KernelRanges() as kr, trace.profiled(dev, cpu=True) as hosted:
            for j in range(n):
                self.request(-2 - n - j, self.tr["steps"])
        del self.rec.requests[-2 * n:]
        self.kernel_calls = dict(kr.calls)
        self.trace_summary = trace.combine(trace.summarize(alone), trace.summarize(hosted))
        self.work = self.request_work()
        self.profiled_work = n * self.work

    def request_work(self) -> flop_counts.Work:
        """The work of one request: the prompts' encodes, the sketch's ViT,
        the injected UNet at twice the batch each step, the decode and the
        safety checker."""
        c, cfg, b = flop_counts.Counter(self.cfg), self.cfg, self.tr["batch"]
        hw = self.tr["size"] // 8
        n_ctx = cfg["text_encoder"]["max_position_embeddings"]
        return (2 * c.text(b, n_ctx) + c.vision("vision", 1)
                + self.tr["steps"] * c.unet(2 * b, hw, n_ctx, inject=True)
                + c.vae_decode(b, hw) + c.vision("safety_checker", b))

    def release(self) -> None:
        self.rec.remove()
        mod, fn = self._make_step
        mod.make_sampler_step = fn
        self.pipe = None

    def check(self):
        chk, dev, cfg = self.tr["check"], self.ctx.device, self.cfg
        done = self.rec.requests
        rng = inputs.rng_for(self.ctx.seed, 2)
        picks = sorted(rng.choice(len(done), min(chk["requests"], len(done)), replace=False))
        r32 = models.reference(cfg, self.ctx.seed, TREES, dev)
        sides = {"program": r32}
        if self.ctx.control:
            sides["control"] = models.lower_precision(cfg, r32)
        nums: Dict[str, Dict[str, float]] = {k: {} for k in sides}
        steps, b, chunk = self.tr["steps"], self.tr["batch"], chk["chunk"]
        solver = ref.DPMSolver(steps)
        tok = inputs.StandInTokenizer()
        n_ctx = cfg["text_encoder"]["max_position_embeddings"]
        size = cfg["vision"]["image_size"]
        scale = torch.full((chunk, 1, 1), float(self.tr["strength"]), device=dev)

        def worst(side, key, value):
            nums[side][key] = max(nums[side].get(key, 0.0), value)

        for p in picks:
            got = done[p]
            prompts, seed, sketch = self.request_inputs(got["index"])
            ids = np.asarray(tok(prompts + [""] * b, max_length=n_ctx).input_ids)
            base = {}
            for side, m in sides.items():
                ctx = precision.tf32 if side == "control" else contextlib.nullcontext
                with ctx(), torch.no_grad():
                    states = ref.encode_prompts(m.text, ids, dev)
                    cond, uncond = states[:b], states[b:]
                    hidden = m.vision(ref.sketch_pixels(sketch, size, dev))
                if side == "program":
                    base.update(cond=cond, uncond=uncond, hidden=hidden)
                    g_cond, g_uncond = got["context"][b:].to(dev), got["context"][:b].to(dev)
                    g_hidden = got["hidden"].to(dev)
                else:
                    g_cond, g_uncond, g_hidden = cond, uncond, hidden
                worst(side, "text_rel", max(ref.rel(g_cond, base["cond"]),
                                            ref.rel(g_uncond, base["uncond"])))
                worst(side, "vit_rel", ref.rel(g_hidden, base["hidden"]))
                for i, (x, x0_prev, x_next, x0) in sorted(got["steps"].items()):
                    x, x_next, x0 = x.to(dev).float(), x_next.to(dev), x0.to(dev)
                    parts = []
                    for s in range(0, b, chunk):
                        n = min(chunk, b - s)
                        h = hidden.expand(n, -1, -1)
                        with ctx():
                            parts.append(ref.plain_eps(
                                m, solver, int(i), x[s:s + n], uncond[s:s + n], cond[s:s + n],
                                self.tr["guidance"], injection=torch.cat([torch.zeros_like(h), h]),
                                scale=torch.cat([scale[:n], scale[:n]])))
                    eps = torch.cat(parts)
                    x0_prev = x0_prev.to(dev).float()
                    if side == "program":
                        base[int(i)] = eps
                        # the epsilon the step used, read back from its x0 and its x_next
                        e_got = solver.eps_from_x0(int(i), x, x0.float())
                        n_got = solver.eps_from_next(int(i), x, x0_prev, x_next.float())
                    else:
                        e_got = n_got = eps
                    worst(side, "eps_rel", ref.rel(e_got, base[int(i)]))
                    worst(side, "next_eps_rel", ref.rel(n_got, base[int(i)]))
                with ctx(), torch.no_grad():
                    img, flags = ref.decode_checked(m, got["final"].to(dev).float(),
                                                    cfg["safety_checker"]["image_size"], chunk)
                if side == "program":
                    base["image"] = img
                    img_got = torch.as_tensor(got["returned"], device=dev).permute(0, 3, 1, 2)
                    if (np.asarray(got["flags"]) != flags).any():
                        self.log(f"request {got['index']}: NSFW flags {got['flags']}, "
                                 f"reference {flags}")
                        self.failed += 1
                else:
                    img_got = img
                worst(side, "image_rel", ref.rel(img_got - 0.5, base["image"] - 0.5))
        return nums["program"], nums.get("control")
