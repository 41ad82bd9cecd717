"""Driver of the sketch-guided request: ``runtime.SketchGuidedPipeline``
called by one client, requests back to back.

Set-up builds the SD components and the LGP from the seeded weights,
then warms every shape the requests use with one short request (guided
steps, plain steps, the encodes, the decode and the safety checker).
The window sends requests until ``--seconds`` have passed; a request that
starts inside it finishes and counts. ``request_s`` is the summed time of
the window's requests over their count.

For the output check the driver keeps, of every request, what the timed
path's own calls received and produced: the arguments of
``sample_sketch_guided`` (initial noise, text states, sketch latent) and
its final latents, the (x, x0_prev) -> (x_next, x0) of the ``guided_step``
and ``plain_step`` calls drawn for checking, the returned image and the
flags. The wrappers sit on the module attributes the pipeline calls; after
each request (its time taken) the records move to host memory.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.counts import flops as flop_counts
from benchmark.harness import inputs, models, trace
from benchmark.harness.record import Recorder
from benchmark.reference import pipeline as ref
from benchmark.reference import precision

TREES = ("unet", "vae", "text_encoder", "safety_checker", "lgp")


def _rec_sample(cur, args, kw, out):
    cur["latents0"], cur["uncond"], cur["cond"], cur["target"] = args[4], args[5], args[6], args[7]
    cur["final"] = out


def _rec_guided(cur, args, kw, out):
    if args[4] in cur["want"]:
        cur["steps"][args[4]] = (args[6], args[7], out[0], out[1])


def _rec_plain(cur, args, kw, out):
    if args[2] in cur["want"]:
        cur["steps"][args[2]] = (args[4], args[5], out[0], out[1])


class Driver:
    def __init__(self, ctx, log):
        self.ctx, self.log = ctx, log
        self.cfg, self.tr = ctx.cfg, ctx.traffic
        self.attempted = self.failed = 0
        self.trace_summary = None
        self.marks: List[List[float]] = []
        self.unit_seconds: List[float] = []
        self.window_peak_bytes = None
        self.kernel_calls: Dict = {}
        self.work = self.profiled_work = None

    # -- the program ----------------------------------------------------------

    def setup(self) -> None:
        from sketch2img_torch.core.schedulers import make_schedule
        from sketch2img_torch.pipelines import sketch_guided
        from sketch2img_torch import runtime
        from sketch2img_torch.utils.device import set_precision

        dev = self.ctx.device
        set_precision()
        mods = {t: models.port_module(self.cfg, t, models.make_weights(self.cfg, self.ctx.seed,
                                                                       t, dev))
                for t in TREES}
        comps = runtime.SDComponents(
            unet=mods["unet"], vae=mods["vae"], text_encoder=mods["text_encoder"],
            schedule=make_schedule(), device=dev, tokenizer=inputs.StandInTokenizer(),
            lgp=mods["lgp"], safety_checker=mods["safety_checker"])
        self.pipe = runtime.SketchGuidedPipeline(comps)
        self.rec = Recorder()
        self.rec.wrap(runtime, "sample_sketch_guided", _rec_sample)
        self.rec.wrap(sketch_guided, "guided_step", _rec_guided)
        self.rec.wrap(sketch_guided, "plain_step", _rec_plain)
        self.request(-1, steps=self.tr["warmup_steps"])
        self.rec.requests.clear()

    def request_inputs(self, i: int):
        rng = inputs.rng_for(self.ctx.seed, 1, i)
        px = self.tr["size"]
        return inputs.prompt(rng), inputs.request_seed(rng), inputs.stroke_sketch(rng, px)

    def checked_steps(self, i: int) -> List[int]:
        """The steps of request ``i`` that the output check reads, drawn
        from the seed: guided ones and plain ones."""
        rng, chk, steps = inputs.rng_for(self.ctx.seed, 5, i), self.tr["check"], self.tr["steps"]
        n_g = ref.num_guided_steps(steps)
        return sorted(int(j) for j in np.concatenate([
            rng.choice(n_g, chk["guided_steps"], replace=False),
            n_g + rng.choice(steps - n_g, chk["plain_steps"], replace=False)]))

    def request(self, i: int, steps: int, callback=None) -> np.ndarray:
        prompt, seed, sketch = self.request_inputs(i)
        self.rec.start(self.checked_steps(i) if steps == self.tr["steps"] else ())
        img = self.pipe(prompt, num_inference_steps=steps, guidance_scale=self.tr["guidance"],
                        width=self.tr["size"], height=self.tr["size"], seed=seed,
                        sketch_image=sketch, callback=callback)
        cur = self.rec.finish()
        cur.update(index=i, flags=self.pipe.last_nsfw_flags, returned=img)
        return img

    def window(self, seconds: float) -> Dict:
        dev = self.ctx.device
        marks: List[float] = []

        def mark(i, t, x):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            marks.append(time.perf_counter())

        if self.ctx.trace and dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        i = 0
        while i == 0 or time.perf_counter() < t0 + seconds:
            marks = []
            start = time.perf_counter()
            img = self.request(i, self.tr["steps"], mark if self.ctx.trace else None)
            end = time.perf_counter()
            self.rec.to_host()
            self.attempted += 1
            self.failed += int(not np.isfinite(img).all())
            self.unit_seconds.append(end - start)
            self.marks.append([start] + marks + [end])
            i += 1
        if self.ctx.trace and dev.type == "cuda":
            self.window_peak_bytes = torch.cuda.max_memory_allocated(dev)
        self.log(f"request seconds: {[round(t, 4) for t in self.unit_seconds]}")
        return {"request_s": (sum(self.unit_seconds) / len(self.unit_seconds), "s")}

    def profile(self) -> None:
        """One whole request under the profiler recording the device alone,
        then one recording the host's operations and the kernel ranges."""
        dev = self.ctx.device
        with trace.profiled(dev, cpu=False) as alone:
            self.request(-2, self.tr["steps"])
        with trace.KernelRanges() as kr, trace.profiled(dev, cpu=True) as hosted:
            self.request(-3, self.tr["steps"])
        del self.rec.requests[-2:]
        self.kernel_calls = dict(kr.calls)
        self.trace_summary = trace.combine(trace.summarize(alone), trace.summarize(hosted))
        self.work = self.profiled_work = self.request_work()

    def request_work(self) -> flop_counts.Work:
        """The work of one request: the prompt pair's encodes, the sketch's
        VAE encode, each guided step's two UNet forwards (one with taps and
        the backward to the latent through them) and LGP head, each plain
        step's UNet at twice the batch, the decode and the safety checker."""
        c, cfg = flop_counts.Counter(self.cfg), self.cfg
        steps = self.tr["steps"]
        n_g = ref.num_guided_steps(steps)
        hw = self.tr["size"] // 8
        n_ctx = cfg["text_encoder"]["max_position_embeddings"]
        return (2 * c.text(1, n_ctx) + c.vae_encode(1, self.tr["size"])
                + n_g * (c.unet(1, hw, n_ctx) + c.unet_taps_grad(1, hw, n_ctx)
                         + c.lgp(1, hw, "input"))
                + (steps - n_g) * c.unet(2, hw, n_ctx) + c.vae_decode(1, hw)
                + c.vision("safety_checker", 1))

    def release(self) -> None:
        self.rec.remove()
        self.pipe = None

    # -- the output check -----------------------------------------------------

    def check(self):
        """Sampled requests and steps, each held to the reference from the
        program's own state at that step."""
        chk, dev, cfg = self.tr["check"], self.ctx.device, self.cfg
        done = self.rec.requests
        rng = inputs.rng_for(self.ctx.seed, 2)
        picks = sorted(rng.choice(len(done), min(chk["requests"], len(done)), replace=False))
        r32 = models.reference(cfg, self.ctx.seed, TREES, dev)
        sides = {"program": r32}
        if self.ctx.control:
            sides["control"] = models.lower_precision(cfg, r32)
        nums: Dict[str, Dict[str, float]] = {k: {} for k in sides}
        steps = self.tr["steps"]
        solver = ref.DPMSolver(steps)
        n_g = ref.num_guided_steps(steps)
        tok = inputs.StandInTokenizer()
        n_ctx = cfg["text_encoder"]["max_position_embeddings"]

        def worst(side, key, value):
            nums[side][key] = max(nums[side].get(key, 0.0), value)

        for p in picks:
            got = done[p]
            prompt, seed, sketch = self.request_inputs(got["index"])
            gen = torch.Generator().manual_seed(seed & 0x7FFFFFFF)
            hw = self.tr["size"] // 8
            lat0 = torch.randn(1, 4, hw, hw, generator=gen).to(dev)
            noise = torch.randn(1, 4, hw, hw, generator=gen).to(dev)
            ids = tok([prompt, ""], max_length=n_ctx).input_ids
            ref32 = None
            for side, m in sides.items():
                ctx = precision.tf32 if side == "control" else contextlib.nullcontext
                with ctx(), torch.no_grad():
                    cond, uncond = ref.encode_prompts(m.text, np.asarray(ids), dev).chunk(2)
                    mean, logvar = m.vae.encode(ref.sketch_vae_input(sketch, dev))
                    target = ref.sample_latent(mean, logvar, noise)
                if side == "program":
                    ref32 = {"cond": cond, "uncond": uncond, "target": target}
                    a = {k: got[k].to(dev) for k in ("cond", "uncond", "target")}
                else:
                    a = {"cond": cond, "uncond": uncond, "target": target}
                worst(side, "text_rel", max(ref.rel(a["cond"], ref32["cond"]),
                                            ref.rel(a["uncond"], ref32["uncond"])))
                worst(side, "sketch_rel", ref.rel(a["target"], ref32["target"]))
                for i, (x, x0_prev, x_next, x0) in sorted(got["steps"].items()):
                    kind = "guided" if i < n_g else "plain"
                    x, x0_prev = x.to(dev).float(), x0_prev.to(dev).float()
                    x_next, x0 = x_next.to(dev), x0.to(dev)
                    with ctx():
                        if kind == "guided":
                            eps, nudge, _ = ref.guided_step(
                                m, solver, int(i), x, x0_prev, lat0, uncond, cond, target,
                                self.tr["guidance"])
                        else:
                            eps = ref.plain_eps(m, solver, int(i), x, uncond, cond,
                                                self.tr["guidance"])
                    if side == "program":
                        ref32[i] = (eps, nudge if kind == "guided" else None)
                        e_got = solver.eps_from_x0(int(i), x, x0.float())
                        n_got = x_next.float() - solver.linear_part(int(i), x, x0.float(), x0_prev)
                    else:
                        e_got, n_got = eps, nudge if kind == "guided" else None
                    worst(side, "eps_rel", ref.rel(e_got, ref32[i][0]))
                    if kind == "guided":
                        worst(side, "nudge_rel", ref.rel(n_got, ref32[i][1]))
                with ctx(), torch.no_grad():
                    img, flags = ref.decode_checked(m, got["final"].to(dev).float(),
                                                    cfg["safety_checker"]["image_size"])
                if side == "program":
                    ref32["image"] = img
                    img_got = torch.as_tensor(got["returned"], device=dev)[None].permute(0, 3, 1, 2)
                    if (np.asarray(got["flags"]) != flags).any():
                        self.log(f"request {got['index']}: NSFW flags {got['flags']}, "
                                 f"reference {flags}")
                        self.failed += 1
                else:
                    img_got = img
                worst(side, "image_rel", ref.rel(img_got - 0.5, ref32["image"] - 0.5))
        return nums["program"], nums.get("control")

    # -- per-layer readings ---------------------------------------------------

    def step_ms(self, kind: str) -> float:
        """Median step time (ms) over the window's requests, from the
        synchronised step marks; the first step, which holds the prompt and
        sketch encodes, is left out."""
        steps = self.tr["steps"]
        n_g = ref.num_guided_steps(steps)
        js = range(1, n_g) if kind == "guided" else range(n_g, steps)
        d = [m[j + 1] - m[j] for m in self.marks if len(m) == steps + 2 for j in js]
        return 1e3 * statistics.median(d) if d else None

    def decode_ms(self) -> float:
        d = [m[-1] - m[-2] for m in self.marks if len(m) == self.tr["steps"] + 2]
        return 1e3 * statistics.median(d) if d else None
