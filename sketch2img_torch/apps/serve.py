"""HTTP serving of sketch-guided generation — counterpart of
``sketch2img_tpu/apps/serve.py``, with the same API (stdlib http.server), on
one GPU or, under ``torchrun``, on several:

  GET  /healthz              -> {"status": "ok", "warm": true/false}
  GET  /metrics              -> request/image/error counts, batch-size
                                histogram, p50/p95 generation latency
  POST /generate             -> PNG bytes (default) or JSON

POST body (JSON):
  prompt (str or list, required), negative_prompt, num_inference_steps,
  guidance_scale, width, height, seed (int or per-image list),
  num_images_per_prompt, solver ("dpm++"|"ddim"),
  sketch_png_b64 (base64 PNG/JPEG sketch, optional), response ("png"|"json")

With ``stream: true`` the response is Server-Sent Events instead:
``event: progress`` lines per solver step(s) — cadence set by
``progress_every`` (default steps/10) — then one ``event: result`` with
the JSON payload (b64 PNGs + nsfw flags). ``preview: true`` adds per-image
latent->RGB thumbnails to every progress event (a host-side linear
projection of the callback's latents, fetched channels-last). Streaming
requests bypass the micro-batcher (progress is per-request) and are
sketch/text2img only.

With ``mode: "inject"`` (the server started with an injection pipeline) the
request routes to ``ClipGuidedPipeline``: the sketch conditions through
CLIP-ViT attention injection rather than LGP gradient guidance, and
``strength`` (0..1, default 0.5) sets the injection scale. Inject requests
take prompt lists, per-image ``seed`` lists and per-image ``strength``
lists like the main route and take part in the micro-batcher
(single-prompt scalar-seed requests merge, each keeping its own sketch and
strength); streaming is not supported for inject. Their responses carry
``nsfw: null``, as the JAX server's do; when the components hold a safety
checker, the pipeline has already blacked out the images it flagged.

Behaviour:
  * one warmup generation per --warmup size at startup, so the kernels'
    first-use build, cuDNN's plans and the allocator's pools are made before
    the server accepts traffic;
  * device work is serialised through one worker lock: the handler threads
    and the batcher thread each launch work on the card, one pipeline call
    at a time (the guided steps turn autograd on themselves, so the thread
    that runs a call needs no grad-mode set-up);
  * requests snap width/height to the demo's 8px grid;
  * load shedding: beyond --max_pending admitted-but-unfinished requests,
    respond 503 + Retry-After instead of stacking multi-second generations;
    with --request_timeout_s, a request stuck waiting for the device that
    long gets a 504 (and, if it was micro-batch-queued, is dropped before
    any device work runs for it);
  * graceful shutdown: SIGTERM/SIGINT stop accepting connections and let
    in-flight generations finish.

Several GPUs: one process per GPU under ``torchrun``, with
``--data_parallel`` x ``--model_parallel`` equal to the job's world size.
Rank 0 owns the HTTP server; each pipeline call it makes (warm-up
included) is broadcast to the other ranks (``broadcast_object_list`` of the
call's arguments over a gloo group), which run the same call on their own
rows of the batch (data axis) or their own attention heads (model axis);
the pipeline gathers the images, so rank 0 answers with the whole batch.
The injection route is data-parallel only: ``--inject_attn_weights`` with
``--model_parallel`` above 1 is refused at start-up, as in the JAX package.

Usage:
  python -m sketch2img_torch.apps.serve --model_path /path/to/sd15 \\
      --lgp_path edge_predictor.pt [--host 0.0.0.0] [--port 8000] \\
      [--warmup 512x512x50] [--batch_window_ms 20] \\
      [--inject_attn_weights sketch_attn_model.pt]
  torchrun --nproc_per_node 4 -m sketch2img_torch.apps.serve ... --data_parallel 4
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import datetime
import io
import json
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def _png_bytes(img01: np.ndarray) -> bytes:
    from PIL import Image

    arr = (np.clip(img01, 0.0, 1.0) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


# SD1.x latent-channel -> RGB linear approximation (the community-standard
# preview projection used in place of a VAE decode), applied on the host.
_LATENT_RGB = np.array([[0.298, 0.207, 0.208],
                        [0.187, 0.286, 0.173],
                        [-0.158, 0.189, 0.264],
                        [-0.184, -0.271, -0.473]], np.float32)


def _latents_nhwc(latents) -> np.ndarray:
    """The pipelines' callback latents, (B, 4, h, w) tensors on the device
    -> (B, h, w, 4) float32 host arrays, the layout the projection takes."""
    return latents.detach().float().permute(0, 2, 3, 1).cpu().numpy()


def _latent_preview_b64(latents: np.ndarray) -> list:
    """(B, h, w, 4) sampling-space latents -> list of b64 PNG thumbnails
    ((h, w) pixels, ~3 KB each at 512px generations)."""
    rgb = latents.astype(np.float32) @ _LATENT_RGB  # (B, h, w, 3)
    rgb = rgb * 0.5 + 0.5  # approx [-2, 2] sigma -> [0, 1]
    return [base64.b64encode(_png_bytes(im)).decode() for im in rgb]


def _decode_sketch(b64: str) -> np.ndarray:
    from PIL import Image

    img = Image.open(io.BytesIO(base64.b64decode(b64)))
    return np.asarray(img, np.float32) / 255.0


def _snap(v, lo=64, hi=1024, step=8) -> int:
    return max(lo, min(hi, (int(v) // step) * step))


class _Batcher:
    """Cross-request micro-batching.

    Per-image seed lists AND per-image sketch lists make a batched result
    depend only on its own request (``SketchGuidedPipeline`` gives each
    image of a seed list a generator of its own), so compatible requests —
    same (steps, size, guidance, solver, negative, sketch-or-not), single
    prompt, one image — arriving within ``window_s`` merge into one
    pipeline call, each request keeping its OWN sketch. On the card the
    merged call runs at another batch size, so its images match the solo
    runs to rounding, not bit for bit.
    """

    def __init__(self, pipe, lock, window_s: float, max_batch: int,
                 metrics=None, inject_pipe=None):
        self.pipe = pipe
        self.inject_pipe = inject_pipe
        self.lock = lock
        self.window = window_s
        self.max_batch = max_batch
        self.metrics = metrics
        self.q: queue.Queue = queue.Queue()
        self.calls = 0  # observability + tests
        threading.Thread(target=self._run, daemon=True).start()

    def submit(self, params: dict, sketch, timeout: float | None = None):
        item = {"params": params, "sketch": sketch,
                "started": threading.Event(), "event": threading.Event(),
                "abandoned": False, "lock": threading.Lock()}
        self.q.put(item)
        # the timeout bounds QUEUEING (window sweep + waiting behind other
        # device work) — once this item's device work starts, wait it out.
        # abandon-vs-start is decided atomically under the item lock, so
        # exactly one of (client 504s AND the worker drops it) / (the
        # worker runs it AND the client takes the late result) happens —
        # never a 504 paired with wasted multi-second device work
        if timeout is not None and not item["started"].wait(timeout):
            with item["lock"]:
                if not item["started"].is_set():
                    item["abandoned"] = True
                    raise TimeoutError(
                        f"generation not started within {timeout:g}s")
            # the worker won the race under the lock — result is coming
        item["event"].wait()
        if "error" in item:
            raise item["error"]
        return item["imgs"], item["nsfw"]

    @staticmethod
    def _key(it):
        # sketch CONTENT is per-image (the pipeline takes one sketch per
        # batch entry); sketch-vs-no-sketch and the sketch resolution gate
        # merging (one VAE encode stacks the sketches). On the inject route
        # the sketch resolution doesn't gate (every sketch resizes to the
        # CLIP input size), and strength is per image, so neither is in the
        # key.
        p = it["params"]
        sk = it["sketch"]
        mode = p.get("mode", "sketch")
        if mode == "inject":
            return ("inject", p["num_inference_steps"], p["width"],
                    p["height"], p["guidance_scale"], p["negative_prompt"],
                    sk is None)
        return (p["num_inference_steps"], p["width"], p["height"],
                p["guidance_scale"], p["solver"], p["negative_prompt"],
                None if sk is None else sk.shape)

    def _run(self):
        while True:
            batch = [self.q.get()]
            deadline = time.monotonic() + self.window
            while len(batch) < self.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    batch.append(self.q.get(timeout=left))
                except queue.Empty:
                    break
            groups: dict = {}
            for it in batch:
                if it["abandoned"]:  # client timed out while queued
                    continue
                groups.setdefault(self._key(it), []).append(it)
            for items in groups.values():
                self._process(items)

    def _process(self, items):
        try:
            with self.lock:
                # commit point, per item, atomic with the client's abandon
                # decision: a client may have timed out (504) while this
                # group waited behind other device work — don't burn a
                # generation for it
                kept = []
                for it in items:
                    with it["lock"]:
                        if it["abandoned"]:
                            continue
                        it["started"].set()  # stops the submit 504 clock
                        kept.append(it)
                items = kept
                if not items:
                    return
                p0 = items[0]["params"]
                prompts = [it["params"]["prompt"] for it in items]
                seeds = [it["params"]["seed"] for it in items]
                if self.metrics is not None:
                    with self.metrics["lock"]:
                        key = str(len(items))
                        self.metrics["batch_sizes"][key] = (
                            self.metrics["batch_sizes"].get(key, 0) + 1)
                sketches = [it["sketch"] for it in items]
                self.calls += 1
                if p0.get("mode") == "inject":
                    # per-image seeds AND per-image strengths keep each
                    # merged request's result its solo run's
                    imgs = self.inject_pipe(
                        prompts,
                        negative_prompt=p0["negative_prompt"],
                        num_inference_steps=p0["num_inference_steps"],
                        guidance_scale=p0["guidance_scale"],
                        width=p0["width"], height=p0["height"],
                        seed=seeds,
                        strength=[it["params"]["strength"] for it in items],
                        spimg=(None if sketches[0] is None else sketches),
                    )
                    flags = None  # the inject route's contract: nsfw null
                else:
                    imgs = self.pipe(
                        prompts,
                        negative_prompt=p0["negative_prompt"],
                        num_inference_steps=p0["num_inference_steps"],
                        guidance_scale=p0["guidance_scale"],
                        width=p0["width"], height=p0["height"],
                        seed=seeds,
                        sketch_image=(None if sketches[0] is None
                                      else sketches),
                        solver=p0["solver"],
                    )
                    flags = self.pipe.last_nsfw_flags
            imgs = np.asarray(imgs)
            for i, it in enumerate(items):
                it["imgs"] = imgs[i:i + 1]
                it["nsfw"] = ([bool(flags[i])] if flags is not None else None)
                it["event"].set()
        except Exception as e:  # deliver the error to every waiter
            for it in items:
                it["error"] = e
                it["event"].set()


class GenerateHandler(BaseHTTPRequestHandler):
    """Class attributes ``pipe`` (SketchGuidedPipeline), ``lock``, ``state``
    are installed by make_server()."""

    pipe = None
    inject_pipe = None  # ClipGuidedPipeline, when serving the clip variant
    lock: threading.Lock = None
    state: dict = None
    batcher: "_Batcher" = None

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _locked(self, timeout):
        """The worker lock as a context manager with an acquire deadline —
        a request stuck behind minutes of queued device work gets a 504
        instead of holding its socket open forever."""
        lock = self.lock

        @contextlib.contextmanager
        def cm():
            if not lock.acquire(timeout=-1 if timeout is None else timeout):
                raise TimeoutError(
                    f"device busy for {timeout:g}s (queued work ahead)")
            try:
                yield
            finally:
                lock.release()

        return cm()

    def _json(self, code: int, obj) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            self._json(200, {"status": "ok", "warm": self.state["warm"]})
        elif self.path == "/metrics":
            m = self.state["metrics"]
            with m["lock"]:
                lat = sorted(m["latencies"][-512:])
                self._json(200, {
                    "requests": m["requests"],
                    "errors": m["errors"],
                    "images": m["images"],
                    "pending": m["pending"],
                    "shed": m["shed"],
                    "timeouts": m["timeouts"],
                    "batch_sizes": dict(sorted(m["batch_sizes"].items())),
                    "latency_p50_s": lat[len(lat) // 2] if lat else None,
                    "latency_p95_s": (lat[int(len(lat) * 0.95)]
                                      if lat else None),
                })
        else:
            self._json(404, {"error": "unknown path"})

    def do_POST(self):
        if self.path != "/generate":
            return self._json(404, {"error": "unknown path"})
        m = self.state["metrics"]
        with m["lock"]:  # admission decision only — no I/O under the lock
            shed_pending = None
            if m["pending"] >= self.state["max_pending"]:
                # load shedding: a full queue of multi-second generations
                # serves nobody — fail fast so the client can retry or
                # route elsewhere
                m["shed"] += 1
                shed_pending = m["pending"]
            else:
                m["pending"] += 1
        if shed_pending is not None:
            self.send_response(503)
            body = json.dumps({"error": "overloaded: "
                               f"{shed_pending} requests pending"}).encode()
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Retry-After", "5")
            self.end_headers()
            self.wfile.write(body)
            return
        try:
            self._do_generate()
        finally:
            with m["lock"]:
                m["pending"] -= 1

    def _do_generate(self):
        try:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            prompt = req["prompt"]
            if req.get("solver", "dpm++") not in ("dpm++", "ddim"):
                raise ValueError(f"unknown solver {req['solver']!r}")
            if req.get("mode", "sketch") not in ("sketch", "inject"):
                raise ValueError(f"unknown mode {req['mode']!r}")
            if req.get("mode") == "inject":
                if self.inject_pipe is None:
                    raise ValueError(
                        "injection route not enabled (start the server "
                        "with --inject_attn_weights)")
                if req.get("stream"):
                    raise ValueError("stream is not supported for "
                                     "mode=inject")
                if isinstance(req.get("strength"), list):
                    req["strength"] = list(map(float, req["strength"]))
                    n = len(prompt) if isinstance(prompt, list) else 1
                    if len(req["strength"]) != n:
                        raise ValueError(
                            f"got {len(req['strength'])} strengths for "
                            f"{n} prompts")
                if isinstance(req.get("seed"), list):
                    n = len(prompt) if isinstance(prompt, list) else 1
                    if len(req["seed"]) != n:
                        raise ValueError(
                            f"got {len(req['seed'])} seeds for "
                            f"{n} prompts")
            if isinstance(req.get("seed"), list):
                req["seed"] = list(map(int, req["seed"]))
            else:
                # a scalar-seed batch must divide the pipeline's
                # data-parallel width (its mesh's data axis, 1 without one):
                # surface it as a client error, the fix (seed=[...]) is
                # client-side
                if req.get("mode") == "inject":
                    dp = getattr(self.inject_pipe, "_dp", 1)
                    n = len(prompt) if isinstance(prompt, list) else 1
                else:
                    dp = getattr(self.pipe, "_dp", 1)
                    n = ((len(prompt) if isinstance(prompt, list) else 1)
                         * int(req.get("num_images_per_prompt", 1)))
                if n > 1 and n % dp:
                    raise ValueError(
                        f"batch {n} doesn't divide the server's "
                        f"data-parallel axis ({dp}): pass per-image seeds "
                        "(seed=[...]) or use a divisible batch")
            if req.get("sketch_png_b64"):
                _decode_sketch(req["sketch_png_b64"])  # validate early
        except Exception as e:  # malformed client input, not a server fault
            return self._json(400, {"error": f"bad request: {e}"})

        t0 = time.monotonic()
        timeout = self.state["request_timeout_s"]
        try:
            b64 = req.get("sketch_png_b64")
            sketch = _decode_sketch(b64) if b64 else None
            if req.get("mode") == "inject":
                seed = (req["seed"] if isinstance(req.get("seed"), list)
                        else int(req.get("seed", 0)))
                strength = req.get("strength", 0.5)
                params = {
                    "mode": "inject",
                    "prompt": prompt,
                    "negative_prompt": req.get("negative_prompt", ""),
                    "num_inference_steps": int(
                        req.get("num_inference_steps", 25)),
                    "guidance_scale": float(req.get("guidance_scale", 7.5)),
                    "width": _snap(req.get("width", 512)),
                    "height": _snap(req.get("height", 512)),
                    "seed": seed,
                    "strength": (strength if isinstance(strength, list)
                                 else float(strength)),
                }
                batchable = (self.batcher is not None
                             and self.batcher.inject_pipe is not None
                             and isinstance(prompt, str)
                             and not isinstance(seed, list)
                             and not isinstance(strength, list))
                if batchable:
                    # resolve seed 0 server-side so batched results stay
                    # deterministic per request (merge contract)
                    params["seed"] = seed or int(
                        np.random.randint(1, 2**31 - 1))
                    imgs, _ = self.batcher.submit(params, sketch,
                                                  timeout=timeout)
                else:
                    with self._locked(timeout):
                        imgs = self.inject_pipe(
                            prompt, spimg=sketch,
                            **{k: v for k, v in params.items()
                               if k not in ("mode", "prompt")})
                # nsfw None on this route (the JAX server's contract)
                return self._respond(req, np.asarray(imgs), None, t0)
            n_per = int(req.get("num_images_per_prompt", 1))
            seed = (req["seed"] if isinstance(req.get("seed"), list)
                    else int(req.get("seed", 0)))
            params = {
                "prompt": prompt,
                "negative_prompt": req.get("negative_prompt", ""),
                "num_inference_steps": int(req.get("num_inference_steps", 50)),
                "guidance_scale": float(req.get("guidance_scale", 7.5)),
                "width": _snap(req.get("width", 512)),
                "height": _snap(req.get("height", 512)),
                "seed": seed,
                "solver": req.get("solver", "dpm++"),
            }
            if req.get("stream"):
                # SSE progress is per-request — bypass the batcher; the
                # lock is taken before headers so queue timeouts still 504
                return self._stream_generate(req, params, sketch, n_per,
                                             timeout, t0)
            batchable = (self.batcher is not None
                         and isinstance(prompt, str) and n_per == 1
                         and not isinstance(seed, list))
            if batchable:
                # resolve seed 0 server-side so batched results stay
                # deterministic per request; per-image seed lists make
                # the result independent of what it gets batched with
                params["seed"] = seed or int(np.random.randint(1, 2**31 - 1))
                imgs, nsfw = self.batcher.submit(params, sketch,
                                                 timeout=timeout)
            else:
                with self._locked(timeout):
                    imgs = self.pipe(num_images_per_prompt=n_per,
                                     sketch_image=sketch, **params)
                    nsfw = (list(map(bool, self.pipe.last_nsfw_flags))
                            if self.pipe.last_nsfw_flags is not None else None)
        except TimeoutError as e:  # queued too long behind other work
            m = self.state["metrics"]
            with m["lock"]:
                m["requests"] += 1
                m["timeouts"] += 1
            return self._json(504, {"error": f"timeout: {e}"})
        except Exception as e:  # surface the error to the client, keep serving
            m = self.state["metrics"]
            with m["lock"]:
                m["requests"] += 1
                m["errors"] += 1
            return self._json(500, {"error": f"{type(e).__name__}: {e}"})

        return self._respond(req, np.asarray(imgs), nsfw, t0)

    def _stream_generate(self, req, params, sketch, n_per, timeout,
                         t0: float):
        """Server-Sent Events response: ``event: progress`` per
        ``progress_every`` solver steps (the pipeline's
        ``callback(i, t, latents)`` hook), then ``event: result`` with the
        JSON payload. The device lock is taken BEFORE headers go out so a
        queue timeout still surfaces as a clean 504; after headers,
        failures become an ``event: error``."""
        m = self.state["metrics"]
        steps = params["num_inference_steps"]
        every = int(req.get("progress_every", 0)) or max(1, steps // 10)
        with self._locked(timeout):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            wlock = threading.Lock()
            dead = []

            def send(event, obj):
                data = (f"event: {event}\n"
                        f"data: {json.dumps(obj)}\n\n").encode()
                with wlock:
                    if dead:
                        return
                    try:
                        self.wfile.write(data)
                        self.wfile.flush()
                    except OSError:
                        # client went away mid-generation; let the device
                        # work finish, drop further events
                        dead.append(1)

            preview = bool(req.get("preview"))

            def cb(i, t, latents):
                obj = {"step": int(i) + 1, "total": steps,
                       "timestep": int(t)}
                if preview:
                    obj["previews"] = _latent_preview_b64(
                        _latents_nhwc(latents))
                send("progress", obj)

            try:
                imgs = self.pipe(num_images_per_prompt=n_per,
                                 sketch_image=sketch, callback=cb,
                                 callback_steps=every, **params)
                nsfw = (list(map(bool, self.pipe.last_nsfw_flags))
                        if self.pipe.last_nsfw_flags is not None else None)
            except Exception as e:
                with m["lock"]:
                    m["requests"] += 1
                    m["errors"] += 1
                send("error", {"error": f"{type(e).__name__}: {e}"})
                return
        imgs = np.asarray(imgs)
        if imgs.ndim == 3:
            imgs = imgs[None]
        with m["lock"]:
            m["requests"] += 1
            m["images"] += imgs.shape[0]
            m["latencies"].append(time.monotonic() - t0)
            del m["latencies"][:-2048]
        send("result", {
            "images": [base64.b64encode(_png_bytes(i)).decode()
                       for i in imgs],
            "nsfw": nsfw,
        })

    def _respond(self, req, imgs: np.ndarray, nsfw, t0: float):
        m = self.state["metrics"]
        with m["lock"]:
            m["requests"] += 1
            m["images"] += (1 if imgs.ndim == 3 else imgs.shape[0])
            m["latencies"].append(time.monotonic() - t0)
            del m["latencies"][:-2048]
        if imgs.ndim == 3:
            imgs = imgs[None]
        if req.get("response", "png") == "json":
            return self._json(200, {
                "images": [base64.b64encode(_png_bytes(i)).decode()
                           for i in imgs],
                "nsfw": nsfw,
            })
        body = _png_bytes(imgs[0])
        self.send_response(200)
        self.send_header("Content-Type", "image/png")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def make_server(pipe, host: str = "127.0.0.1", port: int = 8000,
                batch_window_ms: float = 0.0, max_batch: int = 4,
                inject_pipe=None, max_pending: int = 32,
                request_timeout_s: float | None = None):
    """Build (but don't start) the HTTP server around a pipeline. The
    handler serializes device work through one lock. With
    ``batch_window_ms > 0``, compatible concurrent requests micro-batch
    into one pipeline call (see _Batcher). ``inject_pipe`` (a
    ClipGuidedPipeline sharing the same components) enables the
    ``mode: "inject"`` route. ``max_pending`` bounds admitted-but-unfinished
    generations — beyond it requests are shed with a 503 + Retry-After
    instead of stacking multi-second device work. ``request_timeout_s``
    bounds how long a request may wait for the device before a 504."""
    lock = threading.Lock()
    metrics = {"lock": threading.Lock(), "requests": 0, "errors": 0,
               "images": 0, "pending": 0, "shed": 0, "timeouts": 0,
               "batch_sizes": {}, "latencies": []}
    handler = type("Handler", (GenerateHandler,), {
        "pipe": pipe,
        "inject_pipe": inject_pipe,
        "lock": lock,
        "state": {"warm": False, "metrics": metrics,
                  "max_pending": max_pending,
                  "request_timeout_s": request_timeout_s},
        "batcher": (_Batcher(pipe, lock, batch_window_ms / 1e3, max_batch,
                             metrics=metrics, inject_pipe=inject_pipe)
                    if batch_window_ms > 0 else None),
    })
    server = ThreadingHTTPServer((host, port), handler)
    server.handler_class = handler
    return server


def warmup(server, sizes, *, sketch: bool = True) -> None:
    """Run each (width, height, steps) before taking traffic — the text2img
    and the sketch-guided calls, and with micro-batching on every batch
    size up to max_batch (a list of per-image sketches, the batcher's own
    call): the first request then finds the kernels built and cuDNN's plans
    made."""
    h = server.handler_class
    batches = ([1] if h.batcher is None
               else list(range(1, h.batcher.max_batch + 1)))
    for (w, ht, steps) in sizes:
        for b in batches:
            h.pipe(["warmup"] * b, num_inference_steps=steps, width=w,
                   height=ht, seed=list(range(1, b + 1)))
            if sketch:
                sk = np.ones((ht, w), np.float32)
                h.pipe(["warmup"] * b, num_inference_steps=steps, width=w,
                       height=ht, seed=list(range(1, b + 1)),
                       sketch_image=(sk if b == 1
                                     else [sk.copy() for _ in range(b)]))
        if h.inject_pipe is not None:
            for b in batches:
                # b > 1 warms the batcher's merged call: prompt list,
                # per-image seeds/strengths, per-image sketch list
                one = b == 1
                sk = np.ones((ht, w), np.float32)
                h.inject_pipe(
                    "warmup" if one else ["warmup"] * b,
                    num_inference_steps=steps, width=w, height=ht,
                    seed=1 if one else list(range(1, b + 1)),
                    strength=0.5 if one else [0.5] * b,
                    spimg=(sk if one else [sk.copy() for _ in range(b)]))
    h.state["warm"] = True


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--lgp_path", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--warmup", default="512x512x50",
                    help="comma-separated WxHxSTEPS list; empty to skip")
    ap.add_argument("--batch_window_ms", type=float, default=0.0,
                    help="micro-batch compatible requests arriving within "
                         "this window (0 = off)")
    ap.add_argument("--max_batch", type=int, default=4)
    ap.add_argument("--max_pending", type=int, default=32,
                    help="load shedding: admitted-but-unfinished request "
                         "cap; beyond it respond 503 + Retry-After")
    ap.add_argument("--request_timeout_s", type=float, default=None,
                    help="504 a request that waits this long for the "
                         "device (default: wait forever)")
    ap.add_argument("--inject_attn_weights", default=None,
                    help="sketch_attn_model.pt or .npz — enables mode=inject "
                         "(the CLIP attention-injection variant)")
    ap.add_argument("--inject_clip_weights", default=None,
                    help="sketch_encoder_model.pt or .npz for mode=inject")
    ap.add_argument("--data_parallel", type=int, default=1,
                    help="shard request batches over this many GPUs "
                         "(data mesh axis; one torchrun process each)")
    ap.add_argument("--model_parallel", type=int, default=1,
                    help="Megatron-shard UNet attention over this many "
                         "GPUs (model mesh axis; per-request latency)")
    return ap.parse_args(argv)


def check_parallel_args(args, world_size: int, local_world_size: int,
                        device_count: int) -> None:
    """Exit with a message unless the job can run the asked mesh: one
    process per GPU (``--data_parallel`` x ``--model_parallel`` = the world
    size), a GPU for each process of a host, and no injection route under
    tensor parallelism."""
    n = args.data_parallel * args.model_parallel
    if n != world_size:
        raise SystemExit(
            f"--data_parallel x --model_parallel = {n} needs {n} processes, one per GPU "
            f"(torchrun --nproc_per_node {n} -m sketch2img_torch.apps.serve ...); this job "
            f"has {world_size}")
    if n > 1 and device_count < local_world_size:
        raise SystemExit(
            f"--data_parallel x --model_parallel = {n} needs {local_world_size} devices "
            f"on this host, found {device_count}")
    if args.inject_attn_weights and args.model_parallel > 1:
        # refuse loudly at startup: the injection route shards over data
        # only (ClipGuidedPipeline refuses a model axis)
        raise SystemExit(
            "--inject_attn_weights cannot be combined with "
            "--model_parallel > 1: the injection route is data-parallel "
            "only. Use --data_parallel for multi-GPU injection serving.")


class Leader:
    """Rank 0's side of a pipeline under a mesh: each call is broadcast to
    the follower ranks (``follow``) over ``channel`` before it runs here;
    every other attribute is the pipeline's. A callback stays on rank 0: the
    followers get a no-op one, so every rank gathers the callback's
    latents."""

    def __init__(self, pipe, kind: str, channel):
        self.pipe, self.kind, self.channel = pipe, kind, channel

    def __call__(self, *args, **kwargs):
        from sketch2img_torch.parallel.mesh import broadcast_object

        sent = {k: v for k, v in kwargs.items() if k != "callback"}
        broadcast_object((self.kind, args, sent, kwargs.get("callback") is not None),
                         self.channel)
        return self.pipe(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self.pipe, name)


def follow(pipes: dict, channel, log=print) -> int:
    """A follower rank's loop: run each call rank 0 broadcasts on the
    pipeline of its kind until rank 0 broadcasts None. A call that raises
    here raised on rank 0 too (the same arguments), which answers the
    client. -> the calls run."""
    from sketch2img_torch.parallel.mesh import broadcast_object

    n = 0
    while True:
        msg = broadcast_object(None, channel)
        if msg is None:
            return n
        kind, args, kwargs, has_callback = msg
        if has_callback:
            kwargs["callback"] = lambda i, t, latents: None
        try:
            pipes[kind](*args, **kwargs)
        except Exception as e:  # the client gets rank 0's error
            log(f"follower: {kind} call failed: {e}")
        n += 1


def make_channel():
    """The gloo group that carries the pipeline calls from rank 0: it waits
    as long as the server idles (NCCL and the default timeout would end the
    job after minutes without a request)."""
    import torch.distributed as dist

    return dist.new_group(backend="gloo", timeout=datetime.timedelta(days=365))


def main(argv=None):
    args = parse_args(argv)
    import torch

    from sketch2img_torch.parallel.mesh import initialize_distributed, world

    if args.data_parallel * args.model_parallel > 1:
        initialize_distributed("cuda")  # the torchrun environment
    rank, size = world()
    check_parallel_args(args, size, int(os.environ.get("LOCAL_WORLD_SIZE", size)),
                        torch.cuda.device_count())
    mesh = channel = None
    if size > 1:
        from sketch2img_torch.parallel import make_mesh

        mesh = make_mesh(model_parallel=args.model_parallel)
        channel = make_channel()

    from sketch2img_torch.apps.app import build_pipeline

    pipe = build_pipeline(args.model_path, args.lgp_path, mesh=mesh)
    inject_pipe = None
    if args.inject_attn_weights:
        from sketch2img_torch.apps.clip_guided_inf import ClipGuidedPipeline

        inject_pipe = ClipGuidedPipeline(
            attn_weights=args.inject_attn_weights,
            clip_weights=args.inject_clip_weights,
            components=pipe.c, mesh=mesh)
    if mesh is not None:
        if rank != 0:
            follow({"sketch": pipe, "inject": inject_pipe}, channel)
            return
        pipe = Leader(pipe, "sketch", channel)
        inject_pipe = (Leader(inject_pipe, "inject", channel)
                       if inject_pipe is not None else None)
    try:
        serve(args, pipe, inject_pipe)
    finally:
        if mesh is not None:  # release the followers
            from sketch2img_torch.parallel.mesh import broadcast_object

            broadcast_object(None, channel)


def serve(args, pipe, inject_pipe) -> None:
    """Build the server, warm it up, serve until SIGTERM/SIGINT."""
    server = make_server(pipe, args.host, args.port,
                         batch_window_ms=args.batch_window_ms,
                         max_batch=args.max_batch,
                         inject_pipe=inject_pipe,
                         max_pending=args.max_pending,
                         request_timeout_s=args.request_timeout_s)
    sizes = []
    for part in filter(None, args.warmup.split(",")):
        w, h, s = (int(x) for x in part.split("x"))
        sizes.append((w, h, s))
    print(f"warming up {sizes} ...", flush=True)
    warmup(server, sizes)

    import signal

    def _stop(signum, frame):
        # stop accepting connections; serve_forever returns once the
        # current poll completes, in-flight handler threads finish their
        # generations before the process exits
        print(f"signal {signum}: draining ...", flush=True)
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    print(f"serving on http://{args.host}:{args.port}", flush=True)
    server.serve_forever()
    print("drained, exiting", flush=True)


if __name__ == "__main__":
    main()
