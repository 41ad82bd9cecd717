"""The port's HTTP server (``sketch2img_torch/apps/serve.py``) against the
JAX package's (``sketch2img_tpu/apps/serve.py``).

Both servers run here side by side, each around its own instance of one
recording stub pipeline whose images are a deterministic function of
(prompt, seed, sketch, strength). The stubs differ only in what their
progress callback hands over: (B, h, w, 4) numpy on the JAX side (its
pipelines fetch the latents), (B, 4, h, w) tensors on the port's (the port's
pipelines pass their device tensors). The JAX server module imports only
numpy, so nothing here compiles. Every request goes to both servers, and the
status codes, the headers that matter (Content-Type, Retry-After), the
bodies (PNG bytes and b64 PNGs byte-equal), the SSE event streams (previews
included), ``/metrics`` and the keyword arguments each stub received are
held equal. Then one real request through the port's server on a tiny port
stack (2 steps at 64^2, CPU) equals the direct pipeline call, and the
kernels' library loads are held to one build under concurrent first use.
"""

import base64
import http.client
import io
import json
import re
import threading
import time
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from sketch2img_torch.apps import serve as tserve
from sketch2img_tpu.apps import serve as jserve

from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

PX = 64


def _seed_list(seed, n):
    return list(seed) if isinstance(seed, (list, tuple)) else [int(seed) + i for i in range(n)]


class StubPipe:
    """Records each call's keyword arguments; image i is noise drawn from a
    hash of (prompt i, seed i, sketch i, strength i); with a callback it
    emits latents every ``callback_steps`` steps; ``fail_next`` raises
    (a device fault); flags every image whose seed is odd."""

    def __init__(self, torch_latents: bool):
        self.torch_latents = torch_latents
        self.calls = []
        self.fail_next = 0
        self.last_nsfw_flags = None

    def __call__(self, prompt, **kw):
        self.calls.append(_canon({"prompt": prompt, **{k: v for k, v in kw.items()
                                                      if k != "callback"},
                                  "callback": kw.get("callback") is not None}))
        if self.fail_next:
            self.fail_next -= 1
            raise RuntimeError("injected device fault")
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        n_per = kw.get("num_images_per_prompt", 1)
        batch = len(prompts) * n_per
        h, w = kw.get("height", 512), kw.get("width", 512)
        seeds = _seed_list(kw.get("seed", 0), batch)
        sketch = kw.get("sketch_image", kw.get("spimg"))
        sketches = sketch if isinstance(sketch, list) else [sketch] * batch
        strength = kw.get("strength", 0.0)
        strengths = strength if isinstance(strength, list) else [strength] * batch
        imgs = []
        for i in range(batch):
            key = f"{prompts[i // n_per]}|{seeds[i]}|{strengths[i]}|"
            if sketches[i] is not None:
                key += str(zlib.crc32(np.ascontiguousarray(sketches[i], np.float32).tobytes()))
            rng = np.random.RandomState(zlib.crc32(key.encode()))
            imgs.append(rng.rand(h, w, 3).astype(np.float32))
        cb = kw.get("callback")
        if cb is not None:
            steps, every = kw["num_inference_steps"], kw.get("callback_steps", 1)
            for i in range(steps):
                if i % every == 0:
                    lat = np.random.RandomState(i).randn(batch, h // 8, w // 8, 4)
                    lat = lat.astype(np.float32)
                    if self.torch_latents:
                        lat = torch.from_numpy(lat).permute(0, 3, 1, 2)
                    cb(i, 999 - 10 * i, lat)
        self.last_nsfw_flags = np.array([s % 2 == 1 for s in seeds])
        single = isinstance(prompt, str) and n_per == 1
        return imgs[0] if single else np.stack(imgs)


def _canon(x):
    """Keyword arguments -> a comparable, JSON-like value (arrays by shape
    and content hash)."""
    if isinstance(x, dict):
        return {k: _canon(v) for k, v in sorted(x.items())}
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    if isinstance(x, np.ndarray):
        return ["ndarray", list(x.shape), str(x.dtype), zlib.crc32(np.ascontiguousarray(x).tobytes())]
    if isinstance(x, (np.integer, np.floating, np.bool_)):
        return x.item()
    return x


class Side:
    """One package's servers: ``plain`` (no micro-batching) and ``batched``
    (a 100 ms window, batches of 2), each with a sketch and an inject stub."""

    def __init__(self, mod, torch_latents):
        self.mod = mod
        self.stubs = {n: StubPipe(torch_latents) for n in ("plain", "plain_inj",
                                                           "batched", "batched_inj")}
        self.servers = {
            "plain": mod.make_server(self.stubs["plain"], "127.0.0.1", 0,
                                     inject_pipe=self.stubs["plain_inj"]),
            "batched": mod.make_server(self.stubs["batched"], "127.0.0.1", 0,
                                       batch_window_ms=100, max_batch=2,
                                       inject_pipe=self.stubs["batched_inj"]),
        }
        for srv in self.servers.values():
            mod.warmup(srv, [(PX, PX, 2)])
            threading.Thread(target=srv.serve_forever, args=(0.05,), daemon=True).start()

    def handler(self, name):
        return self.servers[name].handler_class

    def request(self, name, method, path, body=None):
        return _request(self.servers[name], method, path, body)

    def shutdown(self):
        for srv in self.servers.values():
            srv.shutdown()
            srv.server_close()


@pytest.fixture(scope="module")
def sides():
    out = {"jax": Side(jserve, False), "port": Side(tserve, True)}
    yield out
    for side in out.values():
        side.shutdown()


def _request(server, method, path, body=None):
    """-> status, Content-Type, Retry-After and the body (parsed JSON, or
    the raw bytes of a PNG or an event stream)."""
    conn = http.client.HTTPConnection("127.0.0.1", server.server_port, timeout=60)
    conn.request(method, path, body=json.dumps(body) if body is not None else None)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    kind = resp.getheader("Content-Type")
    if kind == "application/json":
        # an error may quote an object's repr; its address differs by process state
        data = json.loads(re.sub(rb" at 0x[0-9a-f]+", b"", data))
    return {"status": resp.status, "type": kind, "retry": resp.getheader("Retry-After"),
            "body": data}


def _both(sides, fn):
    """fn(side) on the JAX side, then on the port's -> (jax, port)."""
    return fn(sides["jax"]), fn(sides["port"])


def _sketch_b64(seed, size=PX):
    arr = np.random.RandomState(seed).randint(0, 256, (size, size), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


BASE = {"num_inference_steps": 2, "width": PX, "height": PX}

CASES = {
    "png": {"prompt": "a cat", "seed": 5, **BASE},
    "json_sketch": {"prompt": "a cat", "seed": 6, "response": "json",
                    "sketch_png_b64": _sketch_b64(1), **BASE},
    "prompt_list_seed_list": {"prompt": ["a cat", "a dog"], "seed": [3, 4], "response": "json",
                              "sketch_png_b64": _sketch_b64(2), **BASE},
    "n_per_prompt": {"prompt": ["a cat", "a dog"], "num_images_per_prompt": 2, "seed": 8,
                     "response": "json", "solver": "ddim", "negative_prompt": "bad", **BASE},
    "snapped_size": {"prompt": "a cat", "seed": 9, "width": 70, "height": 1100,
                     "num_inference_steps": 1, "response": "json"},
    "inject_lists": {"prompt": ["a cat", "a dog"], "mode": "inject", "seed": [1, 2],
                     "strength": [0.2, 0.8], "response": "json",
                     "sketch_png_b64": _sketch_b64(3), **BASE},
    "inject_scalar": {"prompt": "a cat", "mode": "inject", "seed": 7, "strength": 0.3,
                      "sketch_png_b64": _sketch_b64(4), **BASE},
    "bad_solver": {"prompt": "a cat", "solver": "euler", **BASE},
    "bad_mode": {"prompt": "a cat", "mode": "paint", **BASE},
    "no_prompt": {"steps": 2},
    "inject_stream": {"prompt": "a cat", "mode": "inject", "stream": True, **BASE},
    "inject_seed_count": {"prompt": ["a", "b"], "mode": "inject", "seed": [1], **BASE},
    "bad_sketch": {"prompt": "a cat", "sketch_png_b64": "bm90IGEgcG5n", **BASE},
}


@pytest.mark.parametrize("server", ["plain", "batched"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_request_answers_match_jax(sides, server, case):
    """One request (PNG, JSON, sketches, prompt and seed lists, images per
    prompt, the inject route with seed and strength lists, snapped sizes,
    and the 400s: bad solver or mode, no prompt, inject streaming, a seed
    count that does not match, an undecodable sketch) -> the same answer."""
    j, p = _both(sides, lambda s: s.request(server, "POST", "/generate", CASES[case]))
    assert p == j
    assert p["status"] == (400 if case.startswith(("bad", "no_", "inject_stream",
                                                   "inject_seed")) else 200)


def test_unknown_paths_and_healthz(sides):
    for method, path in (("GET", "/nope"), ("POST", "/nope"), ("GET", "/healthz")):
        j, p = _both(sides, lambda s: s.request("plain", method, path, {}))
        assert p == j
    assert p["body"] == {"status": "ok", "warm": True}


def test_scalar_seed_batch_must_divide_the_data_parallel_width(sides):
    """The pipelines' ``_dp`` (read as 1 when absent): a scalar-seed batch
    of 3 on a width of 2 is a 400; per-image seeds pass."""
    body = {"prompt": ["a", "b", "c"], "seed": 1, "response": "json", **BASE}
    for side in sides.values():
        side.stubs["plain"]._dp = 2
    try:
        j, p = _both(sides, lambda s: s.request("plain", "POST", "/generate", body))
        assert p == j and p["status"] == 400 and "data-parallel" in p["body"]["error"]
        j, p = _both(sides, lambda s: s.request("plain", "POST", "/generate",
                                                {**body, "seed": [1, 2, 3]}))
        assert p == j and p["status"] == 200
    finally:
        for side in sides.values():
            del side.stubs["plain"]._dp


def _fire_pair(server, bodies):
    """Two requests to the batching server, the second 0.15 s after the
    first, inside a window widened to 2 s: they merge, in this order (a
    batch of two is processed as soon as it is full)."""
    out = [None, None]
    batcher = server.handler_class.batcher
    window, batcher.window = batcher.window, 2.0

    def fire(i):
        out[i] = _request(server, "POST", "/generate", bodies[i])

    threads = [threading.Thread(target=fire, args=(i,)) for i in range(2)]
    threads[0].start()
    time.sleep(0.15)
    threads[1].start()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    batcher.window = window
    return out


@pytest.mark.parametrize("mode", ["sketch", "inject"])
def test_micro_batch_merges_like_jax(sides, mode):
    """Two concurrent single-prompt requests with different sketches (and,
    on the inject route, strengths) merge into one pipeline call with
    per-image seeds, sketches and strengths; the answers, the calls and the
    batch-size histogram match."""
    extra = {"mode": "inject", "strength": 0.4} if mode == "inject" else {}
    bodies = [{"prompt": "a cat", "seed": 11, "response": "json",
               "sketch_png_b64": _sketch_b64(5), **BASE, **extra},
              {"prompt": "a dog", "seed": 22, "sketch_png_b64": _sketch_b64(6), **BASE,
               **({**extra, "strength": 0.9} if extra else {})}]
    stub = "batched_inj" if mode == "inject" else "batched"
    before = {name: (len(s.stubs[stub].calls), s.handler("batched").batcher.calls)
              for name, s in sides.items()}
    j, p = _both(sides, lambda s: _fire_pair(s.servers["batched"], bodies))
    assert p == j and [r["status"] for r in p] == [200, 200]
    for name, side in sides.items():
        n_calls, batches = before[name]
        assert side.handler("batched").batcher.calls == batches + 1
        call = side.stubs[stub].calls[n_calls:]
        assert len(call) == 1 and call[0]["prompt"] == ["a cat", "a dog"]
        assert call[0]["seed"] == [11, 22]
    assert (sides["port"].stubs[stub].calls[-1] == sides["jax"].stubs[stub].calls[-1])
    j, p = _both(sides, lambda s: s.request("batched", "GET", "/metrics"))
    assert p["body"]["batch_sizes"] == j["body"]["batch_sizes"]
    assert "2" in p["body"]["batch_sizes"]


def _sse(body):
    return [block for block in body.decode().strip().split("\n\n")]


@pytest.mark.parametrize("preview", [False, True])
def test_sse_stream_matches_jax(sides, preview):
    """``stream: true``: the same progress events at ``progress_every``
    (with ``preview``, the same latent thumbnails: the port's server moves
    the NCHW tensors channels-last before the projection), then the same
    result event."""
    body = {"prompt": ["a cat", "a dog"], "seed": 4, "stream": True, "progress_every": 2,
            "preview": preview, "num_inference_steps": 5, "width": PX, "height": PX}
    j, p = _both(sides, lambda s: s.request("plain", "POST", "/generate", body))
    assert p["status"] == j["status"] == 200 and p["type"] == j["type"] == "text/event-stream"
    assert _sse(p["body"]) == _sse(j["body"])
    events = [dict(ln.split(": ", 1) for ln in b.split("\n")) for b in _sse(p["body"])]
    assert [e["event"] for e in events] == ["progress"] * 3 + ["result"]
    first = json.loads(events[0]["data"])
    assert first["step"] == 1 and first["total"] == 5
    if preview:
        thumbs = [Image.open(io.BytesIO(base64.b64decode(b))) for b in first["previews"]]
        assert [im.size for im in thumbs] == [(PX // 8, PX // 8)] * 2
        # the stub's latents run through the JAX package's own projection
        lat = np.random.RandomState(0).randn(2, PX // 8, PX // 8, 4).astype(np.float32)
        assert first["previews"] == jserve._latent_preview_b64(lat)
    else:
        assert "previews" not in first


def test_load_shedding_503(sides):
    def shed(side):
        h = side.handler("plain")
        old = h.state["max_pending"]
        h.state["max_pending"] = 0
        try:
            return side.request("plain", "POST", "/generate", CASES["png"])
        finally:
            h.state["max_pending"] = old

    j, p = _both(sides, shed)
    assert p == j and p["status"] == 503 and p["retry"] == "5"


def test_request_timeout_504(sides):
    """A request that waits past ``request_timeout_s`` behind held device
    work: 504, on the direct route and on the stream route."""
    def timed_out(side):
        h = side.handler("plain")
        h.state["request_timeout_s"] = 0.2
        h.lock.acquire()
        try:
            return [side.request("plain", "POST", "/generate", b) for b in
                    ({**CASES["png"], "num_images_per_prompt": 2},
                     {**CASES["png"], "stream": True})]
        finally:
            h.lock.release()
            h.state["request_timeout_s"] = None

    j, p = _both(sides, timed_out)
    assert p == j and [r["status"] for r in p] == [504, 504]


def test_batched_item_abandoned_on_timeout(sides):
    """A micro-batched request that times out while queued gets its 504 and
    is dropped: no pipeline call runs for it, and the batcher serves the
    next request."""
    def abandoned(side):
        h = side.handler("batched")
        calls = h.batcher.calls
        h.state["request_timeout_s"] = 0.2
        h.lock.acquire()
        try:
            first = side.request("batched", "POST", "/generate", {**CASES["png"], "seed": 31})
        finally:
            h.lock.release()
            h.state["request_timeout_s"] = None
        time.sleep(0.4)  # past the window sweep that drops the item
        dropped = h.batcher.calls == calls
        return first, dropped, side.request("batched", "POST", "/generate",
                                            {**CASES["png"], "seed": 32})

    j, p = _both(sides, abandoned)
    assert p == j and p[0]["status"] == 504 and p[1] is True and p[2]["status"] == 200


def test_device_fault_releases_the_lock(sides):
    """A pipeline call that raises: 500 on the batched and the direct
    routes, ``event: error`` on a stream, the worker lock free after each,
    and the next request served."""
    def faults(side):
        out = []
        for server, body in (("batched", CASES["png"]),
                             ("plain", {**CASES["png"], "num_images_per_prompt": 2}),
                             ("plain", {**CASES["png"], "stream": True})):
            side.stubs[server].fail_next = 1
            out.append(side.request(server, "POST", "/generate", body))
            lock = side.handler(server).lock
            out.append(lock.acquire(blocking=False))
            lock.release()
        out.append(side.request("plain", "POST", "/generate", CASES["png"]))
        return out

    j, p = _both(sides, faults)
    assert p == j
    assert [p[0]["status"], p[2]["status"], p[4]["status"], p[6]["status"]] == [500, 500, 200, 200]
    assert p[1] and p[3] and p[5]
    assert b"event: error" in p[4]["body"] and b"injected device fault" in p[4]["body"]
    assert "injected device fault" in p[0]["body"]["error"]


def test_metrics_and_recorded_calls_match_jax(sides):
    """After the requests above: the same ``/metrics`` counts (latencies
    are timings: only whether they exist is compared), and each stub got
    the same calls with the same keyword arguments, warmup's included."""
    for server in ("plain", "batched"):
        j, p = _both(sides, lambda s: s.request(server, "GET", "/metrics"))
        timing = ("latency_p50_s", "latency_p95_s")
        assert {k: v for k, v in p["body"].items() if k not in timing} == \
            {k: v for k, v in j["body"].items() if k not in timing}
        assert all((p["body"][k] is None) == (j["body"][k] is None) for k in timing)
        assert p["body"]["requests"] > 0 and p["body"]["pending"] == 0
    for name in sides["jax"].stubs:
        assert sides["port"].stubs[name].calls == sides["jax"].stubs[name].calls, name
        assert sides["port"].stubs[name].calls


def test_multi_gpu_flags_exit_with_a_message():
    """The flags are taken; a job whose world size is not their product, a
    host with fewer GPUs than processes, and the injection route under
    tensor parallelism exit with a message, as the JAX server does."""
    base = ["--model_path", "m", "--lgp_path", "l"]
    args = tserve.parse_args(base)
    assert args.data_parallel == args.model_parallel == 1
    tserve.check_parallel_args(args, 1, 1, 0)
    args = tserve.parse_args(base + ["--data_parallel", "2"])
    with pytest.raises(SystemExit, match="needs 2 processes, one per GPU"):
        tserve.check_parallel_args(args, 1, 1, 1)
    with pytest.raises(SystemExit, match="needs 2 devices on this host, found 1"):
        tserve.check_parallel_args(args, 2, 2, 1)
    tserve.check_parallel_args(args, 2, 2, 2)
    args = tserve.parse_args(base + ["--model_parallel", "2", "--inject_attn_weights", "a.pt"])
    with pytest.raises(SystemExit, match="data-parallel only"):
        tserve.check_parallel_args(args, 2, 2, 2)


# ---------------------------------------------------------------------------
# one real request through the port's server
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_pipe():
    from fakes import FakeTokenizer
    from sketch2img_torch.models.clip_text import CLIPTextConfig
    from sketch2img_torch.models.unet import UNetConfig
    from sketch2img_torch.models.vae import VAEConfig
    from sketch2img_torch.runtime import SDComponents, SketchGuidedPipeline

    c = SDComponents.random_init(
        seed=0, compute_dtype=torch.float32, random_weights=True, device="cpu",
        unet_config=UNetConfig(block_out_channels=(32, 32, 64), cross_attn=(True, True, False),
                               layers_per_block=1, num_heads=2, cross_attention_dim=32),
        vae_config=VAEConfig(block_out_channels=(32, 64), layers_per_block=1),
        text_config=CLIPTextConfig(vocab_size=100, hidden_size=32, intermediate_size=64,
                                   num_layers=2, num_heads=4))
    c.tokenizer = FakeTokenizer()
    return SketchGuidedPipeline(c)


def _u8(img01):
    return (np.clip(img01, 0, 1) * 255).astype(np.uint8)


def test_real_request_equals_the_direct_pipeline_call(tiny_pipe):
    """A tiny port stack on the CPU behind the port's server: a 2-step 64^2
    sketch-guided request (PNG) and its text-to-image twin (JSON) equal the
    direct ``SketchGuidedPipeline`` calls with the same seed, uint8 for
    uint8 (the noise is drawn on the CPU from the seed)."""
    pipe = tiny_pipe
    srv = tserve.make_server(pipe, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, args=(0.05,), daemon=True).start()
    try:
        sketch = np.random.RandomState(7).randint(0, 256, (PX, PX), np.uint8)
        png = _request(srv, "POST", "/generate",
                       {"prompt": "a house", "seed": 123, "sketch_png_b64": _sketch_b64(7),
                        **BASE})
        txt = _request(srv, "POST", "/generate",
                       {"prompt": "a house", "seed": 123, "response": "json", **BASE})
    finally:
        srv.shutdown()
        srv.server_close()
    assert png["status"] == txt["status"] == 200
    got = np.asarray(Image.open(io.BytesIO(png["body"])))
    want = pipe("a house", seed=123, sketch_image=sketch.astype(np.float32) / 255.0, **BASE)
    np.testing.assert_array_equal(got, _u8(want))
    got = np.asarray(Image.open(io.BytesIO(base64.b64decode(txt["body"]["images"][0]))))
    np.testing.assert_array_equal(got, _u8(pipe("a house", seed=123, **BASE)))
    assert txt["body"]["nsfw"] is None


def test_real_merged_requests_equal_their_solo_calls(tiny_pipe):
    """Two concurrent text-to-image requests through the port's batcher
    merge into one batch-2 call, and each image equals its request's solo
    call within one uint8 level: per-image seeds draw each image's noise
    from its own generator (checked exactly), and the batch-2 convolutions
    round apart from batch 1's. (A sketch-guided request is held to its
    same-call twin above: on random weights the guided update, which
    normalises the gradient, grows a rounding difference of another batch
    size over the steps.)"""
    pipe = tiny_pipe
    lat2, noise2 = pipe._initial_noise([41, 42], 2, 8, 8, 2)
    for i, seed in enumerate((41, 42)):
        lat1, noise1 = pipe._initial_noise([seed], 1, 8, 8, 1)
        assert torch.equal(lat2[i:i + 1], lat1) and torch.equal(noise2[i:i + 1], noise1)
    srv = tserve.make_server(pipe, "127.0.0.1", 0, batch_window_ms=2000, max_batch=2)
    threading.Thread(target=srv.serve_forever, args=(0.05,), daemon=True).start()
    try:
        bodies = [{"prompt": p, "seed": s, "response": "json", **BASE}
                  for p, s in (("a house", 41), ("a tree", 42))]
        out = _fire_pair(srv, bodies)
    finally:
        srv.shutdown()
        srv.server_close()
    assert [r["status"] for r in out] == [200, 200] and srv.handler_class.batcher.calls == 1
    for r, body in zip(out, bodies):
        got = np.asarray(Image.open(io.BytesIO(base64.b64decode(r["body"]["images"][0]))))
        want = _u8(pipe(body["prompt"], seed=body["seed"], **BASE))
        assert np.abs(got.astype(np.int16) - want).max() <= 1


# ---------------------------------------------------------------------------
# the kernels' libraries under concurrent first use
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("module", ["flash_attention", "groupnorm"])
def test_library_builds_once_under_concurrent_first_use(monkeypatch, module):
    """Two threads reach ``load_library`` before it has loaded (as the
    handler threads and the batcher thread can before ``warmup``): the
    build runs once, and both get the same library."""
    import ctypes
    import importlib

    from sketch2img_torch.utils import cuda_build

    mod = importlib.import_module(f"sketch2img_torch.ops.{module}")
    builds = []
    started = threading.Barrier(2)

    def slow_build(name, sources, headers=(), verbose=False):
        builds.append(name)
        time.sleep(0.3)  # an nvcc run: the other thread arrives meanwhile
        return f"lib{name}.so"

    class FakeCDLL:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, fn):
            entry = type("Entry", (), {})()
            object.__setattr__(self, fn, entry)
            return entry

    monkeypatch.setattr(mod, "_lib", None)
    monkeypatch.setattr(cuda_build, "build_library", slow_build)
    monkeypatch.setattr(ctypes, "CDLL", FakeCDLL)
    got = [None, None]

    def first_use(i):
        started.wait(5)
        got[i] = mod.load_library()

    threads = [threading.Thread(target=first_use, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    assert builds == [module] and got[0] is got[1] and got[0].path == f"lib{module}.so"
    assert all(getattr(got[0], fn).restype is ctypes.c_int for fn in mod.ARGTYPES)
