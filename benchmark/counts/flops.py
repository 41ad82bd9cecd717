"""The work a cell does, counted on the benchmark's float32 reference on
meta tensors, once per shape: FLOPs with
``torch.utils.flop_counter.FlopCounterMode``, and the calls that the
port's kernel sites take (flash attention, GroupNorm) with their logical
shapes.

Why it is here: ``mfu.<cell>`` is the whole request's or step's share of
the chip's peak, and ``<kernel>_roofline.<cell>`` a kernel's share of its
least time. Both take their work from the configuration's shapes as the
plain reference computes them, times the passes the path makes (the
guided backward and the LGP's full concatenated product included), never
from a count or an argument the program reports. Each FLOP is charged at
the peak of the dtype the configuration states for its module
(``counts.peaks.FLOPS``). The calls the program makes are recorded only
to cross-check these (``counts.flash.check_calls``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.counts import flash
from benchmark.reference import build
from benchmark.reference import models as ref_models

ELEM_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def count(fn: Callable[[], object]) -> int:
    with FlopCounterMode(display=False) as mode:
        fn()
    return int(mode.get_total_flops())


@dataclasses.dataclass
class Work:
    """What a pass, a request or a step does: FLOPs by the dtype they are
    charged at, the flash calls ``(kind, B, H, nq, kv, d)`` and the
    GroupNorm calls ``(B, C, H*W, element bytes)`` of the port's kernel
    sites. Works add, and multiply by a count of passes."""

    flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    flash: List[Tuple] = dataclasses.field(default_factory=list)
    groupnorm: List[Tuple] = dataclasses.field(default_factory=list)

    @property
    def total(self) -> float:
        return sum(self.flops.values())

    def __add__(self, other: "Work") -> "Work":
        f = dict(self.flops)
        for k, v in other.flops.items():
            f[k] = f.get(k, 0.0) + v
        return Work(f, self.flash + other.flash, self.groupnorm + other.groupnorm)

    def __mul__(self, n: int) -> "Work":
        return Work({k: v * n for k, v in self.flops.items()}, self.flash * n,
                    self.groupnorm * n)

    __rmul__ = __mul__


class _AttnSeen(torch.autograd.Function):
    """Identity on an attention's output whose backward notes the call:
    autograd reaches it exactly where it would reach the port's flash
    backward."""

    @staticmethod
    def forward(ctx, out, shape, sink):
        ctx.shape, ctx.sink = shape, sink
        return out.clone()  # free on meta tensors; a returned view would alias the input

    @staticmethod
    def backward(ctx, g):
        ctx.sink.append(("bwd",) + ctx.shape)
        return g, None, None


@contextlib.contextmanager
def _sites(flash_calls: List[Tuple], gn_calls: List[Tuple], module: torch.nn.Module,
           elem_bytes: int):
    """Record the reference's attention calls that are flash sites
    (``counts.flash.is_site``) and every GroupNorm call of ``module``."""
    plain = ref_models.attention

    def attention(q, k, v, heads, mask=None):
        out = plain(q, k, v, heads, mask)
        b, nq, c = q.shape
        d, nk = c // heads, k.shape[1]
        if flash.is_site(nq, nk, d, mask is not None):
            shape = (b, heads, nq, nk, d)
            flash_calls.append(("fwd",) + shape)
            if torch.is_grad_enabled() and out.requires_grad:
                out = _AttnSeen.apply(out, shape, flash_calls)
        return out

    def seen_gn(mod, args, out):
        x = args[0]
        gn_calls.append((x.shape[0], x.shape[1], x[0, 0].numel(), elem_bytes))

    hooks = [m.register_forward_hook(seen_gn) for m in module.modules()
             if isinstance(m, torch.nn.GroupNorm)]
    ref_models.attention = attention
    try:
        yield
    finally:
        ref_models.attention = plain
        for h in hooks:
            h.remove()


def _meta(*shape, grad=False, dtype=torch.float32):
    return torch.empty(*shape, device="meta", dtype=dtype, requires_grad=grad)


class Counter:
    """The work of the reference's parts at given shapes, cached by shape."""

    def __init__(self, cfg: Dict):
        self.cfg = cfg
        self._cache: Dict = {}
        self._mods: Dict = {}

    def _mod(self, name: str):
        if name not in self._mods:
            with torch.device("meta"):
                self._mods[name] = build.build(self.cfg, name).eval().requires_grad_(False)
        return self._mods[name]

    def _cached(self, key, name: str, fn) -> Work:
        """``fn``'s work, charged at the dtype of module ``name``."""
        if key not in self._cache:
            dtype = self.cfg["dtypes"][{"unet_inject": "unet"}.get(name, name)]
            fl, gn = [], []
            with _sites(fl, gn, self._mod(name), ELEM_BYTES[dtype]):
                f = count(fn)
            self._cache[key] = Work({dtype: float(f)}, fl, gn)
        return self._cache[key]

    def unet(self, b: int, hw: int, ctx_len: int, inject: bool = False) -> Work:
        u = self.cfg["unet"]
        name = "unet_inject" if inject else "unet"

        def fn():
            kw = {}
            if inject:
                v = self.cfg["vision"]
                n_tok = (v["image_size"] // v["patch_size"]) ** 2 + 1
                kw = {"injection": _meta(b, n_tok, v["hidden_size"]), "scale": _meta(b, 1, 1)}
            self._mod(name)(_meta(b, 4, hw, hw), torch.zeros(b, dtype=torch.long, device="meta"),
                            _meta(b, ctx_len, u["cross_attention_dim"]), **kw)
        return self._cached(("unet", b, hw, ctx_len, inject), name, fn)

    def unet_taps(self, b: int, hw: int, ctx_len: int) -> Work:
        """The forward with taps, as the trainer runs it (no gradient)."""
        u = self.cfg["unet"]

        def fn():
            self._mod("unet")(_meta(b, 4, hw, hw), torch.zeros(b, dtype=torch.long, device="meta"),
                              _meta(b, ctx_len, u["cross_attention_dim"]), taps=True)
        return self._cached(("unet_taps", b, hw, ctx_len), "unet", fn)

    def unet_taps_grad(self, b: int, hw: int, ctx_len: int) -> Work:
        """Forward with taps and the backward to the input through every tap."""
        u = self.cfg["unet"]

        def fn():
            x = _meta(b, 4, hw, hw, grad=True)
            _, taps = self._mod("unet")(x, torch.zeros(b, dtype=torch.long, device="meta"),
                                        _meta(b, ctx_len, u["cross_attention_dim"]), taps=True)
            sum(t.sum() for t in taps.values()).backward()
        return self._cached(("unet_taps_grad", b, hw, ctx_len), "unet", fn)

    def lgp(self, b: int, hw: int, grad: str) -> Work:
        """The LGP head at the latent size: ``grad`` "input" (the guided
        step) or "weights" (training)."""
        lgp = self._mod("lgp")
        c_in = lgp.layers[0].in_features - 40

        def fn():
            feats = _meta(b, c_in, hw, hw, grad=grad == "input")
            if grad == "weights":
                lgp.requires_grad_(True).train()
            out = lgp(feats, _meta(b, 4, hw, hw))
            out.sum().backward()
            lgp.requires_grad_(False).eval()
            for p in lgp.parameters():
                p.grad = None
        return self._cached(("lgp", b, hw, grad), "lgp", fn)

    def text(self, b: int, n: int) -> Work:
        return self._cached(("text", b, n), "text_encoder", lambda: self._mod("text_encoder")(
            torch.zeros(b, n, dtype=torch.long, device="meta")))

    def vae_encode(self, b: int, px: int) -> Work:
        return self._cached(("vae_enc", b, px), "vae",
                            lambda: self._mod("vae").encode(_meta(b, 3, px, px)))

    def vae_decode(self, b: int, hw: int) -> Work:
        return self._cached(("vae_dec", b, hw), "vae",
                            lambda: self._mod("vae").decode(_meta(b, 4, hw, hw)))

    def vision(self, which: str, b: int) -> Work:
        """``which`` "safety_checker" or "vision" (the sketch encoder)."""
        mod = self._mod(which)
        tower = mod.vision_model if which == "safety_checker" else mod
        cfg = self.cfg[which]

        def fn():
            h = tower(_meta(b, 3, cfg["image_size"], cfg["image_size"]))
            if which == "safety_checker":
                mod.visual_projection(h[:, 0])
        return self._cached(("vision", which, b), which, fn)

    def anime2sketch(self, b: int, px: int) -> Work:
        return self._cached(("a2s", b, px), "anime2sketch",
                            lambda: self._mod("anime2sketch")(_meta(b, 3, px, px)))
