"""The port's optimizers and LR schedules against the JAX package's
``train/optim.py``: both schedules over warm-up and the boundary, ``adamw``
against ``optax.adamw`` and ``adamw8bit`` against ``_quantized_adamw`` over
several steps on identical gradients with a schedule (each read at its own
step count), the int8 codes and scales against ``_blockwise_quantize``, the
registry, and a restored optimizer continuing its schedule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sketch2img_torch.train import optim as topt
from sketch2img_tpu.train import optim as jopt

from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

SHAPES = {"w": (64, 33), "v": (5000,), "b": (7,)}  # 5000: three 2048-blocks, the last padded


@pytest.mark.parametrize("name", ["constant_with_warmup", "cosine_with_restarts"])
def test_lr_schedules_match_jax(name):
    """Every step from before the warm-up to past the end, to 1e-5: the JAX
    schedules compute in fp32 (measured up to 2e-6 relative off the exact
    values the port's compute in Python floats)."""
    got = topt.make_lr_schedule(name, 2e-4, 10, 50)
    want = jopt.make_lr_schedule(name, 2e-4, 10, 50)
    steps = list(range(0, 60))
    np.testing.assert_allclose([got(s) for s in steps], [float(want(s)) for s in steps],
                               rtol=1e-5, atol=1e-12)
    assert got(0) == 0.0 and got(10) == pytest.approx(2e-4)


def _params(seed):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _grads(step):
    rng = np.random.RandomState(100 + step)
    # gradients over decades, so that the quadratic code's small-value
    # resolution matters, and one block of zeros
    out = {k: (rng.randn(*s) * 10.0 ** rng.uniform(-4, 0, s)).astype(np.float32)
           for k, s in SHAPES.items()}
    out["v"][2048:4096] = 0.0
    return out


def _run_both(jax_tx, make_port, steps=4, resync=False, jit=False):
    """Run optax's transformation and the port's optimizer on the same
    parameters and gradients; -> per-step lists of (port, jax, previous jax)
    param dicts and the final states. ``resync``: each step starts the port
    from the JAX side's parameters, so a step's difference does not carry
    into the next. ``jit``: the JAX update compiled (XLA may fuse its
    arithmetic, so only where the comparison has a tolerance for that)."""
    p0 = _params(0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jax_tx.init(jp)
    update = jax.jit(jax_tx.update) if jit else jax_tx.update
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = make_port(list(tp.values()))
    trace = []
    for s in range(steps):
        g = _grads(s)
        prev = {k: np.asarray(v) for k, v in jp.items()}
        if resync:
            with torch.no_grad():
                for k, p in tp.items():
                    p.copy_(torch.from_numpy(prev[k].copy()))
        upd, jstate = update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        trace.append(({k: p.detach().numpy().copy() for k, p in tp.items()},
                      {k: np.asarray(v) for k, v in jp.items()}, prev))
    return trace, opt, tp, jstate


def test_adamw_matches_optax_with_schedule():
    """Five steps of AdamW with a warm-up schedule (read before the update,
    so the first step's LR is 0) and weight decay on every parameter."""
    sched = jopt.make_lr_schedule("constant_with_warmup", 1e-2, 2, 10)
    trace, *_ = _run_both(optax.adamw(sched, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2),
                          lambda ps: topt.make_optimizer(
                              "adamw", ps, topt.make_lr_schedule("constant_with_warmup", 1e-2, 2,
                                                                 10), weight_decay=1e-2), steps=5,
                          jit=True)
    for s, (got, want, _) in enumerate(trace):
        for k in SHAPES:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=f"{s} {k}")
    np.testing.assert_array_equal(trace[0][0]["w"], _params(0)["w"])  # LR 0 at count 0


def test_adamw8bit_matches_jax_quantized_adamw():
    """Four steps of the int8-state AdamW with the cosine schedule (read
    after the increment), each from the same parameters: every update to
    1e-6 + 2e-5 of its size, and the int8 moment codes and scales equal to
    the JAX package's. Where a second moment's code is 0 the update divides
    by eps (updates of 7-38 here), so a one-ulp difference in the fp32 bias
    correction (XLA's pow(0.999, 3) and PyTorch's differ by one) shows as
    1e-5 of such an update."""
    sched_j = jopt.make_lr_schedule("cosine_with_restarts", 1e-2, 2, 10)
    sched_t = topt.make_lr_schedule("cosine_with_restarts", 1e-2, 2, 10)
    trace, opt, tp, jstate = _run_both(
        jopt.make_optimizer("adamw8bit", sched_j, weight_decay=1e-2),
        lambda ps: topt.make_optimizer("adamw8bit", ps, sched_t, weight_decay=1e-2),
        resync=True)
    for s, (got, want, prev) in enumerate(trace):
        for k in SHAPES:
            limit = 1e-6 + 2e-5 * np.abs(want[k] - prev[k])
            assert (np.abs(got[k] - want[k]) <= limit).all(), (s, k)
    for k in SHAPES:
        st = opt.state[tp[k]]
        for moment in ("mu", "nu"):
            q, scale = jstate[moment][k]["q"], jstate[moment][k]["scale"]
            assert st[f"{moment}_q"].dtype == torch.int8
            np.testing.assert_array_equal(st[f"{moment}_q"].numpy(), np.asarray(q),
                                          err_msg=f"{k} {moment}")
            np.testing.assert_array_equal(st[f"{moment}_scale"].numpy(), np.asarray(scale),
                                          err_msg=f"{k} {moment}")
    assert opt.param_groups[0]["count"] == int(jstate["count"]) == 4


def test_blockwise_codes_equal_jax():
    """The quadratic signed code and per-block absmax on the same fp32
    values: codes and scales equal, dequantised values equal."""
    rng = np.random.RandomState(4)
    x = (rng.randn(3 * 2048 + 5) * 10.0 ** rng.uniform(-6, 1, 3 * 2048 + 5)).astype(np.float32)
    x[2048:4096] = 0.0
    q, scale = topt.quantize_blockwise(torch.from_numpy(x))
    jq, jscale = jopt._blockwise_quantize(jnp.asarray(x), 2048)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    got = topt.dequantize_blockwise(q, scale, x.shape).numpy()
    want = np.asarray(jopt._blockwise_dequantize(jq, jscale, x.shape))
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)


def test_registry_and_restored_schedule():
    """Names as the JAX registry takes them; a restored optimizer resumes
    its schedule count (and so its LR) where the saved one stopped."""
    ps = [torch.nn.Parameter(torch.ones(3))]
    assert type(topt.make_optimizer("bitsandbytes.optim.AdamW8bit", ps, 1e-3)) is topt.AdamW
    assert type(topt.make_optimizer("ADAMW8BIT", ps, 1e-3)) is topt.AdamW8bit
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.make_optimizer("sgd", ps, 1e-3)
    sched = topt.make_lr_schedule("constant_with_warmup", 1e-3, 4, 10)
    for name in ("adamw", "adamw8bit"):
        a = topt.make_optimizer(name, [torch.nn.Parameter(torch.ones(3))], sched)
        for _ in range(3):
            a.param_groups[0]["params"][0].grad = torch.ones(3)
            a.step()
        b = topt.make_optimizer(name, [torch.nn.Parameter(torch.ones(3))], sched)
        b.load_state_dict(a.state_dict())
        for opt in (a, b):
            opt.param_groups[0]["params"][0].grad = torch.ones(3)
            opt.step()
        assert a.param_groups[0]["count"] == b.param_groups[0]["count"] == 4
        assert a.param_groups[0]["lr"] == b.param_groups[0]["lr"] == sched(3 if name == "adamw"
                                                                             else 4)
