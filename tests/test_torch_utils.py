"""Host utilities of the PyTorch port (``utils/params``, ``utils/debug``,
``utils/profiling``, ``utils/hub``) on the CPU, against the JAX package's
where they compute the same thing. No test touches the network: the hub
library's import is blocked, as on a machine without it."""

import builtins
import os
import sys

import numpy as np
import pytest
import torch

from sketch2img_torch.utils import debug, hub, params, profiling
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)


def test_cast_float_params():
    sd = {"w": torch.ones(2, 3), "n": torch.tensor(3), "h": torch.ones(2, dtype=torch.float16)}
    out = params.cast_float_params(sd)
    assert out["w"].dtype == torch.bfloat16 and out["h"].dtype == torch.bfloat16
    assert out["n"].dtype == torch.int64 and torch.equal(out["n"], sd["n"])
    assert params.cast_float_params(sd, torch.float32)["h"].dtype == torch.float32


def test_assert_tree_finite_names_the_leaf_as_jax_does():
    """The same nested tree in both packages: no error when finite, and the
    same message for a NaN (the JAX one's path text)."""
    import jax.numpy as jnp

    from sketch2img_tpu.utils import debug as jdebug

    tree = {"a": {"b": torch.ones(3), "c": torch.tensor([1, 2])}, "d": [torch.zeros(2)]}
    debug.assert_tree_finite(tree, "state")
    tree["a"]["b"][1] = float("nan")
    jtree = {"a": {"b": jnp.asarray(tree["a"]["b"].numpy()), "c": jnp.asarray([1, 2])},
             "d": [jnp.zeros(2)]}
    with pytest.raises(FloatingPointError) as port:
        debug.assert_tree_finite(tree, "state")
    with pytest.raises(FloatingPointError) as ref:
        jdebug.assert_tree_finite(jtree, "state")
    assert str(port.value) == str(ref.value) == "non-finite values in state:a/b"
    lin = torch.nn.Linear(2, 2)
    with torch.no_grad():
        lin.bias[0] = float("inf")
    with pytest.raises(FloatingPointError, match="model:bias"):
        debug.assert_tree_finite(lin, "model")


def test_nan_checks_turn_on_anomaly_detection():
    was = torch.is_anomaly_enabled()
    try:
        debug.enable_nan_checks()
        assert torch.is_anomaly_enabled()
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            (torch.sqrt(x) * 0.0).sum().backward()
    finally:
        torch.autograd.set_detect_anomaly(was)


def test_trace_and_device_timeit(tmp_path):
    with profiling.trace(str(tmp_path / "prof")) as prof:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    assert any("mm" in e.key for e in prof.key_averages())
    secs = profiling.device_timeit(torch.mm, torch.ones(8, 8), torch.ones(8, 8), iters=3)
    assert 0.0 < secs < 1.0


@pytest.fixture
def no_hub(monkeypatch):
    """``huggingface_hub`` cannot be imported."""
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    real = builtins.__import__

    def guarded(name, *args, **kw):
        if name.startswith("huggingface_hub"):
            raise ImportError("No module named 'huggingface_hub'")
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", guarded)


def test_hub_fails_softly_without_the_hub_library(no_hub, tmp_path, capsys):
    assert hub.download_netg(str(tmp_path / "w")) is None
    assert "netG.pth download unavailable" in capsys.readouterr().out
    (tmp_path / "w" / "netG.pth").write_bytes(b"x")
    assert hub.download_netg(str(tmp_path / "w")) == str(tmp_path / "w" / "netG.pth")
    (tmp_path / "e.npz").write_bytes(np.zeros(1).tobytes())
    assert hub.push_file("someone/something", str(tmp_path / "e.npz")) is False
    assert "publish to someone/something failed" in capsys.readouterr().out
