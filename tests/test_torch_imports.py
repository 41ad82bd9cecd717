"""Import hygiene and device rules of the PyTorch port.

The port and ``chip_smoke.py`` import neither ``jax`` nor ``sketch2img_tpu``
(checked in a fresh subprocess: this test process has imported both), and
the entry points run on the CPU only when asked to.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import sketch2img_torch
names = [m.name for m in pkgutil.walk_packages(sketch2img_torch.__path__, "sketch2img_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "flax", "sketch2img_tpu")))
print(json.dumps({"names": names, "bad": bad}))
"""

# every module of the training slice, which the probe must have imported
TRAINING_MODULES = [
    "sketch2img_torch.apps.train_attn_inject", "sketch2img_torch.apps.train_lgp",
    "sketch2img_torch.core.config", "sketch2img_torch.core.export",
    "sketch2img_torch.data.arb", "sketch2img_torch.data.dataset", "sketch2img_torch.data.loader",
    "sketch2img_torch.data.tags", "sketch2img_torch.models.anime2sketch",
    "sketch2img_torch.train", "sketch2img_torch.train.checkpoint", "sketch2img_torch.train.loop",
    "sketch2img_torch.train.optim", "sketch2img_torch.train.sampling",
    "sketch2img_torch.train.signals", "sketch2img_torch.train.train_attn_inject",
    "sketch2img_torch.train.train_lgp",
]
# every module of the apps slice
APPS_MODULES = [
    "sketch2img_torch.apps.app", "sketch2img_torch.apps.clip_guided_inf",
    "sketch2img_torch.apps.convert_checkpoint", "sketch2img_torch.apps.evaluation",
    "sketch2img_torch.apps.pic2sketch", "sketch2img_torch.apps.serve",
]
# every module of the distribution and host-utilities slice
DIST_MODULES = [
    "sketch2img_torch.parallel", "sketch2img_torch.parallel.mesh", "sketch2img_torch.parallel.tp",
    "sketch2img_torch.core.memory", "sketch2img_torch.core.manifest",
    "sketch2img_torch.utils.params", "sketch2img_torch.utils.debug",
    "sketch2img_torch.utils.profiling", "sketch2img_torch.utils.hub",
]


@pytest.fixture(scope="module")
def subprocesses(tmp_path_factory):
    """The file's three subprocesses, started together (each spends most of
    its time importing torch): the import probe, and, where there is no
    GPU, ``chip_smoke.py`` run from the repository and alone in an empty
    directory. -> {name: CompletedProcess}."""
    alone = str(tmp_path_factory.mktemp("alone"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    jobs = {"probe": subprocess.Popen([sys.executable, "-c", _PROBE], cwd=REPO, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      env={**os.environ, "PYTHONPATH": REPO})}
    if not torch.cuda.is_available():  # on a GPU machine chip_smoke.py would run in full
        for name, cwd in (("smoke_repo", REPO), ("smoke_alone", alone)):
            jobs[name] = subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=cwd, text=True,
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    out = {}
    for name, proc in jobs.items():
        stdout, stderr = proc.communicate(timeout=300)
        out[name] = subprocess.CompletedProcess(proc.args, proc.returncode, stdout, stderr)
    return out


def test_port_imports_no_jax(subprocesses):
    out = subprocesses["probe"]
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(got["names"]) >= 15 and got["bad"] == [], out.stdout
    missing = sorted(set(TRAINING_MODULES + APPS_MODULES + DIST_MODULES) - set(got["names"]))
    assert not missing, missing


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the no-GPU refusal cannot be observed here")
    from sketch2img_torch.apps.app import build_pipeline
    from sketch2img_torch.apps.clip_guided_inf import ClipGuidedPipeline
    from sketch2img_torch.apps.train_attn_inject import train_attn_inject
    from sketch2img_torch.apps.train_lgp import train_lgp
    from sketch2img_torch.models.anime2sketch import load_netg
    from sketch2img_torch.runtime import SDComponents
    from sketch2img_torch.utils.device import resolve_device

    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        SDComponents.random_init()
    with pytest.raises(RuntimeError, match="cuda"):
        SDComponents.from_diffusers_dir("/nonexistent")
    with pytest.raises(RuntimeError, match="cuda"):
        SDComponents.from_native("/nonexistent")
    with pytest.raises(RuntimeError, match="cuda"):
        build_pipeline("/nonexistent", "/nonexistent.pt")
    with pytest.raises(RuntimeError, match="cuda"):
        ClipGuidedPipeline("/nonexistent")
    for trainer in (train_lgp, train_attn_inject):
        with pytest.raises(RuntimeError, match="cuda"):
            trainer({}, None, None)
    with pytest.raises(RuntimeError, match="cuda"):
        load_netg("/nonexistent")
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_fails_without_a_gpu_or_the_repo(subprocesses):
    """No GPU here: exit non-zero with no result line. Alone in a directory
    it fails as well (on a GPU machine because the package is missing)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    for name in ("smoke_repo", "smoke_alone"):
        out = subprocesses[name]
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
