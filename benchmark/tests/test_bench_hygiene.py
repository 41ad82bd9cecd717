"""What the chip runs loads neither JAX nor the JAX package, and the
reference loads nothing of the port: checked in fresh interpreters, by
whole top-level module names."""

import json
import os
import subprocess
import sys

from benchmark.harness import core

MODULES = ["benchmark.harness.core", "benchmark.harness.trace", "benchmark.harness.models",
           "benchmark.harness.record", "benchmark.drivers.guided", "benchmark.drivers.inject",
           "benchmark.drivers.train_lgp", "benchmark.counts.flops", "benchmark.counts.flash",
           "benchmark.counts.groupnorm"] + [
    f"benchmark.metrics.{f[:-3]}" for f in os.listdir(os.path.join(core.HERE, "metrics"))
    if f.endswith(".py")]


def loaded_after(modules, extra=""):
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n" + extra +
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    env = dict(os.environ, PYTHONPATH=core.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=core.ROOT, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_port_load_no_jax():
    top = loaded_after(MODULES, "import sketch2img_torch.apps.train_lgp, "
                                "sketch2img_torch.apps.clip_guided_inf, "
                                "sketch2img_torch.runtime\n")
    assert not top & {"jax", "jaxlib", "flax", "sketch2img_tpu"}
    assert "sketch2img_torch" in top  # whole names: the port's starts with the JAX package's


def test_reference_loads_nothing_of_the_port():
    top = loaded_after(["benchmark.reference.models", "benchmark.reference.pipeline",
                        "benchmark.reference.build", "benchmark.reference.precision"])
    assert not top & {"sketch2img_torch", "sketch2img_tpu", "jax", "jaxlib", "flax"}


def test_forbidden_check_compares_whole_names():
    saved = dict(sys.modules)
    try:
        sys.modules.setdefault("sketch2img_tpu_like", sys)
        assert "sketch2img_tpu_like" not in core.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "sd15-lgp.guided-b1-512-50", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=core.ROOT,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
