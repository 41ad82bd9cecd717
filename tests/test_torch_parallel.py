"""Distribution of the PyTorch port (``sketch2img_torch/parallel``) on the
CPU: two gloo processes against one.

Each scenario spawns its two ranks once (``tests/torch_dist_workers.py``,
which imports nothing of JAX) and holds what they computed to the same
computation in this process without a mesh, on the same tiny weights
(fp32):

  * the trainers: one LGP step and one injection step at a global batch of
    4 split over two ranks (each rank the loader's rows r::2, the global
    batch's draws, BatchNorm statistics over the global batch, gradients
    averaged) against the one-rank step — loss, updated trainables and the
    BatchNorm running statistics within 1e-5 of their largest value; and
    ``train_lgp`` for an epoch at world 2 (rank 0 alone writes);
  * the pipelines at data parallel 2: text-to-image and injection within
    1e-5, two guided steps within 1e-4 (the guided update normalises the
    gradient, which grows another batch size's rounding: 2e-5 after one
    step on this model), batch 3 with per-image seeds padded to 4 with the
    pad row out of the callback, and the scalar-seed refusal;
  * tensor parallelism at 2: the guided pass's eps and its gradient w.r.t.
    the latent within 1e-5 of one rank's.

Then, in this process: the set of parameters the port shards is the set
the JAX package's ``tp_param_specs`` shards; the loader's per-process
indices are the JAX loader's; a shard's guided update is the whole batch's;
and the server's rank-0 broadcast of pipeline calls.
"""

import os
import threading

import numpy as np
import pytest
import torch

import torch_dist_workers as w
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5
GUIDED_TOL = 1e-4


def _rel(got, want):
    got, want = torch.as_tensor(np.asarray(got)).float(), torch.as_tensor(np.asarray(want)).float()
    return float((got - want).abs().max() / max(float(want.abs().max()), 1e-12))


# ---------------------------------------------------------------------------
# the trainers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_train")
    folder = w.write_images(str(tmp / "images"))
    ranks = w.spawn("train", tmp)
    c, g = w.components(), w.gan()
    ref = w.train_steps(c, g, w.train_batch())
    ref["app"] = w.train_app(c, g, folder, str(tmp / "one_rank"))
    return ranks, ref


@pytest.mark.parametrize("what", ["lgp_loss", "lgp_weights", "lgp_batch_stats", "inject_loss",
                                  "inject_trainables"])
def test_two_rank_train_steps_equal_one_rank(train_runs, what):
    ranks, ref = train_runs
    for r in ranks:
        if what.endswith("loss"):
            assert r[what] == pytest.approx(ref[what], rel=TOL)
            continue
        part = what.split("_")[0]
        keys = [k for k in ref[part] if not k.endswith("num_batches_tracked")]
        stats = [k for k in keys if k.endswith(("running_mean", "running_var"))]
        keys = stats if what == "lgp_batch_stats" else [k for k in keys if k not in stats]
        assert keys
        for k in keys:
            assert _rel(r[part][k], ref[part][k]) <= TOL, k


def test_two_rank_lgp_app_run(train_runs):
    """An epoch of ``train_lgp`` at world 2: the global batch's losses on
    both ranks; checkpoint and export written by rank 0 alone."""
    ranks, ref = train_runs
    app = ref["app"]
    for r in ranks:
        np.testing.assert_allclose(r["app"]["losses"], app.losses, rtol=TOL)
    assert ranks[0]["app"]["checkpoint"] and os.path.exists(ranks[0]["app"]["checkpoint"])
    assert [os.path.basename(p) for p in ranks[0]["app"]["exports"]] == ["edge_predictor.npz"]
    assert ranks[1]["app"]["checkpoint"] is None and ranks[1]["app"]["exports"] == []


# ---------------------------------------------------------------------------
# the pipelines, data parallel
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pipeline_runs(tmp_path_factory):
    from sketch2img_torch.apps.clip_guided_inf import ClipGuidedPipeline
    from sketch2img_torch.runtime import SketchGuidedPipeline

    ranks = w.spawn("pipeline", tmp_path_factory.mktemp("dist_pipeline"))
    c = w.components()
    ref = w.pipeline_calls(SketchGuidedPipeline(c),
                           ClipGuidedPipeline(components=c, clip_config=w.vision_config()))
    return ranks, ref


@pytest.mark.parametrize("call,tol", [("text2img", TOL), ("inject", TOL), ("guided", GUIDED_TOL),
                                      ("padded", TOL)])
def test_data_parallel_pipeline_equals_one_device(pipeline_runs, call, tol):
    ranks, ref = pipeline_runs
    for r in ranks:
        assert r[call].shape == ref[call].shape
        np.testing.assert_allclose(r[call], ref[call], rtol=0, atol=tol)


def test_padded_callback_and_scalar_seed_refusal(pipeline_runs):
    """Batch 3 at two ranks: the callback sees the three real rows only,
    the whole batch on every rank; a scalar seed there is refused."""
    ranks, ref = pipeline_runs
    for r in ranks:
        assert r["dp"] == 2
        assert [tuple(x.shape) for x in r["callback"]] == [tuple(x.shape) for x in ref["callback"]]
        assert all(x.shape[0] == 3 for x in r["callback"])
        for got, want in zip(r["callback"], ref["callback"]):
            assert _rel(got, want) <= TOL
        assert "doesn't divide the mesh data axis (2)" in r["scalar_seed_error"]


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    from sketch2img_torch.runtime import SketchGuidedPipeline

    ranks = w.spawn("tp", tmp_path_factory.mktemp("dist_tp"))
    c = w.components()
    eps, grad = w.guided_pass(c)
    img = SketchGuidedPipeline(c)("a", num_inference_steps=2, seed=3, width=w.PX, height=w.PX,
                                  sketch_image=w.sketch())
    q = c.unet.down_blocks[0].attentions[0].transformer_blocks[0].attn1.to_q.weight
    return ranks, {"eps": eps, "grad": grad, "image": img, "to_q": q}


@pytest.mark.parametrize("what", ["eps", "grad"])
def test_tensor_parallel_guided_pass_equals_one_rank(tp_runs, what):
    ranks, ref = tp_runs
    for r in ranks:
        assert _rel(r[what], ref[what]) <= TOL


def test_tensor_parallel_slices_whole_heads(tp_runs):
    """Each rank keeps one of the two heads (its rows of to_q) and runs the
    request to an image near the one-rank image (two guided steps)."""
    ranks, ref = tp_runs
    n = ref["to_q"].shape[0] // 2
    for rank, r in enumerate(ranks):
        assert r["local_heads"] == [1]
        assert torch.equal(r["to_q"], ref["to_q"][rank * n:(rank + 1) * n])
        assert np.isfinite(r["image"]).all()
        np.testing.assert_allclose(r["image"], ref["image"], rtol=0, atol=2e-2)


def test_sharded_parameters_are_jax_tp_param_specs():
    """The port's ``tp_param_specs`` on the tiny UNet, written through the
    port's npz converter (``unet_to_jax``) into the JAX tree, marks exactly
    the leaves the JAX package's ``tp_param_specs`` shards, each on the same
    axis (PyTorch's (out, in) weight is JAX's (in, out) kernel)."""
    from jax.sharding import PartitionSpec as P

    from sketch2img_torch.core.convert import unet_to_jax
    from sketch2img_torch.parallel.tp import tp_param_specs
    from sketch2img_tpu.parallel.tp import tp_param_specs as jax_specs

    unet = w.components().unet
    specs = tp_param_specs(unet)
    marks = {(): 0.0, ("model", None): 1.0, (None, "model"): 2.0}
    sd = {k: torch.full_like(v, marks[specs[k]]) for k, v in unet.state_dict().items()}
    tree = unet_to_jax(sd, unet.config)
    want = {P(): 0.0, P(None, "model"): 1.0, P("model", None): 2.0}

    def walk(t, s, path=()):
        if isinstance(t, dict):
            assert t.keys() == s.keys(), path
            return sum(walk(t[k], s[k], path + (k,)) for k in t)
        vals = np.unique(np.asarray(t))
        assert vals.tolist() == [want[s]], (path, vals, s)
        return int(s != P())

    n_sharded = walk(tree, jax_specs(tree))
    assert n_sharded == 4 * sum(hasattr(m, "tp_size") for m in unet.modules())


def test_loader_shards_like_the_jax_loader():
    """Per-process indices equal the JAX loader's for process_count 2, and
    the two processes' batch b together hold the one-process batch b."""
    from sketch2img_torch.data.loader import Loader
    from sketch2img_tpu.data.loader import Loader as JLoader

    data = list(range(23))
    for epoch in (0, 3):
        ranks = []
        for pi in (0, 1):
            port = Loader(data, 2, seed=5, process_index=pi, process_count=2)
            jax_ = JLoader(data, 2, seed=5, process_index=pi, process_count=2)
            port.set_epoch(epoch)
            jax_.set_epoch(epoch)
            assert port._indices().tolist() == jax_._indices().tolist()
            assert len(port) == len(jax_) == 5
            ranks.append(port._indices())
        one = Loader(data, 4, seed=5)
        one.set_epoch(epoch)
        whole = one._indices()
        for b in range(5):
            assert sorted(np.concatenate([r[2 * b:2 * b + 2] for r in ranks])) == \
                sorted(whole[4 * b:4 * b + 4])


def test_guided_update_of_a_shard_is_the_whole_batch_update():
    """No collective inside the guided step: image i's update depends on its
    own loss term alone (the per-image alpha undoes the mean's 1/B), so the
    step on each half of a batch gives the whole batch's rows."""
    from sketch2img_torch.core.schedulers import make_sampler_step
    from sketch2img_torch.pipelines.sketch_guided import guided_step

    c = w.components()
    gen = torch.Generator().manual_seed(1)
    x, noise0, target = (torch.randn(2, 4, 8, 8, generator=gen) for _ in range(3))
    ctx = torch.randn(4, 77, 32, generator=gen)
    _, step = make_sampler_step("dpm++", c.schedule, 10)

    def run(rows):
        return guided_step(c.unet, c.lgp, c.schedule, step, 0, 901, x[rows], torch.zeros_like(
            x[rows]), noise0[rows], ctx[:2][rows], ctx[2:][rows], target[rows], 7.5)[0]

    whole = run(slice(0, 2))
    halves = torch.cat([run(slice(0, 1)), run(slice(1, 2))])
    assert _rel(halves, whole) <= TOL


def test_server_broadcasts_each_call_to_the_followers(monkeypatch):
    """Rank 0's ``Leader`` sends each call (its callback replaced by a flag)
    before running it; a follower runs it with a no-op callback, goes on
    after a failing call, and stops at None."""
    import queue

    from sketch2img_torch.apps import serve
    from sketch2img_torch.parallel import mesh

    wire = queue.Queue()

    def broadcast(obj=None, group=None):
        if obj is not None or threading.current_thread().name == "leader":
            wire.put(obj)
            return obj
        return wire.get(timeout=30)

    monkeypatch.setattr(mesh, "broadcast_object", broadcast)

    class Pipe:
        _dp = 2

        def __init__(self):
            self.calls = []

        def __call__(self, *args, **kw):
            self.calls.append((args, kw))
            if kw.get("fail"):
                raise ValueError("bad seeds")
            if kw.get("callback"):
                kw["callback"](0, 1, None)
            return "image"

    lead, follower = Pipe(), Pipe()
    leader = serve.Leader(lead, "sketch", None)
    done = []
    t = threading.Thread(target=lambda: done.append(
        serve.follow({"sketch": follower}, None, log=lambda m: None)))
    t.start()
    seen = []

    def leader_calls():
        assert leader("a", seed=[1, 2], callback=lambda *a: seen.append(a)) == "image"
        with pytest.raises(ValueError):
            leader("b", fail=True)
        mesh.broadcast_object(None, None)

    lt = threading.Thread(target=leader_calls, name="leader")
    lt.start()
    lt.join(30)
    t.join(30)
    assert done == [2] and leader._dp == 2 and seen == [(0, 1, None)]
    assert [c[0] for c in follower.calls] == [("a",), ("b",)]
    assert follower.calls[0][1]["seed"] == [1, 2] and callable(follower.calls[0][1]["callback"])


def test_mesh_without_a_process_group_is_one_rank():
    from sketch2img_torch.parallel import (
        batch_sharding,
        fetch_global,
        initialize_distributed,
        make_mesh,
        shard_batch,
        sync_global_devices,
    )

    assert not initialize_distributed("cpu")  # no torchrun environment: a no-op
    m = make_mesh()
    assert m.shape == {"data": 1, "model": 1} and m.data_group is None
    x = torch.arange(6.0).view(3, 2)
    assert batch_sharding(m, 3) == slice(0, 3)
    assert shard_batch(m, {"x": x})["x"] is not None and torch.equal(fetch_global(m, x), x)
    sync_global_devices()
    with pytest.raises(ValueError):
        make_mesh(model_parallel=2)
