"""The port's data parallel (parallel/, the trainer under DDP, BatchNorm on
global moments, the per-rank loader shards) against the one-process run
and the JAX package.

* The loader: each rank's index batches, concatenated in rank order, are
  the JAX `DataLoader(shard_id=host, num_shards=hosts)` batches, for 2
  hosts x 2 ranks and for one host; a remainder raises; rank r's workers
  reseed with (SEED, epoch, r N + w + 1): rank 0 replays a one-rank run's
  worker streams, rank 1 draws others, and two passes are bit-equal.
* The train step: the tiny flagship (`flagship_cfg(tiny=True)`) in f64 on
  one torch thread (C7), one batch of 4 synthetic items, as 2 gloo ranks
  x 2 items under DDP (processes spawned here), 1 rank x 4 and the JAX
  1-device step (tests/test_torch_train_step.py:train_step_pair), all from
  the same weights and on the JAX sample locations.  The loss (the ranks'
  mean), every gradient after the all-reduce and every BN running
  statistic: 2 ranks against 1 to 1e-9 (f64 summation order; the loss to
  1e-6, since the heatmap loss sums in f32), against JAX with
  test_torch_train_step.py's tolerances.  After 3 steps the two
  ranks' parameters are bit-equal.
* C13: the tiny flagship's config leaves BACKBONE.SYNC_BN off, and its BN
  statistics are still the global batch's; every BatchNorm of the
  flagship and of the hourglass recipe is one that syncs.
* The guards: a BatchNorm with `sync` off, and a torch BatchNorm under
  DDP, raise under 2 ranks.
* A group of one rank (torchrun --nproc_per_node 1) trains under DDP, and
  BatchNorm takes its moments through the all-reduces, to what it gives
  without a group (1e-12, f64).
* Each loss divided by a count (keypoints_mse_smooth_loss, masked_mse_loss
  with a mask, reprojection_loss) gives, over 2 ranks, the global ratio's
  value and gradient, which the mean of the local ratios does not.
* The command line under torchrun: 2 ranks on the CPU train and test the
  tiny synthetic recipe, and rank 0 alone prints RESULTS.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from epipolar_transformers_tpu.data.pipeline import DataLoader as JDataLoader
from epipolar_transformers_tpu_torch.data import pipeline
from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
from epipolar_transformers_tpu_torch.engine.tester import TRAIN_KEYS, to_model_inputs
from epipolar_transformers_tpu_torch.losses.heatmap_loss import (keypoints_mse_smooth_loss,
                                                                 masked_mse_loss)
from epipolar_transformers_tpu_torch.ops.epipolar_reproject import reprojection_loss
import test_torch_train_step
from torch_configs import config_pair, jax_sample_locs, one_torch_thread  # noqa: F401
from torch_ddp_ranks import Draws, free_port, run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 4
RANKS = 2
STEPS = 3


class _Indices:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.asarray(i)}


@pytest.mark.parametrize("hosts,ranks,n,batch", [(2, 2, 37, 4), (1, 2, 50, 8), (1, 4, 40, 8)])
def test_rank_batches_are_the_jax_host_batches(hosts, ranks, n, batch):
    for epoch in range(2):
        for h in range(hosts):
            ref = JDataLoader(_Indices(n), batch_size=batch, shuffle=True, seed=3, drop_last=True,
                              prefetch=0, shard_id=h, num_shards=hosts)
            ref.epoch = epoch
            want = [b.tolist() for b in ref._batch_indices()]
            parts = []
            for r in range(ranks):
                loader = pipeline.TrainLoader(_Indices(n), batch, seed=3, shard_id=h,
                                              num_shards=hosts, local_rank=r, local_world=ranks)
                loader.epoch = epoch
                assert len(loader) == len(ref)
                parts.append(loader.index_batches())
            assert [sum((p[b].tolist() for p in parts), []) for b in range(len(want))] == want
            assert all(len(p[b]) == batch // ranks for p in parts for b in range(len(want)))
        if hosts == 1:
            single = pipeline.TrainLoader(_Indices(n), batch, seed=3)
            single.epoch = epoch
            assert [b.tolist() for b in single.index_batches()] == want


def test_a_batch_that_does_not_split_over_the_ranks_raises():
    with pytest.raises(ValueError, match="LOCAL_WORLD_SIZE"):
        pipeline.TrainLoader(_Indices(16), 6, seed=0, local_world=4)


def test_each_ranks_workers_draw_a_stream_of_their_own():
    def draws(loader):
        """The draws in item order, by worker (item k of an epoch goes to
        worker k % N)."""
        got = [b["draw"].tolist() for b in loader]
        flat = sum(got, [])
        return got, [flat[w::2] for w in range(2)]

    runs = {}
    for rank in (0, 1):
        runs[rank] = [draws(pipeline.TrainLoader(Draws(8), 4, seed=0, num_workers=2,
                                                 local_rank=rank, local_world=2))
                      for _ in range(2)]
        assert runs[rank][0] == runs[rank][1]  # each rank is deterministic
    single = draws(pipeline.TrainLoader(Draws(8), 2, seed=0, num_workers=2))
    # rank 0's workers draw what a one-rank run's workers draw first, rank 1's not
    assert runs[0][0][1] == [d[:2] for d in single[1]]
    assert not set(sum(runs[1][0][1], [])) & set(sum(runs[0][0][1], []))
    pipeline.stop_workers()


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """The 1-rank and JAX steps here, then the 2-rank run in spawned
    processes from the same weights, batch and sample locations."""
    cfg, jcfg = config_pair({"SOLVER": {"OPTIMIZER": "sgd", "BASE_LR": test_torch_train_step.LR,
                                        "IMS_PER_BATCH": BATCH}}, tiny_flagship=True)
    jcfg = jcfg.replace(EPIPOLAR=jcfg.EPIPOLAR.replace(ATTENTION_IMPL="reference"))
    np.random.seed(0)
    ds = SyntheticMultiview(cfg, is_train=True, n_samples=BATCH, seed=0)
    batch = pipeline.collate([ds[i] for i in range(BATCH)])
    locs = []

    def recording(*args, **kwargs):
        locs.append(jax_sample_locs(*args, **kwargs))
        return locs[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(test_torch_train_step, "jax_sample_locs", recording)
        one = test_torch_train_step.train_step_pair(cfg, jcfg, batch, batch)
    (locs,) = locs
    inputs = to_model_inputs(batch, torch.device("cpu"), TRAIN_KEYS)
    tmp = tmp_path_factory.mktemp("ranks")
    payload = tmp / "payload.pkl"
    with open(payload, "wb") as f:
        pickle.dump({"cfg": cfg, "variables": one["variables"], "locs": locs,
                     "inputs": {k: v.double() if v.is_floating_point() else v
                                for k, v in inputs.items()}}, f)
    ranks = run_ranks("step_rank", RANKS, str(tmp), str(payload), STEPS)
    return one, ranks


def test_two_ranks_take_the_global_loss(steps):
    one, ranks = steps
    assert [r["share"] for r in ranks] == [(0, 2), (2, 4)]
    assert ranks[0]["mean_loss"] == ranks[1]["mean_loss"]
    # the heatmap loss sums in f32 (`.float()`, as the JAX package does)
    np.testing.assert_allclose(ranks[0]["mean_loss"], one["loss_dict"]["loss"].item(), rtol=1e-6)
    np.testing.assert_allclose(ranks[0]["mean_loss"], one["jloss"], rtol=1e-5)
    assert ranks[0]["loss"] != ranks[1]["loss"]  # each rank's own items


def test_two_ranks_give_the_one_rank_and_jax_gradients(steps):
    one, ranks = steps
    scale = max(float(g.abs().max()) for g in one["grads"].values())
    for name, want in one["grads"].items():
        for r in ranks:
            assert torch.equal(r["grads"][name], ranks[0]["grads"][name]), name
        got = ranks[0]["grads"][name]
        torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-9 * scale, msg=name)
        jwant = one["jgrads"][name].numpy()
        if name == test_torch_train_step.ZERO_GRAD:
            assert got.abs().max().item() < 1e-5 * scale, name
            continue
        np.testing.assert_allclose(got.numpy(), jwant, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(jwant).max()), err_msg=name)


def test_two_ranks_move_the_bn_statistics_with_the_global_batch(steps):
    one, ranks = steps
    state = one["model"].state_dict()
    keys = [k for k in state if k.endswith(("running_mean", "running_var"))]
    assert len(keys) > 40
    for k in keys:
        for r in ranks:
            torch.testing.assert_close(r["state"][k], state[k], rtol=1e-9,
                                       atol=1e-9 * float(state[k].abs().max()), msg=k)
        want = one["jstats"][k].numpy()
        np.testing.assert_allclose(ranks[0]["state"][k].numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()), err_msg=k)


def test_ranks_hold_bit_equal_parameters_after_three_steps(steps):
    _, ranks = steps
    a, b = (r["params"] for r in ranks)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    moved = [k for k in a if not torch.equal(a[k], ranks[0]["state"][k])]
    assert len(moved) > len(a) // 2  # the steps after the first moved them


@pytest.mark.parametrize("recipe", ["tiny flagship", "configs/epipolar/synthetic_hg.yaml"])
def test_every_batchnorm_of_the_model_takes_global_moments(recipe):
    """C13: the trunk's, the deconv head's, the fusion's zero-init and the
    hourglass's BatchNorms all sync, whatever BACKBONE.SYNC_BN says."""
    from epipolar_transformers_tpu_torch.config import flagship_cfg, load_config
    from epipolar_transformers_tpu_torch.models import ModelBuilder
    from epipolar_transformers_tpu_torch.models.layers import BatchNorm2d, ZeroInitBatchNorm

    cfg = flagship_cfg(tiny=True) if recipe == "tiny flagship" else load_config(recipe)
    assert not cfg.BACKBONE.SYNC_BN
    bns = [m for m in ModelBuilder(cfg).modules()
           if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    assert len(bns) > 10 and any(isinstance(m, ZeroInitBatchNorm) for m in bns)
    assert all(isinstance(m, BatchNorm2d) and m.sync for m in bns)


def test_bn_that_would_train_on_local_moments_raises(steps):
    _, ranks = steps
    for r in ranks:
        assert "own moments" in r["guard"]
        assert "each rank's own moments" in r["ddp_guard"]


def test_a_group_of_one_rank_runs_ddp_and_the_bn_collectives(tmp_path):
    """torchrun --nproc_per_node 1 --multihost trains as each rank of a
    larger group: under DDP, BatchNorm's moments through its two
    all-reduces, to the same output and statistics as without a group; a
    BatchNorm with `sync` off trains (its moments are the global ones)."""
    (r,) = run_ranks("one_rank_group", 1, str(tmp_path))
    assert r["trained"] == "DistributedDataParallel"
    assert r["all_reduces"] == 2
    torch.testing.assert_close(*r["out"], rtol=1e-12, atol=1e-12)
    for a, b in zip(*r["running"]):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_count_normalised_losses_take_the_global_count(tmp_path):
    rng = np.random.RandomState(0)
    N, J, H, W = 4, 3, 5, 6
    vis = np.ones((N, J), np.float32)
    # the ranks see different counts; a visibility of exactly 0, where the
    # smooth loss's gradient stays finite in the port
    vis[0, :2] = vis[3, 1] = 0
    mask = rng.rand(N, H, W) > 0.6
    mask[2:] &= rng.rand(2, H, W) > 0.5
    rmask = (rng.rand(N, H, W, 1) > 0.5).astype(np.float64)
    rmask[:2, :3] = 0
    t = torch.from_numpy
    cases = {
        "keypoints_mse_smooth_loss": (keypoints_mse_smooth_loss, t(rng.rand(J, 1, 1)),
                                      [t(rng.rand(N, J, H, W)), t(rng.rand(N, J, H, W)) * 30,
                                       t(vis)], ()),
        "masked_mse_loss": (masked_mse_loss, t(rng.rand(1, H, W)),
                            [t(rng.rand(N, H, W)), t(rng.rand(N, H, W)), t(mask)], ()),
        "reprojection_loss": (reprojection_loss, t(rng.rand(1, 1, W, 2)),
                              [t(rng.rand(N, H, W, 2)), t(rng.rand(1, H, W, 2)), t(rmask)], (1,)),
    }
    ranks = run_ranks("loss_rank", RANKS, str(tmp_path), cases)
    for name, (fn, weight, args, shared) in cases.items():
        w = weight.clone().requires_grad_()
        want = fn(w * args[0], *args[1:])
        want.backward()
        for r in ranks:
            loss, grad = r[name]
            # the heatmap losses compute in f32, as in the JAX package
            np.testing.assert_allclose(loss, want.item(), rtol=1e-6, err_msg=name)
            torch.testing.assert_close(grad, w.grad, rtol=1e-6,
                                       atol=1e-6 * float(w.grad.abs().max()), msg=name)
        # the mean of the local ratios is another number
        halves = [fn(weight * args[0][s], *(b if i + 1 in shared else b[s]
                                            for i, b in enumerate(args[1:])))
                  for s in (slice(0, 2), slice(2, 4))]
        assert abs(float(sum(halves)) / 2 - want.item()) > 1e-3 * want.item(), name


def test_cli_multihost_under_torchrun(tmp_path):
    """torchrun with 2 ranks on the CPU (gloo): the tiny synthetic recipe
    trains 2 steps and tests one group; one RESULTS line, from rank 0."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(RANKS),
         "--master_port", str(free_port()),
         "-m", "epipolar_transformers_tpu_torch.main", "--multihost", "--device", "cpu",
         "--cfg", os.path.join(REPO, "configs/epipolar/synthetic_zresidual.yaml"),
         "--max-steps", "2", "--max-eval-batches", "1", "LOG_FREQ", "1",
         "OUTPUT_DIR", str(tmp_path / "out")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count("RESULTS:") == 1, proc.stdout[-3000:]
    steps = [line for line in proc.stdout.splitlines() if " step " in line and " loss: " in line]
    assert len(steps) == 2, proc.stdout[-3000:]
