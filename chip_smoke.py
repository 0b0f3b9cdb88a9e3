#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Needs one CUDA device and `nvcc`; exits non-zero without them, and in a
directory that does not hold the repository.  Phases, in the order they
run, each printed on its own lines:

  1. the card (nvidia-smi name and power limit) and the kernel build time;
  2. the CUDA epipolar-attention forward kernel against its plain PyTorch
     version at the flagship attention shape (B=8, 64x64, K=64, C=256): f32
     features on sample locations of the synthetic rig, bf16 features,
     random locations that cross the image edges, all samples out of range;
     two runs bit-equal, and the forward's tiles on each path (the tile
     kernel, or the per-query kernel) at the rig's and the random locations;
     then priors, priormul, prior similarity and softmax off at a smaller
     shape;
  3. the inference slice: the flagship ModelBuilder (epipolarposeR-50,
     256 px, K=64, 17 joints, bf16 convolutions) built on the card from a
     seed, 8 synthetic eval view groups through `engine.tester.predict` (the
     launch counter must grow by one per forward, and most of the
     forward's tiles must take the tile kernel), then the bench shape
     (batch 8) through the kernel path and the plain-attention path on the
     same weights;
  4. times with CUDA events after warm-up, in turns, kernel path against
     plain path, before any training: the attention forward alone (at the
     rig's locations, f32 and bf16, and at the edge-crossing ones, where
     every tile takes the per-query kernel) and the slice forward at batch 8;
  5. the CUDA backward kernels (through the autograd Function) against
     autograd of the plain version, at the flagship attention shape: f32
     with gradients to queries, keys and values, keys = values one tensor
     (as the model has them), detached keys and values, bf16, edge-crossing
     locations, all out of range (exactly zero), then priors, priormul and
     softmax off at the smaller shape; and two runs bit-equal (the backward
     sums in a fixed order);
  6. the training slice: `engine.trainer.train` on the flagship config for
     TRAIN_STEPS steps of batch 8 (finite loss every step, one forward and
     one backward kernel launch per step, most forward tiles on the tile
     kernel), a checkpoint and its resume, then
     one step on the kernel path and one on the plain path from the same
     weights: under bf16 convolutions the loss and the whole-model gradient
     are compared, under f32 convolutions every parameter's gradient;
  4. (continued) times as above: the attention backward alone (with and
     without the key/value gradients) and the train step at batch 8, and
     the peak memory of a train step on each path;
  7. the eval engine on [3]'s model: (a) `engine.tester.test` (pymvg) over
     ENGINE_GROUPS synthetic view groups, finite EPEmean_global,
     MPJPE@action0, JDR and PCK@*, one forward launch per group, most tiles
     on the tile kernel; (b) naive, refine, epipolar and epipolar_dlt on
     the same groups' outputs; (c) each group's ground-truth 2D points with
     unit scores through naive, refine and pymvg, within 0.1 mm of the 3D
     points; (d) RPSM with its unary terms on the card, each held to the
     host's, on one group's target heatmaps (PICT_STRUCT defaults) and at
     tests/test_pictorial.py's 64 px setting, within its 60 mm; (e) TEST.TRAIN_BN and TEST.RECOMPUTE_BN on 2
     groups (TRAIN_BN leaves the running statistics bit-equal,
     `recompute_bn` moves them, `test` restores them); (f) the port's
     command line in a subprocess (2 train steps, 2 eval groups) with a
     finite EPEmean_global in its RESULTS line;
  4. (continued) the eval engine's times per group: the loader's host ms,
     the eval forward's device ms (inputs on the card, and from the host
     arrays) and host ms to queue it, host ms of `process_group` under
     pymvg, wall ms (and groups/s) of the double-buffered drive against a
     serial one, in turns, and the device's idle share of a profiled run;
     then the kernels' bounds at [2]'s inputs;
  8. epipolarHG1 as configs/epipolar/synthetic_hg.yaml writes it (64 px,
     NFEATS 128, K=16, 16x16 maps, batch 16, DEVICE_RENDER on): the
     attention forward and backward alone at that shape against the plain
     version ([2]'s and [5]'s tolerances, two runs bit-equal, the forward's
     tiles on each path), their times beside the plain version and the
     bound; 10 steps of `train` (one forward and one backward launch a
     step); one f32 step, kernel path against plain path ([6]'s limits);
     `test` on 4 view groups of the trained model;
  9. configs/epipolar/synthetic_zresidual_flagship.yaml as written (R-50
     in f32, 256 px, batch 16, DEVICE_RENDER on): the device-rendered
     `img`, `other_img` and `heatmap` against the host's render of the same
     items (atol 2e-5), render ms on the card beside the host's, 3 steps of
     `train`, then ms per train step and peak memory at batch 16, and the
     `train` loop's wall per step with DEVICE_RENDER on and off;
 10. weight import: a reference-format R-50 checkpoint (the state dict that
     tests/test_torch_resnet.py rebuilds from poseresnet50_golden.npz, keys
     under `module.`, in {'model': ...}) through the command line's
     eval-only path, every imported key bit-equal to the file; then a port
     checkpoint tagged in `last_checkpoint` wins over that cfg.WEIGHTS;
 11. the other attention configs: (a) configs/epipolar/keypoint_h36m_param.yaml
     (theta/phi/g, BOTTLENECK 2, POOLING, RPSM; R-50, 256 px, batch 16)
     through the command line with only the synthetic datasets, no ImageNet
     file and 17 joints as overrides: 3 train steps with finite losses,
     `test` on 2 groups with finite metrics, one f32 step against the plain
     oracle route, ms per train step, peak memory and the pooled attention
     alone; (b) the learned prior through the kernels at the flagship
     attention shape, f32 and bf16, in each prior mode, forward and the
     backward's gradients (the prior's included) against the plain version
     ([2]/[5]'s tolerances), dprior exactly 0 on queries out of range, two
     runs bit-equal, the backward's time with and without the prior
     gradient; `train` on the flagship with EPIPOLAR.PRIOR (one forward and
     one backward launch a step, a finite nonzero table gradient) and one
     step against the plain path; (c) `train` with MERGE 'both' (two
     launches each way a step), then a step each with MERGE 'early', the
     reprojection loss, and epipolarHG1 with WARPEDHEATMAP and FIND_CORR
     'rgb';
 12. the lifting and single-view tasks: (a) configs/lifting/lifting_rot.yaml,
     lifting_direct.yaml and img_lifting_rot.yaml as written (batch 8,
     224 px heatmaps, 256 px crops, R-50 for img_lifting_rot) through the
     command line on a fake RHD tree of 320 px PNGs that the script writes
     with the port's zlib PNG writer: 3 train steps and `_test_lifting` on 2
     batches each, finite EPEmean_can / EPEmean, the host loader's ms per
     batch, ms per train step and peak memory; (b) multiview_img_lifting_rot
     at the flagship's widths (epipolarposeR-50, 256 px, bf16 convolutions,
     64x64, K=64, 17 joints, batch 8) on the rig's images and cameras with
     lifting targets from a seed: 3 train steps (one forward and one backward
     kernel launch each), one step kernel path against plain path ([6]'s
     limits), a nonzero gradient to the fusion BN's scale, no gradient to
     `other_img`, ms per step and peak memory; (c) the keypoint task
     (poseR-50, 256 px, batch 8) on the flagship recipe's rig through the
     command line, 3 steps and `test` under pymvg, finite MPJPE and JDR;
     (d) LiftingNet of each task on the card against the CPU (f32), and a
     hand3d TF pickle written from a seed imported through cfg.WEIGHTS with
     the same outputs on both devices.

The line before the card line is a JSON object with both kernels'
launches on the main path (phases 3, 6, 7(a), 8, 9, 11 and 12(b)), errors and times,
each entry's `hourglass_shape` times at [8]'s shape, and each kernel's
bound: the larger of its
operations over the f32 rate outside the tensor cores and its bytes (each
input read once, a tensor passed as keys and values once, each output
written once) over the memory rate, counted
from this run's inputs (the operations per distinct live (query, key row)
pair).  The forward's entry also holds `main_path_tiles`, its tiles on
each path over the forwards of phases 3, 6, 7(a), 8, 9, 11 and 12(b); the
backward's, `prior_gradient`, its time with and without the prior's
gradient at the flagship shape; `param_recipe` holds [11](a)'s times,
`lifting_tasks` [12]'s.  No
single PyTorch call
computes either kernel's function, so `library_ms` is null.  Before the
last line the script checks that nothing of the JAX package was imported;
the last line is {"ok": true, "device": {...}}.  Any failed check raises.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 0
FLAGSHIP_ATTENTION = dict(B=8, H=64, W=64, K=64, C=256)
BENCH_BATCH = 8
EVAL_GROUPS = 8
ENGINE_GROUPS = 16
# the eval engine's checks: ground-truth 2D points triangulate to the 3D
# points (f32 inputs, so ~1e-4 mm); RPSM's unary terms on the card agree
# with the host's as the CPU tests hold them to JAX; and at
# tests/test_pictorial.py's setting RPSM on target heatmaps is as close as
# that test asks
GT_TRIANGULATION_MM = 0.1
UNARY_TOL = dict(rtol=1e-5, atol=1e-6)
RPSM_MM = 60.0
RPSM_TEST_DEPTH = 6
CLI_CONFIG = "configs/epipolar/synthetic_zresidual.yaml"
TRAIN_STEPS = 10
# [8]-[10]: the two synthetic recipes as written, and the weight import
HG_CONFIG = "configs/epipolar/synthetic_hg.yaml"
FLAGSHIP_RECIPE = "configs/epipolar/synthetic_zresidual_flagship.yaml"
HG_TRAIN_STEPS = 10
HG_EVAL_GROUPS = 4
RECIPE_TRAIN_STEPS = 3
RECIPE_LOOP_STEPS = 6  # a run each with DEVICE_RENDER on and off
# device render against the host's windowed render (tests/test_device_render.py)
RENDER_ATOL = 2e-5
# f32: both sides compute in f32 (TF32 off); they differ only in summation
# order, ~1e-6 relative at C=256.
F32_TOL = dict(rtol=1e-4, atol=1e-5)
# bf16 features: the plain version rounds the Gram matrix and the weight
# matrix to bf16 (2^-9 relative each) where the kernel keeps f32 sums; with
# sims of |16| that is ~0.03 in a sim and ~0.4% in a softmax weight.
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
# slice, bf16 convolutions on both paths; the two attention outputs differ
# by f32 rounding, which can flip single bf16 roundings downstream (2^-8)
SLICE_HEATMAP_TOL = dict(rtol=2e-2, atol=2e-2)
MIN_AGREEMENT = 0.99
# gradients, kernel against autograd of the plain version: f32 differs in
# summation order; bf16 as the forward, the plain version rounding G and n
# to bf16.  The atol is relative to each gradient's max.
GRAD_F32_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_BF16_TOL = dict(rtol=5e-2, atol=5e-2)
# one train step, kernel path against plain path from the same weights:
# the loss, and under f32 convolutions each parameter gradient's relative L2
# error.  Under bf16 convolutions any f32-level difference (summation order,
# a cuDNN algorithm choice) is amplified through the trunk: single
# parameters differ by up to ~0.03 between the paths, so bf16 holds the
# whole-model error within STEP_BF16_NOISE_FACTOR times the kernel path's
# own spread in the same run, and never below STEP_GRAD_REL_L2
STEP_LOSS_RTOL = 2e-2
STEP_GRAD_REL_L2 = 2e-2
STEP_BF16_NOISE_FACTOR = 1.5
# a parameter whose gradient stays below this share of the largest on both
# paths has a true gradient of 0 (a bias feeding a batch-statistics BN; the
# hourglass has ~50), and its rounding noise is left out of the comparison
STEP_NOISE_FLOOR = 1e-5
# feeds the zero-init BN, which runs on batch statistics in training and
# removes any constant shift: its true gradient is 0 on both paths
ZERO_GRAD_PARAMS = ("reference.epipolar_sampler.z.bias",)
# [11]: the other attention configs.  The param recipe's overrides, each
# named in its log line: the synthetic rig's datasets, no ImageNet file, and
# 17 joints (RPSM's skeleton; the rig renders any count)
PARAM_RECIPE = "configs/epipolar/keypoint_h36m_param.yaml"
PARAM_OVERRIDES = ["DATASETS.TRAIN", "('synthetic_multiview_train',)",
                   "DATASETS.TEST", "('synthetic_multiview_val',)",
                   "BACKBONE.PRETRAINED", "False", "KEYPOINT.NUM_PTS", "17"]
PARAM_TRAIN_STEPS = 3
PARAM_EVAL_GROUPS = 2
PRIOR_MODES = [("additive", dict()), ("additive, softmax off", dict(softmax_enabled=False)),
               ("priormul", dict(priormul=True)), ("similarity 'prior'", dict(similarity="prior"))]
DEAD_QUERIES = 8  # queries of each item's first row whose samples all lie out of range
RIG_CAMERAS = (0, 1, 2, 3)
FUSION_TRAIN_STEPS = 3
# [12]: the lifting and single-view tasks.  (a) the three RHD recipes as
# written (batch 8, 224 px heatmaps, 256 px crops of 320 px images, R-50 for
# img_lifting_rot) on a fake RHD tree; (b) multiview_img_lifting_rot at the
# flagship's widths; (c) the keypoint task, poseR-50 on the flagship recipe;
# (d) LiftingNet on the card against the CPU: f32 with TF32 off, so the two
# differ in summation order only
LIFTING_RECIPES = ("configs/lifting/lifting_rot.yaml", "configs/lifting/lifting_direct.yaml",
                   "configs/lifting/img_lifting_rot.yaml")
RHD_ITEMS = 24  # a set: 3 train batches of 8, 2 eval batches
LIFTING_TRAIN_STEPS = 3
LIFTING_EVAL_BATCHES = 2
LOADER_BATCHES = 3
KEYPOINT_OVERRIDES = ["DATASETS.TASK", "keypoint", "BACKBONE.BODY", "poseR-50",
                      "SOLVER.IMS_PER_BATCH", "8"]
KEYPOINT_STEPS = 3
KEYPOINT_EVAL_GROUPS = 4
LIFTING_NET_TOL = dict(rtol=1e-4, atol=1e-5)
REPLACES = "epipolar_transformers_tpu/ops/epipolar_attention_pallas.py:66"
BACKWARD_REPLACES = ("jax.grad of epipolar_transformers_tpu/ops/"
                     "epipolar_attention_matmul.py:158 (no TPU backward kernel)")
# published H100 SXM peaks: f32 outside the tensor cores, HBM
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call, CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(a, b, iters: int = 20):
    """Time a and b as a, b, b, a and return the two means."""
    ta1, tb1 = cuda_ms(a, iters), cuda_ms(b, iters)
    tb2, ta2 = cuda_ms(b, iters), cuda_ms(a, iters)
    return (ta1 + ta2) / 2, (tb1 + tb2) / 2


def close(name, got, want, rtol, atol) -> float:
    """Raise unless |got - want| <= atol + rtol |want| everywhere; returns
    the max abs error."""
    import torch

    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} elements outside "
            f"rtol={rtol} atol={atol}, max abs err {float(err.max()):.3g}")
    return float(err.max())


def agreement(name, got, want, tol) -> float:
    """Share of entries whose last-axis vector agrees within `tol` (max
    norm); raise below MIN_AGREEMENT."""
    ok = ((got.float() - want.float()).abs().amax(-1) <= tol).float().mean().item()
    if ok < MIN_AGREEMENT:
        raise AssertionError(f"{name}: only {ok:.4f} agree within {tol}")
    return ok


def rig_sample_locs(cfg, batch, device):
    """(batch, K, h, w, 2) locations of `cfg`'s synthetic rig view pairs
    (each view with its nearest neighbour, cycled), through the port."""
    import torch

    from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
    from epipolar_transformers_tpu_torch.models.epipolar import Epipolar
    from epipolar_transformers_tpu_torch.ops.epipolar_sampling import epipolar_sample_locs

    ds = SyntheticMultiview(cfg, is_train=False, n_samples=1)
    views = [v % ds.n_views for v in range(batch)]
    P1 = torch.as_tensor(ds.rig["KRT"][views], dtype=torch.float32, device=device)
    P2 = torch.as_tensor(ds.rig["KRT"][[ds.nearest[v] for v in views]],
                         dtype=torch.float32, device=device)
    return epipolar_sample_locs(P1, P2, Epipolar(cfg).geometry)


def write_fake_rhd(data_dir: str, n_items: int, seed: int = SEED, size: int = 320) -> None:
    """A fake RHD tree under `data_dir` (RHD_published_v2/{training,
    evaluation}: color/ and mask/ PNGs of `size` px written by the port's
    zlib PNG writer with all five row filters, and anno_<set>.pickle with
    42 uv_vis and xyz points a sample), n_items a set, from `seed`.  Even
    items are left hands, odd ones right (by the mask's labels)."""
    import os
    import pickle

    import numpy as np

    from epipolar_transformers_tpu_torch.data.image_io import write_png

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    for subset in ("training", "evaluation"):
        root = os.path.join(data_dir, "RHD_published_v2", subset)
        for kind in ("color", "mask"):
            os.makedirs(os.path.join(root, kind), exist_ok=True)
        anno = {}
        for i in range(n_items):
            centre = rng.uniform(0.3 * size, 0.7 * size, 2)
            uv = centre + rng.randn(42, 2) * 0.08 * size
            shade = (np.sin(xx / 17.0 + i)[..., None] * 60 + 128
                     + rng.randint(0, 40, (size, size, 3)))
            write_png(os.path.join(root, "color", f"{i:05d}.png"),
                      np.clip(shade, 0, 255).astype(np.uint8), filters=(0, 1, 2, 3, 4))
            mask = np.zeros((size, size), np.uint8)
            hand = (yy - centre[1]) ** 2 + (xx - centre[0]) ** 2 < (0.12 * size) ** 2
            mask[hand] = 5 if i % 2 == 0 else 20
            write_png(os.path.join(root, "mask", f"{i:05d}.png"), mask, filters=(1, 2, 4))
            anno[i] = {"uv_vis": np.concatenate([uv, (rng.rand(42, 1) > 0.1)], axis=1),
                       "xyz": rng.randn(42, 3) * 0.04 + np.array([0.0, 0.0, 0.6]),
                       "K": np.array([[300.0, 0, size / 2], [0, 300.0, size / 2], [0, 0, 1]])}
        with open(os.path.join(root, f"anno_{subset}.pickle"), "wb") as f:
            pickle.dump(anno, f)


def write_hand3d_pickle(path: str, rng, hw: int, side: int) -> None:
    """A TF pickle in the hand3d layout for LiftingNet, `hw` cells after the
    conv stacks and `side` hand-side inputs: PosePrior (conv_pose_{s}_{i},
    fc_rel{0,1}, fc_xyz) and ViewpointNet (conv_vp_{s}_{i}, fc_vp{0,1},
    fc_vp_u{x,y,z}), HWCN conv kernels, random O(1) weights from `rng`."""
    import pickle

    import numpy as np

    w = {}

    def conv(prefix, widths):
        c_in = 21
        for s, width in enumerate(widths):
            for i in (1, 2):
                w[f"{prefix}_{s}_{i}/weights"] = rng.randn(3, 3, c_in, width) * (9 * c_in) ** -0.5
                w[f"{prefix}_{s}_{i}/biases"] = 0.1 * rng.randn(width)
                c_in = width

    def dense(name, n_in, n_out):
        w[f"{name}/weights"] = rng.randn(n_in, n_out) * n_in ** -0.5
        w[f"{name}/biases"] = 0.1 * rng.randn(n_out)

    conv("PosePrior/conv_pose", (32, 64, 128))
    dense("PosePrior/fc_rel0", 128 * hw + side, 512)
    dense("PosePrior/fc_rel1", 512, 512)
    dense("PosePrior/fc_xyz", 512, 63)
    conv("ViewpointNet/conv_vp", (64, 128, 256))
    dense("ViewpointNet/fc_vp0", 256 * hw + side, 256)
    dense("ViewpointNet/fc_vp1", 256, 128)
    for axis in "xyz":
        dense(f"ViewpointNet/fc_vp_u{axis}", 128, 1)
    with open(path, "wb") as f:
        pickle.dump({k: v.astype(np.float32) for k, v in w.items()}, f)


def attention_phase(cfg, device):
    """Kernel against plain version; returns the f32 flagship max abs error."""
    import torch

    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn
    from epipolar_transformers_tpu_torch.ops.epipolar_attention import AttentionParams
    from epipolar_transformers_tpu_torch.ops.epipolar_attention_cuda import (
        epipolar_attention_batch, epipolar_attention_plain_batch)

    gen = torch.Generator(device=device).manual_seed(SEED)
    s = FLAGSHIP_ATTENTION
    B, H, W, K, C = s["B"], s["H"], s["W"], s["K"], s["C"]

    def feats(b, h, w, c, dtype):
        return [torch.randn(b, h, w, c, device=device, generator=gen).to(dtype)
                for _ in range(3)]

    def check(name, f, locs, params, prior=None, tol=F32_TOL, corr_agree=True):
        got = epipolar_attention_batch(*f, locs, params, prior)
        want = epipolar_attention_plain_batch(*f, locs, params, prior)
        e_out = close(f"{name} out", got[0], want[0], **tol)
        e_depth = close(f"{name} depth", got[2], want[2], **tol)
        line = f"  {name}: max abs err out {e_out:.3g} depth {e_depth:.3g}"
        if corr_agree:
            ok = agreement(f"{name} corr_pos", got[1], want[1], 1e-3)
            line += f", corr_pos agree {ok:.4f}"
        log(line)
        return max(e_out, e_depth)

    flagship = AttentionParams(softmax_scale=cfg.EPIPOLAR.SOFTMAXSCALE)
    rig = rig_sample_locs(cfg, B, device)
    rand_locs = torch.rand(B, K, H, W, 2, device=device, generator=gen) * 2.6 - 1.3
    f32 = feats(B, H, W, C, torch.float32)
    attn.TILE_COUNTS.clear()
    err = check("f32 rig locs (flagship shape)", f32, rig, flagship)
    rig_tiles = attn.tile_counts()
    again = epipolar_attention_batch(*f32, rig, flagship)
    if not all(torch.equal(a, b) for a, b in
               zip(again, epipolar_attention_batch(*f32, rig, flagship))):
        raise AssertionError("two forward runs on the same inputs differ")
    attn.TILE_COUNTS.clear()
    check("f32 edge-crossing locs", f32, rand_locs, flagship)
    rand_tiles = attn.tile_counts()
    if rig_tiles[0] <= rig_tiles[1] or rand_tiles[0] != 0:
        raise AssertionError(f"forward tiles (tile path, per-query path): rig {rig_tiles}, "
                             f"edge-crossing {rand_tiles}")
    log(f"  f32 rig locs: two runs bit-equal; forward tiles on the tile path / per-query "
        f"path: rig {rig_tiles[0]} / {rig_tiles[1]}, edge-crossing {rand_tiles[0]} / "
        f"{rand_tiles[1]}")
    check("bf16 rig locs", feats(B, H, W, C, torch.bfloat16), rig, flagship, tol=BF16_TOL)
    out, _, depth = epipolar_attention_batch(
        *f32, torch.full_like(rig, -9.0), flagship)
    if out.abs().max().item() != 0.0:
        raise AssertionError("all samples out of range: out is not exactly zero")
    log(f"  all out of range: out exactly 0, depth {depth.min().item():.6g}..{depth.max().item():.6g}")

    b, h, w, k, c = 2, 16, 16, 16, 64
    small = feats(b, h, w, c, torch.float32)
    locs = torch.rand(b, k, h, w, 2, device=device, generator=gen) * 2.6 - 1.3
    prior = torch.rand(b, k, h, w, device=device, generator=gen) * 0.1
    for name, kw, pr in (
        ("additive prior", dict(), prior),
        ("priormul", dict(priormul=True), prior),
        ("prior similarity", dict(similarity="prior"), prior),
        ("softmax off", dict(softmax_enabled=False), None),
    ):
        check(f"{name} (2x16x16, K=16, C=64)", small, locs,
              AttentionParams(softmax_scale=k ** -0.5, **kw), pr)
    return err, (f32, rig, rand_locs, flagship)


def randomize(model, images, seed):
    """Random weights from `seed` at a scale that keeps activations O(1):
    He-normal convs, random zero-init-BN affine, and every other BN's running
    statistics set to those of one batch of `images` (momentum 1)."""
    import torch

    from epipolar_transformers_tpu_torch.models.layers import BatchNorm2d

    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                fan_in = mod.weight[0].numel() if isinstance(mod, torch.nn.Conv2d) \
                    else mod.weight.shape[0] * mod.weight[0, 0].numel() // 4
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen)
                                 * (2.0 / fan_in) ** 0.5)
                if mod.bias is not None:
                    mod.bias.copy_(torch.randn(mod.bias.shape, generator=gen) * 0.1)
        randomize_fusion(model, gen)
        sampler = model.reference.epipolar_sampler
        bns = [m for m in model.reference.modules()
               if isinstance(m, BatchNorm2d) and m is not sampler.bn]
        for m in bns:
            m.train()
            m.momentum = 1.0
        model.reference.trunk_features(images)
        for m in bns:
            m.momentum = 0.1
            m.eval()


@contextlib.contextmanager
def attention_path(model, plain: bool):
    """Run `model`'s epipolar layers through the plain version (plain) or
    the kernels, on the same weights."""
    from epipolar_transformers_tpu_torch.models.epipolar import Epipolar
    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn

    samplers = [m for m in model.modules() if isinstance(m, Epipolar)]
    for sampler in samplers:
        sampler.attention = (attn.epipolar_attention_plain_batch if plain
                             else attn.epipolar_attention_batch)
    try:
        yield
    finally:
        for sampler in samplers:
            del sampler.attention


def slice_phase(cfg, device):
    """The main path: 8 eval view groups through predict, then the bench
    batch through the kernel and plain paths.  Returns what timing needs."""
    import numpy as np
    import torch

    from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
    from epipolar_transformers_tpu_torch.data.pipeline import EvalLoader, collate
    from epipolar_transformers_tpu_torch.engine.tester import predict, to_model_inputs
    from epipolar_transformers_tpu_torch.models import ModelBuilder
    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn

    torch.manual_seed(SEED)
    model = ModelBuilder(cfg).to(device).to(memory_format=torch.channels_last)
    np.random.seed(SEED)
    bench_ds = SyntheticMultiview(cfg, is_train=True, n_samples=BENCH_BATCH, seed=SEED)
    bench = to_model_inputs(collate([bench_ds[i] for i in range(BENCH_BATCH)]), device)
    randomize(model, torch.cat([bench["img"], bench["other_img"]]), SEED)
    model.eval()

    eval_ds = SyntheticMultiview(cfg, is_train=False, n_samples=EVAL_GROUPS, seed=SEED)
    attn.LAUNCHES = 0
    attn.TILE_COUNTS.clear()
    outputs = predict(cfg, model, EvalLoader(eval_ds), max_batches=EVAL_GROUPS)
    torch.cuda.synchronize(device)
    launches, tiles = attn.LAUNCHES, attn.tile_counts()
    if len(outputs) != EVAL_GROUPS or launches != EVAL_GROUPS:
        raise AssertionError(f"{len(outputs)} forwards launched the kernel {launches} times")
    V, J = eval_ds.n_views, cfg.KEYPOINT.NUM_PTS
    h, w = cfg.KEYPOINT.HEATMAP_SIZE
    check_main_path_tiles("predict", tiles, launches * V * -(-h * w // attn.TILE_QUERIES))
    K = cfg.EPIPOLAR.SAMPLESIZE
    shapes = {"heatmap_pred": (V, J, h, w), "batch_locs": (V, J, 2), "score_pred": (V, J),
              "corr_pos": (V, h, w, 2), "depth": (V, K, h, w)}
    for out in outputs:
        for k, shape in shapes.items():
            if tuple(out[k].shape) != shape or not torch.isfinite(out[k]).all():
                raise AssertionError(f"{k}: shape {tuple(out[k].shape)} (want {shape}) or non-finite")
    log(f"  predict: {EVAL_GROUPS} view groups of {V} views, all outputs finite with "
        f"the expected shapes; kernel launches {launches} (one per forward), forward "
        f"tiles on the tile path / per-query path {tiles[0]} / {tiles[1]}")

    def forward(plain: bool):
        with attention_path(model, plain), torch.inference_mode():
            return model(bench)

    got, want = forward(False), forward(True)
    e_hm = close("slice heatmap_pred", got["heatmap_pred"], want["heatmap_pred"],
                 **SLICE_HEATMAP_TOL)
    ok_locs = agreement("slice batch_locs", got["batch_locs"], want["batch_locs"], 1.0)
    close("slice depth", got["depth"], want["depth"], **F32_TOL)
    log(f"  bench batch {BENCH_BATCH}: kernel vs plain path heatmap_pred max abs err "
        f"{e_hm:.3g}, batch_locs within 1 px {ok_locs:.4f}, depth within f32 tol")
    return launches, tiles, forward, model


def check_main_path_tiles(name, tiles, total):
    """The main path's forwards put most of their tiles (tile path,
    per-query path) on the tile kernel, and count every tile once."""
    if sum(tiles) != total or tiles[0] <= tiles[1]:
        raise AssertionError(f"{name}: forward tiles on the tile path / per-query path "
                             f"{tiles[0]} / {tiles[1]}, of {total}")


def attention_grads(fn, feats, locs, params, prior=None, need_kv=True):
    """Gradients of sum(out * r), r fixed by SEED, with respect to the query,
    key and value features (keys and values only when need_kv)."""
    import torch

    leaves = [t.detach().clone().requires_grad_(i == 0 or need_kv) for i, t in enumerate(feats)]
    out = fn(*leaves, locs, params, prior)[0]
    gen = torch.Generator(device=out.device).manual_seed(SEED + 1)
    r = torch.randn(out.shape, device=out.device, generator=gen)
    (out.float() * r).sum().backward()
    return [t.grad for t in leaves]


def close_grads(name, got, want, rtol, atol):
    """`close` for each of dfeat1/dother1/dother2 with atol x its max;
    returns the largest max abs error."""
    err = 0.0
    for which, g, w in zip(("dfeat1", "dother1", "dother2"), got, want):
        if w is None:
            if g is not None:
                raise AssertionError(f"{name} {which}: a gradient nobody asked for")
            continue
        scale = max(float(w.float().abs().max()), 1e-30)
        err = max(err, close(f"{name} {which}", g, w, rtol, atol * scale))
    return err


def backward_phase(cfg, device):
    """Backward kernel against autograd of the plain version; returns the
    f32 flagship max abs error."""
    import torch

    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn
    from epipolar_transformers_tpu_torch.ops.epipolar_attention import AttentionParams

    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    s = FLAGSHIP_ATTENTION
    B, H, W, K, C = s["B"], s["H"], s["W"], s["K"], s["C"]

    def feats(b, h, w, c, dtype):
        return [torch.randn(b, h, w, c, device=device, generator=gen).to(dtype)
                for _ in range(3)]

    def check(name, f, locs, params, prior=None, tol=GRAD_F32_TOL, need_kv=True):
        before = attn.BACKWARD_LAUNCHES
        got = attention_grads(attn.epipolar_attention_batch, f, locs, params, prior, need_kv)
        if attn.BACKWARD_LAUNCHES != before + 1:
            raise AssertionError(f"{name}: {attn.BACKWARD_LAUNCHES - before} backward launches")
        want = attention_grads(attn.epipolar_attention_plain_batch, f, locs, params, prior,
                               need_kv)
        err = close_grads(name, got, want, **tol)
        log(f"  {name}: max abs err {err:.3g}"
            + ("" if need_kv else " (dfeat1 only; key/value gradients not computed)"))
        return err

    def kv_grads(fn, f):
        """Gradients with keys = values one tensor, as the model has them."""
        f1, f2 = f[0].clone().requires_grad_(), f[1].clone().requires_grad_()
        out = fn(f1, f2, f2, rig, flagship)[0]
        r = torch.randn(out.shape, device=device,
                        generator=torch.Generator(device=device).manual_seed(SEED + 1))
        return torch.autograd.grad((out.float() * r).sum(), (f1, f2))

    flagship = AttentionParams(softmax_scale=cfg.EPIPOLAR.SOFTMAXSCALE)
    rig = rig_sample_locs(cfg, B, device)
    rand_locs = torch.rand(B, K, H, W, 2, device=device, generator=gen) * 2.6 - 1.3
    f32 = feats(B, H, W, C, torch.float32)
    err = check("f32 rig locs, OTHER_GRAD (flagship shape)", f32, rig, flagship)
    got, again = kv_grads(attn.epipolar_attention_batch, f32), \
        kv_grads(attn.epipolar_attention_batch, f32)
    e_kv = close_grads("f32 keys = values one tensor", got,
                       kv_grads(attn.epipolar_attention_plain_batch, f32), **GRAD_F32_TOL)
    err = max(err, e_kv)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("two backward runs on the same inputs differ")
    log(f"  f32 keys = values one tensor: max abs err {e_kv:.3g}; two runs bit-equal")
    check("f32 detached keys and values", f32, rig, flagship, need_kv=False)
    check("bf16 rig locs", feats(B, H, W, C, torch.bfloat16), rig, flagship, tol=GRAD_BF16_TOL)
    check("f32 edge-crossing locs", f32, rand_locs, flagship)
    grads = attention_grads(attn.epipolar_attention_batch, f32, torch.full_like(rig, -9.0),
                            flagship)
    if any(g.abs().max().item() != 0.0 for g in grads):
        raise AssertionError("all samples out of range: a gradient is not exactly zero")
    log("  all out of range: every gradient exactly 0")

    b, h, w, k, c = 2, 16, 16, 16, 64
    small = feats(b, h, w, c, torch.float32)
    locs = torch.rand(b, k, h, w, 2, device=device, generator=gen) * 2.6 - 1.3
    prior = torch.rand(b, k, h, w, device=device, generator=gen) * 0.1
    for name, kw, pr in (
        ("additive prior", dict(), prior),
        ("priormul", dict(priormul=True), prior),
        ("softmax off", dict(softmax_enabled=False), None),
    ):
        check(f"{name} (2x16x16, K=16, C=64)", small, locs,
              AttentionParams(softmax_scale=k ** -0.5, **kw), pr)
    return err


class _Messages(logging.Handler):
    """Collects the formatted messages of one logger and their times."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages, self.times = [], []

    def emit(self, record):
        self.messages.append(record.getMessage())
        self.times.append(record.created)


def counted_train(name, tcfg, steps, device, per_step=1, terms=()):
    """`engine.trainer.train` for `steps` steps of `tcfg` (LOG_FREQ 1), the
    main path: the kernels' counters set to 0 just before and read just
    after.  Raises unless every step's loss (and each loss term in `terms`)
    is finite, each step launched the forward and the backward kernel
    `per_step` times (once per fusion layer on the kernel route), the model
    ran on the card and most forward tiles took the tile kernel.  Returns
    the model, the optimizer, the forward and backward launches, the tiles
    on each path, the losses, the wall seconds, and the loop's wall per
    step after the first in ms: loader, inputs and step, between two of the
    step log lines, each written after the step's loss reached the host."""
    import numpy as np
    import torch

    from epipolar_transformers_tpu_torch.engine import trainer
    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn

    messages = _Messages()
    train_log = logging.getLogger(trainer.__name__)
    train_log.addHandler(messages)
    train_log.setLevel(logging.INFO)
    np.random.seed(SEED)  # the loader's reference views and augmentation
    try:
        attn.LAUNCHES = attn.BACKWARD_LAUNCHES = 0
        attn.TILE_COUNTS.clear()
        t0 = time.perf_counter()
        model, optimizer = trainer.train(tcfg, max_steps=steps, device=device)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        launches, backward_launches = attn.LAUNCHES, attn.BACKWARD_LAUNCHES
        tiles = attn.tile_counts()
    finally:
        train_log.removeHandler(messages)
    logged = [(t, float(m)) for t, msg in zip(messages.times, messages.messages)
              for m in re.findall(r"\bloss (\S+)", msg)]
    losses = [loss for _, loss in logged]
    step_ms = [(b[0] - a[0]) * 1e3 for a, b in zip(logged, logged[1:])]
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"{name} train losses {losses}")
    for term in terms:
        values = [float(v) for msg in messages.messages
                  for v in re.findall(rf"\b{term} (\S+)", msg)]
        if len(values) != steps or not all(np.isfinite(values)):
            raise AssertionError(f"{name} train {term} {values}")
    if not (launches == backward_launches == per_step * steps and optimizer.count == steps):
        raise AssertionError(f"{name}: {optimizer.count} steps launched the forward kernel "
                             f"{launches} and the backward kernel {backward_launches} times")
    if next(model.parameters()).device != device:
        raise AssertionError(f"{name}: the trainer did not run on the card")
    h, w = tcfg.KEYPOINT.HEATMAP_SIZE
    if launches:
        check_main_path_tiles(f"{name} train", tiles, launches * tcfg.SOLVER.IMS_PER_BATCH
                              * -(-h * w // attn.TILE_QUERIES))
    return model, optimizer, launches, backward_launches, tiles, losses, wall, step_ms


def train_phase(cfg, device):
    """The training main path through `engine.trainer.train`, its
    checkpoint resume, and one step on each attention path.  Returns the
    launch counts and what timing needs."""
    import torch

    from epipolar_transformers_tpu_torch.config import update_from_dict
    from epipolar_transformers_tpu_torch.engine import trainer
    from epipolar_transformers_tpu_torch.engine.solver import make_optimizer
    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn
    from epipolar_transformers_tpu_torch.utils.checkpoint import Checkpointer

    with tempfile.TemporaryDirectory() as out_dir:
        tcfg = update_from_dict(cfg, {"OUTPUT_DIR": out_dir, "LOG_FREQ": 1,
                                      "TENSORBOARD": {"USE": False}})
        model, optimizer, launches, backward_launches, tiles, losses, wall, _ = counted_train(
            "[6]", tcfg, TRAIN_STEPS, device)
        log(f"  train: {TRAIN_STEPS} steps of batch {tcfg.SOLVER.IMS_PER_BATCH} in {wall:.1f} s "
            f"(first steps include cuDNN autotuning and the loader's start), loss "
            f"{losses[0]:.5g} -> {losses[-1]:.5g}, all finite; forward kernel launches "
            f"{launches}, backward kernel launches {backward_launches} (one each per step); "
            f"forward tiles on the tile path / per-query path {tiles[0]} / {tiles[1]}")

        Checkpointer(out_dir).save("model_000", model, optimizer, epoch=1)
        resumed, resumed_opt = trainer.train(
            tcfg.replace(SOLVER=tcfg.SOLVER.replace(MAX_EPOCHS=1)), device=device)
        if resumed_opt.count != TRAIN_STEPS or attn.BACKWARD_LAUNCHES != backward_launches:
            raise AssertionError(f"resume: {resumed_opt.count} optimizer steps restored, "
                                 f"{attn.BACKWARD_LAUNCHES - backward_launches} new steps")
        for (k, a), b in zip(model.state_dict().items(), resumed.state_dict().values()):
            if not torch.equal(a, b):
                raise AssertionError(f"resume: {k} differs from the checkpoint")
        log(f"  checkpoint: saved, resumed with {resumed_opt.count} optimizer steps and "
            "identical weights, no step taken")
    del model, optimizer, resumed, resumed_opt

    model, batch = step_parity(cfg, device, per_param=False)
    step_parity(cfg.replace(DTYPE="float32"), device, per_param=True)

    optimizer = make_optimizer(cfg, model)
    step = trainer.make_train_step(cfg, model, optimizer)

    def train_step(plain: bool):
        with attention_path(model, plain):
            step(batch)

    return launches, backward_launches, tiles, train_step


def randomize_fusion(model, gen):
    """A random affine for the zero-init fusion BN, drawn from `gen` (else
    the `z` branch gets no gradient)."""
    import torch

    bn = model.reference.epipolar_sampler.bn
    with torch.no_grad():
        bn.weight.copy_(torch.randn(bn.weight.shape, generator=gen) * 0.5)
        bn.bias.copy_(torch.randn(bn.bias.shape, generator=gen) * 0.1)


def step_parity(cfg, device, per_param: bool, hourglass: bool = False):
    """One train step's loss and gradients on the kernel path (twice, which
    gives the noise floor of cuDNN's algorithm choices; the attention
    backward is bit-equal) and on the plain path, from the same randomized
    weights.

    Under bf16 convolutions the loss and the whole model's gradient are
    held, the gradient against the kernel path's own spread; f32
    convolutions (per_param) hold every parameter's gradient, where bf16
    rounding downstream of the attention would otherwise amplify f32-level
    differences through the deep trunk.  A parameter whose gradient lies
    below STEP_NOISE_FLOOR of the largest on both paths is rounding noise
    of a true 0 (a bias that feeds a batch-statistics BN) and is left out.
    The PoseResNet's weights are randomized (`randomize`); the hourglass
    keeps its initial weights, the fusion BN's affine randomized.
    Returns the model and the batch."""
    import numpy as np
    import torch

    from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
    from epipolar_transformers_tpu_torch.data.pipeline import collate
    from epipolar_transformers_tpu_torch.engine import trainer
    from epipolar_transformers_tpu_torch.ops.synthetic_render import make_batch_renderer

    model = trainer.build_model(cfg, device)
    n = cfg.SOLVER.IMS_PER_BATCH if hourglass else BENCH_BATCH
    np.random.seed(SEED)
    ds = SyntheticMultiview(cfg, is_train=True, n_samples=n, seed=SEED)
    batch = trainer.model_inputs(collate([ds[i] for i in range(n)]), device,
                                 make_batch_renderer(cfg))
    if hourglass:
        randomize_fusion(model, torch.Generator().manual_seed(SEED))
    else:
        randomize(model, torch.cat([batch["img"], batch["other_img"]]), SEED)
    dtype = "bf16" if cfg.DTYPE == "bfloat16" else "f32"
    compare_step_paths(f"{dtype} {'epipolarHG1' if hourglass else 'flagship'}", model, batch,
                       per_param)
    return model, batch


def compare_step_paths(name, model, batch, per_param: bool):
    """One train step's loss and gradients of `model` on `batch`, kernel
    path (twice) against plain path, held as `step_parity` says; the
    dropout masks (the lifting net's) restart from SEED for each run.
    Returns the kernel path's gradients."""
    import numpy as np
    import torch

    model.train()

    def loss_and_grads(plain: bool):
        model.zero_grad(set_to_none=True)
        model.seed_dropout(SEED)
        with attention_path(model, plain):
            loss = model(batch)[0]["loss"]
            loss.backward()
        return loss.item(), {k: p.grad.detach().clone() for k, p in model.named_parameters()
                             if p.grad is not None and k not in ZERO_GRAD_PARAMS}

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    loss_k, grads_k = loss_and_grads(False)
    _, grads_k2 = loss_and_grads(False)
    loss_p, grads_p = loss_and_grads(True)
    kept = dict(grads_k)
    if abs(loss_k - loss_p) > STEP_LOSS_RTOL * abs(loss_p) or not np.isfinite(loss_k):
        raise AssertionError(f"{name} train step loss: kernel path {loss_k}, plain {loss_p}")
    if set(grads_k) != set(grads_p):
        raise AssertionError("the two paths give gradients to different parameters")
    floor = STEP_NOISE_FLOOR * max(float(g.abs().max()) for g in grads_p.values())
    noise = {k for k in grads_p
             if max(float(grads_k[k].abs().max()), float(grads_p[k].abs().max())) < floor}
    for grads in (grads_k, grads_k2, grads_p):
        for k in noise:
            del grads[k]
    whole = rel(torch.cat([g.flatten() for g in grads_k.values()]),
                torch.cat([g.flatten() for g in grads_p.values()]))
    whole_self = rel(torch.cat([g.flatten() for g in grads_k2.values()]),
                     torch.cat([g.flatten() for g in grads_k.values()]))
    limit = STEP_GRAD_REL_L2 if per_param else max(STEP_GRAD_REL_L2,
                                                   STEP_BF16_NOISE_FACTOR * whole_self)
    if not whole <= limit:
        raise AssertionError(f"{name} whole-model gradient relative L2 error {whole:.3g} "
                             f"above {limit:.3g} (kernel path against itself {whole_self:.3g})")
    errs = {k: rel(grads_k[k], g) for k, g in grads_p.items()}
    worst = max(errs, key=errs.get)
    if per_param and not errs[worst] <= STEP_GRAD_REL_L2:
        raise AssertionError(f"{name} {worst}: gradient relative L2 error {errs[worst]:.3g}")
    n = next(iter(batch.values())).shape[0]
    log(f"  one {name} step (batch {n}), kernel vs plain path: loss {loss_k:.6g} vs "
        f"{loss_p:.6g}; gradient relative L2 error {whole:.3g} over the model (kernel path "
        f"against itself {whole_self:.3g}), worst parameter {errs[worst]:.3g} ({worst}; kernel "
        f"path against itself {rel(grads_k2[worst], grads_k[worst]):.3g}) over {len(errs)} "
        f"parameters ({len(noise)} with a true gradient of 0 left out)")
    return kept


def finite_metrics(name, results) -> None:
    """Raise unless the eval metrics are all there and finite."""
    import math

    keys = {"EPEmean_global", "MPJPE@action0", "JDR"}
    if not keys <= set(results) or not any(k.startswith("PCK@") for k in results):
        raise AssertionError(f"{name}: metrics {sorted(results)}")
    if not all(math.isfinite(v) for v in results.values()):
        raise AssertionError(f"{name}: non-finite metrics {results}")


def rpsm_check(name, cfg, item, device, recur_depth):
    """RPSM on `item`'s target heatmaps, the boxes at the image centre and
    scale (tests/test_pictorial.py), with its unary terms on the card, each
    held to the same sampling on the host (UNARY_TOL); then the whole RPSM
    on the host.  Returns the mean errors (mm) on the card and the host,
    whether the poses are equal, the card's seconds and the total."""
    import numpy as np
    import torch

    from epipolar_transformers_tpu_torch.geometry import pictorial
    from epipolar_transformers_tpu_torch.geometry.body import HumanBody, compute_limb_length

    H, W = cfg.DATASETS.IMAGE_SIZE
    V = item["img"].shape[0]
    gt = np.asarray(item["points-3d"], np.float64)
    body, p = HumanBody(), cfg.PICT_STRUCT
    heatmaps = np.ascontiguousarray(item["heatmap"].transpose(0, 3, 1, 2))

    def run(hm):
        return pictorial.rpsm(
            item["K"].astype(np.float64) @ item["RT"].astype(np.float64), hm,
            center=gt[cfg.KEYPOINT.ROOTIDX],
            boxes=[{"center": np.array([W / 2.0, H / 2.0]),
                    "scale": np.array([W / 200.0, H / 200.0])}] * V,
            body=body, limb_length=compute_limb_length(body, gt), img_size=(W, H),
            grid_size=p.GRID_SIZE, first_nbins=p.FIRST_NBINS, recur_nbins=p.RECUR_NBINS,
            recur_depth=recur_depth, tolerance=p.LIMB_LENGTH_TOLERANCE)

    sample, calls = pictorial._sample_unary, []

    def on_card(hm, grids):
        if hm.device.type != "cuda" or grids.device.type != "cuda":
            raise AssertionError(f"(d) {name}: unary term on {hm.device}, {grids.device}")
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = sample(hm, grids)
        torch.cuda.synchronize(device)
        calls.append(time.perf_counter() - t0)
        close(f"(d) {name} unary", out.cpu(), sample(hm.cpu(), grids.cpu()), **UNARY_TOL)
        return out

    pictorial._sample_unary = on_card
    try:
        t0 = time.perf_counter()
        pose = run(torch.from_numpy(heatmaps).to(device))
        total = time.perf_counter() - t0
    finally:
        pictorial._sample_unary = sample
    if len(calls) != 1 + recur_depth:
        raise AssertionError(f"(d) {name}: {len(calls)} unary terms on the card")
    host = run(heatmaps)
    err = [float(np.linalg.norm(x - gt, axis=-1).mean()) for x in (pose, host)]
    if not np.isfinite(err).all():
        raise AssertionError(f"(d) {name}: RPSM errors {err}")
    return err[0], err[1], bool(np.array_equal(pose, host)), sum(calls), total


def eval_phase(cfg, model, device):
    """The eval engine on `model`: (a)-(f) of the module docstring.
    Returns the forward launches and tiles of (a), and what timing needs."""
    import os

    import numpy as np
    import torch

    from epipolar_transformers_tpu_torch.config import update_from_dict
    from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
    from epipolar_transformers_tpu_torch.engine import tester
    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn

    # one view group a batch (the tester evaluates each batch's first group)
    ecfg = update_from_dict(cfg, {"TEST": {"IMS_PER_BATCH": 1}})

    # (a) test() over ENGINE_GROUPS groups; each group and its host outputs
    # are kept for (b) and (c), corr_pos copied too for the epipolar modes
    seen = []
    process, fetch = tester.process_group, tester.fetch_outputs

    def keep(c, group, out, record, ib=0, dev=None):
        seen.append((group, out))
        return process(c, group, out, record, ib, dev)

    tester.process_group = keep
    tester.fetch_outputs = lambda out, keys: fetch(out, [*keys, "corr_pos"])
    try:
        attn.LAUNCHES = 0
        attn.TILE_COUNTS.clear()
        results = tester.test(ecfg, model, max_batches=ENGINE_GROUPS)
        torch.cuda.synchronize(device)
        launches, tiles = attn.LAUNCHES, attn.tile_counts()
    finally:
        tester.process_group, tester.fetch_outputs = process, fetch
    finite_metrics("(a) pymvg", results)
    if launches != ENGINE_GROUPS or len(seen) != ENGINE_GROUPS:
        raise AssertionError(f"(a) {len(seen)} groups launched the forward kernel "
                             f"{launches} times")
    V = seen[0][0]["img"].shape[0]
    h, w = cfg.KEYPOINT.HEATMAP_SIZE
    check_main_path_tiles("eval", tiles, launches * V * -(-h * w // attn.TILE_QUERIES))
    log(f"  (a) test(), pymvg, {ENGINE_GROUPS} view groups of {V} views: "
        + ", ".join(f"{k} {v:.4g}" for k, v in results.items()))
    log(f"      forward kernel launches {launches} (one per group), forward tiles on the "
        f"tile path / per-query path {tiles[0]} / {tiles[1]}")

    # (b) the other host modes on the same outputs
    line = []
    for mode in ("naive", "refine", "epipolar", "epipolar_dlt"):
        mcfg = update_from_dict(ecfg, {"KEYPOINT": {"TRIANGULATION": mode}})
        record = tester.EvalRecord()
        for ib, (group, out) in enumerate(seen):
            tester.process_group(mcfg, group, out, record, ib)
        finite_metrics(f"(b) {mode}", record.meters.get_all_avg())
        line.append(f"{mode} {record.meters.get_all_avg()['EPEmean_global']:.4g}")
    log("  (b) MPJPE on the same outputs: " + ", ".join(line))

    # (c) ground-truth 2D points, unit scores: a check the weights cannot hide
    line = []
    for mode in ("naive", "refine", "pymvg"):
        mcfg = update_from_dict(ecfg, {"KEYPOINT": {"TRIANGULATION": mode}})
        errs = []
        for group, _ in seen:
            pts = np.asarray(group["points-2d"], np.float64)
            pred = tester._triangulate(mcfg, group, pts, np.ones(pts.shape[:2]), {})
            errs.append(np.linalg.norm(pred - group["points-3d"], axis=-1).mean())
        if not max(errs) < GT_TRIANGULATION_MM:
            raise AssertionError(f"(c) {mode}: MPJPE of ground-truth 2D points {max(errs)} mm")
        line.append(f"{mode} {max(errs):.3g}")
    log(f"  (c) ground-truth 2D points, worst group MPJPE (mm, limit {GT_TRIANGULATION_MM}): "
        + ", ".join(line))

    # (d) RPSM on the card: the flagship group's target heatmaps with the
    # PICT_STRUCT defaults, then the JAX test's own setting against its bar
    p = cfg.PICT_STRUCT
    card_err, host_err, same, card_s, total_s = rpsm_check(
        "flagship", cfg, seen[0][0], device, p.RECUR_DEPTH)
    log(f"  (d) RPSM ({p.FIRST_NBINS}^3 bins, RECUR_DEPTH {p.RECUR_DEPTH}) on the flagship "
        f"group's 64x64 target heatmaps: {1 + p.RECUR_DEPTH} unary terms on the card, each "
        f"within rtol {UNARY_TOL['rtol']} of the host's; mean error {card_err:.3f} mm on the "
        f"card, {host_err:.3f} mm on the host (same pose: {same}); {card_s:.3f} s on the card "
        f"(unary), {total_s - card_s:.3f} s on the host (grids, pairwise terms, tree)")
    small = update_from_dict(cfg, {
        "DATASETS": {"IMAGE_SIZE": (64, 64)},
        "KEYPOINT": {"HEATMAP_SIZE": (16, 16), "SIGMA": 2.0}})
    item = SyntheticMultiview(small, is_train=False, n_samples=1)[0]
    card_err, host_err, same, _, _ = rpsm_check("64 px", small, item, device, RPSM_TEST_DEPTH)
    if not card_err < RPSM_MM:
        raise AssertionError(f"(d) RPSM at the 64 px setting: mean error {card_err} mm")
    log(f"      at tests/test_pictorial.py's setting (64 px, 16x16 heatmaps, RECUR_DEPTH "
        f"{RPSM_TEST_DEPTH}): mean error {card_err:.3f} mm on the card (limit {RPSM_MM}), "
        f"{host_err:.3f} mm on the host (same pose: {same})")

    # (e) TEST.TRAIN_BN and TEST.RECOMPUTE_BN
    before = [b.clone() for b in model.buffers()]

    def unchanged():
        return all(torch.equal(a, b) for a, b in zip(before, model.buffers()))

    for key in ("TRAIN_BN", "RECOMPUTE_BN"):
        r = tester.test(update_from_dict(ecfg, {"TEST": {key: True}}), model, max_batches=2)
        finite_metrics(f"(e) {key}", r)
        if not unchanged():
            raise AssertionError(f"(e) {key}: running statistics changed after test()")
        log(f"  (e) {key}, 2 groups: EPEmean_global {r['EPEmean_global']:.4g}, JDR "
            f"{r['JDR']:.4g}; running statistics bit-equal after test()")
    tester.recompute_bn(ecfg, model, max_batches=2)
    moved = sum(not torch.equal(a, b) for a, b in zip(before, model.buffers()))
    with torch.no_grad():
        for b, a in zip(model.buffers(), before):
            b.copy_(a)
    if not moved:
        raise AssertionError("(e) recompute_bn left every running statistic as it was")
    log(f"  (e) recompute_bn moved {moved} of {len(before)} buffers")

    # (f) the command line in a subprocess
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "epipolar_transformers_tpu_torch.main", "--cfg", CLI_CONFIG,
             "--max-steps", "2", "--max-eval-batches", "2", "OUTPUT_DIR", out_dir],
            cwd=root, capture_output=True, text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULTS: ")]
    found = re.search(r"'EPEmean_global': ([^,}]+)", lines[-1]) if lines else None
    if proc.returncode != 0 or not found or not np.isfinite(float(found.group(1))):
        raise AssertionError(f"(f) CLI rc {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    log(f"  (f) python -m epipolar_transformers_tpu_torch.main --cfg {CLI_CONFIG} --max-steps 2 "
        f"--max-eval-batches 2: rc 0 in {time.perf_counter() - t0:.1f} s; {lines[-1]}")
    return launches, tiles, ecfg, seen


def eval_times(ecfg, model, seen, device) -> None:
    """Where an eval group's time goes: the loader's host ms, the forward
    (device ms with the inputs on the card, host ms to queue it, device ms
    from the host arrays), `process_group`'s host ms under pymvg, `test`'s
    wall per group double-buffered against serial in turns, and the
    device's busy share of one profiled double-buffered `test`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from epipolar_transformers_tpu_torch.data.pipeline import make_eval_loaders
    from epipolar_transformers_tpu_torch.engine import tester

    n = ENGINE_GROUPS
    loader = iter(make_eval_loaders(ecfg)[0])
    t0 = time.perf_counter()
    for _ in range(n):
        next(loader)
    log(f"    loader (render a group's {seen[0][0]['img'].shape[0]} views and their "
        f"neighbours), host: {(time.perf_counter() - t0) * 1e3 / n:.3f} ms per group")

    group = seen[0][0]
    inputs = tester.to_model_inputs(group, device)
    eval_step = tester.make_eval_step(ecfg, model, device)

    def resident():
        with torch.inference_mode():
            return model(inputs)

    resident_ms = cuda_ms(resident)
    t0 = time.perf_counter()
    for _ in range(20):
        resident()
    queue_ms = (time.perf_counter() - t0) * 1e3 / 20
    log(f"    eval forward per group (fused 2N trunk): device {resident_ms:.3f} ms with the "
        f"inputs on the card, host {queue_ms:.3f} ms to queue it; device "
        f"{cuda_ms(lambda: eval_step(group)):.3f} ms from the host arrays")
    host_s = []
    for _ in range(3):
        record = tester.EvalRecord()
        for ib, (g, out) in enumerate(seen):
            t0 = time.perf_counter()
            tester.process_group(ecfg, g, out, record, ib)
            host_s.append(time.perf_counter() - t0)
    log(f"    process_group under pymvg (f64 triangulation, MPJPE, JDR, PCK), host: "
        f"{1e3 * sum(host_s) / len(host_s):.3f} ms per group (mean of {len(host_s)})")

    def drive_ms(double: bool) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tester.test(ecfg, model, max_batches=n, double_buffer=double)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    d1, s1, s2, d2 = drive_ms(True), drive_ms(False), drive_ms(False), drive_ms(True)
    d_ms, s_ms = (d1 + d2) / 2, (s1 + s2) / 2
    log(f"    test() wall per group over {n} groups (data, forward, host half), in turns: "
        f"double-buffered {d_ms:.3f} ms ({1e3 / d_ms:.2f} groups/s; {d1:.3f}, {d2:.3f}), "
        f"serial {s_ms:.3f} ms ({1e3 / s_ms:.2f} groups/s; {s1:.3f}, {s2:.3f})")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = drive_ms(True) * n
    # the device's own events (kernels, copies), not the host ops above them
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3
    log(f"    profiled double-buffered test(): wall {wall:.3f} ms, device busy {busy:.3f} ms "
        f"({busy / n:.3f} ms a group), idle {100 * (1 - busy / wall):.1f}%")


def hourglass_phase(device):
    """[8]: epipolarHG1 as configs/epipolar/synthetic_hg.yaml writes it.
    Returns the main path's launches and tiles and the attention's times."""
    import torch

    from epipolar_transformers_tpu_torch.config import load_config, update_from_dict
    from epipolar_transformers_tpu_torch.engine import tester
    from epipolar_transformers_tpu_torch.models.epipolar import Epipolar
    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn

    cfg = load_config(HG_CONFIG)
    B, C, K = cfg.SOLVER.IMS_PER_BATCH, cfg.KEYPOINT.NFEATS, cfg.EPIPOLAR.SAMPLESIZE
    H, W = cfg.KEYPOINT.HEATMAP_SIZE
    params = Epipolar(cfg).attention_params
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    # channels_last (B, C, H, W) activations viewed as NHWC, as the model
    # hands them over; keys = values one tensor
    f1, f2 = (torch.randn(B, C, H, W, device=device, generator=gen)
              .contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
              for _ in range(2))
    locs = rig_sample_locs(cfg, B, device)
    shape = f"B={B} {H}x{W} K={K} C={C} f32"

    attn.TILE_COUNTS.clear()
    got = attn.epipolar_attention_batch(f1, f2, f2, locs, params)
    tiles = attn.tile_counts()
    want = attn.epipolar_attention_plain_batch(f1, f2, f2, locs, params)
    err = max(close("[8] out", got[0], want[0], **F32_TOL),
              close("[8] depth", got[2], want[2], **F32_TOL))
    agree = agreement("[8] corr_pos", got[1], want[1], 1e-3)
    if not all(torch.equal(a, b) for a, b in
               zip(got, attn.epipolar_attention_batch(f1, f2, f2, locs, params))):
        raise AssertionError("[8] two forward runs on the same inputs differ")
    if sum(tiles) != B * -(-H * W // attn.TILE_QUERIES):
        raise AssertionError(f"[8] forward tiles {tiles}")
    log(f"  attention forward at {shape}, rig locations: max abs err {err:.3g}, corr_pos "
        f"agree {agree:.4f}; two runs bit-equal; forward tiles on the tile path / per-query "
        f"path {tiles[0]} / {tiles[1]}")

    def grads(fn):
        q, kv = f1.detach().clone().requires_grad_(), f2.detach().clone().requires_grad_()
        out = fn(q, kv, kv, locs, params)[0]
        r = torch.randn(out.shape, device=device,
                        generator=torch.Generator(device=device).manual_seed(SEED + 1))
        return torch.autograd.grad((out.float() * r).sum(), (q, kv))

    before = attn.BACKWARD_LAUNCHES
    got_g = grads(attn.epipolar_attention_batch)
    if attn.BACKWARD_LAUNCHES != before + 1:
        raise AssertionError("[8] the backward kernel did not launch once")
    bwd_err = close_grads("[8] keys = values one tensor", list(got_g) + [None],
                          list(grads(attn.epipolar_attention_plain_batch)) + [None],
                          **GRAD_F32_TOL)
    if not all(torch.equal(a, b) for a, b in zip(got_g, grads(attn.epipolar_attention_batch))):
        raise AssertionError("[8] two backward runs on the same inputs differ")
    log(f"  attention backward at {shape}, keys = values one tensor ({H * W}-row key set): "
        f"max abs err {bwd_err:.3g}; two runs bit-equal")

    def backward_only(fn):
        q, kv = f1.detach().clone().requires_grad_(), f2.detach().clone().requires_grad_()
        out = fn(q, kv, kv, locs, params)[0]
        r = torch.randn_like(out)
        return lambda: torch.autograd.grad(out, (q, kv), r, retain_graph=True)

    fk, fp = in_turns(lambda: attn.epipolar_attention_batch(f1, f2, f2, locs, params),
                      lambda: attn.epipolar_attention_plain_batch(f1, f2, f2, locs, params))
    bk, bp = in_turns(backward_only(attn.epipolar_attention_batch),
                      backward_only(attn.epipolar_attention_plain_batch))
    fwd_bound, bwd_bound = bound([f1, f2, f2], locs, False), bound([f1, f2], locs, True)
    log(f"  times (CUDA events, 2x20 calls in turns) at {shape}: forward kernel {fk:.4f} ms, "
        f"plain {fp:.4f} ms, bound {fwd_bound[0]:.4f} ms ({fwd_bound[1]}); backward kernel "
        f"{bk:.4f} ms, plain autograd {bp:.4f} ms, bound {bwd_bound[0]:.4f} ms ({bwd_bound[1]})")

    with tempfile.TemporaryDirectory() as out_dir:
        tcfg = update_from_dict(cfg, {"OUTPUT_DIR": out_dir, "LOG_FREQ": 1,
                                      "TENSORBOARD": {"USE": False}})
        model, _, launches, backward_launches, train_tiles, losses, wall, _ = counted_train(
            "[8]", tcfg, HG_TRAIN_STEPS, device)
    log(f"  train (DEVICE_RENDER on): {HG_TRAIN_STEPS} steps of batch {B} in {wall:.1f} s, loss "
        f"{losses[0]:.5g} -> {losses[-1]:.5g}, all finite; forward kernel launches {launches}, "
        f"backward kernel launches {backward_launches} (one each per step); forward tiles on "
        f"the tile path / per-query path {train_tiles[0]} / {train_tiles[1]}")

    step_parity(cfg, device, per_param=True, hourglass=True)

    ecfg = update_from_dict(cfg, {"TEST": {"IMS_PER_BATCH": 1}})
    attn.LAUNCHES = 0
    attn.TILE_COUNTS.clear()
    results = tester.test(ecfg, model, max_batches=HG_EVAL_GROUPS)
    torch.cuda.synchronize(device)
    eval_launches, eval_tiles = attn.LAUNCHES, attn.tile_counts()
    finite_metrics("[8] test", results)
    if eval_launches != HG_EVAL_GROUPS:
        raise AssertionError(f"[8] {HG_EVAL_GROUPS} groups launched the forward kernel "
                             f"{eval_launches} times")
    log(f"  test(), pymvg, {HG_EVAL_GROUPS} view groups on the trained model: "
        + ", ".join(f"{k} {v:.4g}" for k, v in results.items())
        + f"; forward kernel launches {eval_launches} (one per group, two passes), tiles "
        f"{eval_tiles[0]} / {eval_tiles[1]}")
    return dict(launches=launches + eval_launches, backward_launches=backward_launches,
                tiles=[train_tiles[i] + eval_tiles[i] for i in range(2)],
                entry={"shape": shape, "ms": fk, "plain_ms": fp, "bound_ms": fwd_bound[0],
                       "bound_by": fwd_bound[1], "max_abs_err": err,
                       "tiles": {"tile_path": tiles[0], "per_query_path": tiles[1]}},
                backward_entry={"shape": shape, "ms": bk, "plain_ms": bp,
                                "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
                                "max_abs_err": bwd_err})


def recipe_phase(device):
    """[9]: configs/epipolar/synthetic_zresidual_flagship.yaml as written
    (R-50 in f32, 256 px, batch 16, K=64, DEVICE_RENDER on).  Returns the
    main path's launches and tiles."""
    import numpy as np
    import torch

    from epipolar_transformers_tpu_torch.config import load_config, update_from_dict
    from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
    from epipolar_transformers_tpu_torch.data.pipeline import collate
    from epipolar_transformers_tpu_torch.engine import trainer
    from epipolar_transformers_tpu_torch.engine.tester import to_model_inputs
    from epipolar_transformers_tpu_torch.ops.synthetic_render import (RENDER_PARAM_KEYS,
                                                                       make_batch_renderer)

    cfg = load_config(FLAGSHIP_RECIPE)
    B = cfg.SOLVER.IMS_PER_BATCH

    def items(device_render):
        np.random.seed(SEED)  # the reference view and the augmentation draw from it
        ds = SyntheticMultiview(cfg, is_train=True, n_samples=B, seed=SEED,
                                device_render=device_render)
        t0 = time.perf_counter()
        batch = collate([ds[i] for i in range(B)])
        return batch, (time.perf_counter() - t0) * 1e3

    host, host_ms = items(False)
    light, light_ms = items(True)
    render = make_batch_renderer(cfg)
    upload = to_model_inputs(light, device, ("KRT", "other_KRT", "visibility", *RENDER_PARAM_KEYS))
    got = render(upload)
    line = []
    for k in ("img", "other_img", "heatmap"):
        err = close(f"[9] device-rendered {k}", got[k].permute(0, 2, 3, 1).cpu(),
                    torch.from_numpy(host[k]), rtol=0, atol=RENDER_ATOL)
        line.append(f"{k} {err:.3g}")
    render_ms = cuda_ms(lambda: render(upload))
    log(f"  device render vs host render of the same {B} items, max abs err (atol "
        f"{RENDER_ATOL}): " + ", ".join(line))
    log(f"  render per batch of {B} at 256 px: device {render_ms:.3f} ms (CUDA events); host "
        f"{host_ms:.1f} ms for the items with their pixels, {light_ms:.1f} ms for the "
        f"coordinates only")

    with tempfile.TemporaryDirectory() as out_dir:
        tcfg = update_from_dict(cfg, {"OUTPUT_DIR": out_dir, "LOG_FREQ": 1,
                                      "TENSORBOARD": {"USE": False}})
        model, optimizer, launches, backward_launches, tiles, _, _, _ = counted_train(
            "[9]", tcfg, RECIPE_TRAIN_STEPS, device)
        # the loop as a whole, the rig rendered on the card against the host
        loop_ms = {}
        for on in (True, False):
            lcfg = update_from_dict(tcfg, {"DATALOADER": {"DEVICE_RENDER": on}})
            loop_ms[on] = counted_train(f"[9] DEVICE_RENDER {on}", lcfg, RECIPE_LOOP_STEPS,
                                        device)[-1]

    step = trainer.make_train_step(cfg, model, optimizer)
    inputs = trainer.model_inputs(light, device, render)
    losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: losses.append(step(inputs)["loss"]), iters=RECIPE_TRAIN_STEPS,
                      warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(torch.isfinite(v) for v in losses):
        raise AssertionError(f"[9] losses {losses}")
    log(f"  train(): {RECIPE_TRAIN_STEPS} steps of batch {B}, forward kernel launches "
        f"{launches}, backward kernel launches {backward_launches} (one each per step), "
        f"forward tiles on the tile path / per-query path {tiles[0]} / {tiles[1]}")
    log(f"  train step at batch {B} (forward, backward, adam; device-rendered inputs): "
        f"{step_ms:.3f} ms (CUDA events, mean of {RECIPE_TRAIN_STEPS} after 1), peak memory "
        f"{peak:.3f} GiB, losses {', '.join(f'{float(v):.5g}' for v in losses)}")
    log(f"  train() loop wall per step after the first ({RECIPE_LOOP_STEPS} steps a run; loader, "
        f"upload, render and step): DEVICE_RENDER on {statistics.mean(loop_ms[True]):.3f} ms "
        f"(steps {', '.join(f'{t:.1f}' for t in loop_ms[True])}), off "
        f"{statistics.mean(loop_ms[False]):.3f} ms "
        f"(steps {', '.join(f'{t:.1f}' for t in loop_ms[False])})")
    return launches, backward_launches, tiles


def weight_import_phase(device):
    """[10]: a reference-format checkpoint of R-50 (the state dict that
    tests/test_torch_resnet.py rebuilds from poseresnet50_golden.npz, keys
    under `module.`, wrapped in {'model': ...}) through the command line's
    eval-only path; then a port checkpoint tagged in last_checkpoint wins."""
    import importlib.util
    import os

    import numpy as np
    import torch

    from epipolar_transformers_tpu_torch import main as cli
    from epipolar_transformers_tpu_torch.config import load_config
    from epipolar_transformers_tpu_torch.engine import trainer
    from epipolar_transformers_tpu_torch.utils.checkpoint import Checkpointer

    root = os.path.dirname(os.path.abspath(__file__))
    before = set(sys.modules)
    spec = importlib.util.spec_from_file_location(
        "make_golden_fixtures", os.path.join(root, "scripts", "make_golden_fixtures.py"))
    fixtures = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixtures)
    jax_side = sorted(m for m in set(sys.modules) - before
                      if m.split(".")[0] in ("jax", "flax", "epipolar_transformers_tpu"))
    if jax_side:
        raise AssertionError(f"[10] loading det_tensor imported {jax_side[:5]}")
    g = np.load(os.path.join(root, "tests", "fixtures", "poseresnet50_golden.npz"))
    sd = {}
    for key, shape in zip(g["sd_keys"], g["sd_shapes"]):
        shape = tuple(int(s) for s in str(shape).split("x")) if str(shape) else ()
        sd[str(key)] = torch.as_tensor(np.asarray(fixtures.det_tensor(str(key), shape)))

    captured = []
    test = cli.test

    def keep(c, model, **kw):
        captured.append({k: v.detach().cpu().clone() for k, v in model.state_dict().items()})
        return test(c, model, **kw)

    cli.test = keep
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "reference_r50.pth")
            torch.save({"model": {"module." + k: v for k, v in sd.items()}}, path)
            out = os.path.join(tmp, "out")
            argv = ["--cfg", CLI_CONFIG, "--max-eval-batches", "2", "BACKBONE.BODY",
                    "epipolarposeR-50", "WEIGHTS", path, "WEIGHTS_PREFIX", "module.",
                    "DOTRAIN", "False", "OUTPUT_DIR", out]
            results = cli.main(argv)
            finite_metrics("[10] eval", results)
            state = captured[-1]
            imported = [k for k in sd if not k.endswith("num_batches_tracked")]
            for k in imported:
                if not torch.equal(state["reference." + k], sd[k].to(state["reference." + k].dtype)):
                    raise AssertionError(f"[10] reference.{k} differs from the file")
            kept = sorted(k for k in state if not k.endswith("num_batches_tracked")
                          and k[len("reference."):] not in sd)
            log(f"  main(--cfg {CLI_CONFIG} BACKBONE.BODY epipolarposeR-50 WEIGHTS "
                f"<reference .pth> WEIGHTS_PREFIX module. DOTRAIN False) returned (rc 0): "
                f"{len(imported)} imported keys bit-equal to the file, {len(kept)} kept their "
                f"initial values ({', '.join(kept)}); EPEmean_global "
                f"{results['EPEmean_global']:.4g}")

            cfg = load_config(CLI_CONFIG, argv[4:])
            other = trainer.build_model(cfg.replace(SEED=SEED + 7, WEIGHTS=""), device)
            Checkpointer(out).save("model_000", other, None, epoch=1)
            finite_metrics("[10] eval after the tag", cli.main(argv))
            state = captured[-1]
            for k, v in other.state_dict().items():
                if not torch.equal(state[k], v.cpu()):
                    raise AssertionError(f"[10] {k}: the tagged checkpoint did not win")
            if torch.equal(state["reference.conv1.weight"], sd["conv1.weight"]):
                raise AssertionError("[10] the file's weights survived the tagged checkpoint")
    finally:
        cli.test = test
    log(f"  a port checkpoint tagged in last_checkpoint wins over that cfg.WEIGHTS: all "
        f"{len(state)} keys bit-equal to the tagged checkpoint")


def param_recipe_phase(device):
    """[11](a): configs/epipolar/keypoint_h36m_param.yaml through the
    command line with PARAM_OVERRIDES only (train PARAM_TRAIN_STEPS steps,
    then `test` on PARAM_EVAL_GROUPS groups under RPSM); one f32 step of
    the trained model against the same step through the plain oracle
    route; then ms per train step at batch 16, peak memory, and the pooled
    attention alone.  Returns the times."""
    import numpy as np
    import torch

    from epipolar_transformers_tpu_torch import main as cli
    from epipolar_transformers_tpu_torch.config import load_config
    from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
    from epipolar_transformers_tpu_torch.data.pipeline import collate
    from epipolar_transformers_tpu_torch.engine import trainer
    from epipolar_transformers_tpu_torch.engine.solver import make_optimizer
    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn
    from epipolar_transformers_tpu_torch.ops.epipolar_attention_pooled import \
        epipolar_attention_pooled

    captured, losses = [], []
    make_step, test = trainer.make_train_step, cli.test

    def recording(cfg, model, optimizer):
        step = make_step(cfg, model, optimizer)

        def run(inputs):
            out = step(inputs)
            losses.append(float(out["loss"]))
            return out
        return run

    def keep(c, model, **kw):
        captured.append(model)
        return test(c, model, **kw)

    trainer.make_train_step, cli.test = recording, keep
    try:
        with tempfile.TemporaryDirectory() as out_dir:
            argv = ["--cfg", PARAM_RECIPE, "--max-steps", str(PARAM_TRAIN_STEPS),
                    "--max-eval-batches", str(PARAM_EVAL_GROUPS), *PARAM_OVERRIDES,
                    "OUTPUT_DIR", out_dir]
            attn.LAUNCHES = attn.BACKWARD_LAUNCHES = 0
            t0 = time.perf_counter()
            results = cli.main(argv)
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
    finally:
        trainer.make_train_step, cli.test = make_step, test
    model = captured[-1]
    sampler = model.reference.epipolar_sampler
    if len(losses) != PARAM_TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"(a) train losses {losses}")
    finite_metrics("(a) test", results)
    if sampler.route != "streaming" or attn.LAUNCHES or attn.BACKWARD_LAUNCHES:
        raise AssertionError(f"(a) route {sampler.route}, kernel launches {attn.LAUNCHES}, "
                             f"{attn.BACKWARD_LAUNCHES}")
    cfg = load_config(PARAM_RECIPE, PARAM_OVERRIDES)
    log(f"  (a) main(--cfg {PARAM_RECIPE} " + " ".join(PARAM_OVERRIDES) + " OUTPUT_DIR <tmp>) "
        f"in {wall:.1f} s: the rig's datasets, no ImageNet file, and 17 joints (the rig renders "
        f"any count; RPSM's tree is the 17-joint H36M one); as written R-50, 256 px, batch "
        f"{cfg.SOLVER.IMS_PER_BATCH}, K={cfg.EPIPOLAR.SAMPLESIZE} pooled to "
        f"{cfg.EPIPOLAR.SAMPLESIZE // 2}, C={cfg.KEYPOINT.NFEATS // cfg.EPIPOLAR.BOTTLENECK} after "
        f"the bottleneck, {cfg.KEYPOINT.TRIANGULATION}; attention route {sampler.route} "
        f"(pooled, plain PyTorch: no kernel, {attn.LAUNCHES} launches); {PARAM_TRAIN_STEPS} "
        f"train losses {', '.join(f'{v:.5g}' for v in losses)}; test() on {PARAM_EVAL_GROUPS} "
        f"groups: " + ", ".join(f"{k} {v:.4g}" for k, v in results.items()
                                if not k.startswith("PCK@") or k in ("PCK@5", "PCK@20")))

    B = cfg.SOLVER.IMS_PER_BATCH
    np.random.seed(SEED)
    ds = SyntheticMultiview(cfg, is_train=True, n_samples=B, seed=SEED)
    batch = trainer.model_inputs(collate([ds[i] for i in range(B)]), device, None)
    model.train()

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        loss = model(batch)[0]["loss"]
        loss.backward()
        return loss.item(), {k: p.grad.detach().clone() for k, p in model.named_parameters()
                             if p.grad is not None}

    loss_s, grads_s = loss_and_grads()
    sampler.route = "plain"
    try:
        loss_p, grads_p = loss_and_grads()
    finally:
        sampler.route = "streaming"
    # a gradient below STEP_NOISE_FLOOR of the largest on both routes is a
    # true 0's rounding noise (z's bias feeds a batch-statistics BN; phi's
    # adds one constant to every valid logit of a softmax)
    floor = STEP_NOISE_FLOOR * max(float(g.abs().max()) for g in grads_p.values())
    errs = {k: float((grads_s[k] - g).norm() / g.norm().clamp_min(1e-30))
            for k, g in grads_p.items()
            if max(float(g.abs().max()), float(grads_s[k].abs().max())) >= floor}
    worst = max(errs, key=errs.get)
    if abs(loss_s - loss_p) > STEP_LOSS_RTOL * abs(loss_p) or errs[worst] > STEP_GRAD_REL_L2:
        raise AssertionError(f"(a) step: loss {loss_s} vs {loss_p}, {worst} {errs[worst]:.3g}")
    log(f"  (a) one f32 step of the trained model (batch {B}), its route against the plain "
        f"oracle route (full weight stack): loss {loss_s:.6g} vs {loss_p:.6g}, worst parameter "
        f"gradient relative L2 error {errs[worst]:.3g} ({worst}) over {len(errs)} parameters "
        f"({len(grads_p) - len(errs)} with a true gradient of 0 left out)")

    step = trainer.make_train_step(cfg, model, make_optimizer(cfg, model))
    step_losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: step_losses.append(step(batch)["loss"]), iters=PARAM_TRAIN_STEPS,
                      warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(torch.isfinite(v) for v in step_losses):
        raise AssertionError(f"(a) losses {step_losses}")

    H, W = cfg.KEYPOINT.HEATMAP_SIZE
    C = cfg.KEYPOINT.NFEATS // cfg.EPIPOLAR.BOTTLENECK
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    q, k, v = (torch.randn(B, H, W, C, device=device, generator=gen) for _ in range(3))
    locs = rig_sample_locs(cfg, B, device)
    params = sampler.attention_params
    fwd_ms = cuda_ms(lambda: epipolar_attention_pooled(q, k, v, locs, params, depth="rank"),
                     iters=10)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    r = torch.randn(B, H, W, C, device=device, generator=gen)

    def forward_backward():
        out = epipolar_attention_pooled(*leaves, locs, params, depth="rank")[0]
        torch.autograd.grad(out, leaves, r)

    fb_ms = cuda_ms(forward_backward, iters=10)
    log(f"  (a) train step at batch {B} (forward, backward, adam; host-rendered inputs): "
        f"{step_ms:.3f} ms (CUDA events, mean of {PARAM_TRAIN_STEPS} after 1), peak memory "
        f"{peak:.3f} GiB; the pooled attention alone, B={B} {H}x{W} "
        f"K={cfg.EPIPOLAR.SAMPLESIZE}->{cfg.EPIPOLAR.SAMPLESIZE // 2} C={C} f32, keys and values "
        f"apart: forward {fwd_ms:.3f} ms, forward and backward {fb_ms:.3f} ms")
    return dict(step_ms=step_ms, peak_gib=peak, pooled_ms=fwd_ms, pooled_fwd_bwd_ms=fb_ms)


def prior_phase(cfg, device):
    """[11](b): the kernels with a prior at the flagship attention shape, in
    each prior mode, against the plain version (forward, and the backward's
    gradients to the queries, keys, values and prior); the backward's time
    with and without the prior gradient; then `train` on the flagship with
    EPIPOLAR.PRIOR and one step against the plain path.  Returns the main
    path's launches and tiles and the prior gradient's numbers."""
    import torch

    from epipolar_transformers_tpu_torch.config import update_from_dict
    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn
    from epipolar_transformers_tpu_torch.ops.epipolar_attention import AttentionParams

    s = FLAGSHIP_ATTENTION
    B, H, W, K, C = s["B"], s["H"], s["W"], s["K"], s["C"]
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    locs = rig_sample_locs(cfg, B, device).clone()
    locs[:, :, 0, :DEAD_QUERIES] = -9.0  # queries with every sample out of range
    prior = torch.rand(B, K, H, W, device=device, generator=gen) * 0.1
    f32 = [torch.randn(B, H, W, C, device=device, generator=gen) for _ in range(3)]

    def grads(fn, feats, params):
        leaves = [t.detach().clone().requires_grad_() for t in (*feats, prior)]
        out = fn(*leaves[:3], locs, params, leaves[3])[0]
        r = torch.randn(out.shape, device=device,
                        generator=torch.Generator(device=device).manual_seed(SEED + 1))
        (out.float() * r).sum().backward()
        return [t.grad for t in leaves]

    prior_err = 0.0
    for dt in ("f32", "bf16"):
        feats = f32 if dt == "f32" else [t.to(torch.bfloat16) for t in f32]
        tol, gtol = (F32_TOL, GRAD_F32_TOL) if dt == "f32" else (BF16_TOL, GRAD_BF16_TOL)
        for name, kw in PRIOR_MODES:
            if dt == "bf16" and not kw.get("softmax_enabled", True):
                continue  # a bf16 sim rounding to exactly 0 in one version only ([2]'s rule)
            params = AttentionParams(softmax_scale=cfg.EPIPOLAR.SOFTMAXSCALE, **kw)
            label = f"(b) {dt} {name}"
            got = attn.epipolar_attention_batch(*feats, locs, params, prior)
            want = attn.epipolar_attention_plain_batch(*feats, locs, params, prior)
            e_fwd = max(close(f"{label} out", got[0], want[0], **tol),
                        close(f"{label} depth", got[2], want[2], **tol))
            before = attn.BACKWARD_LAUNCHES
            g = grads(attn.epipolar_attention_batch, feats, params)
            if attn.BACKWARD_LAUNCHES != before + 1:
                raise AssertionError(f"{label}: the backward kernel did not launch once")
            w = [torch.zeros_like(a) if b is None else b
                 for a, b in zip(g, grads(attn.epipolar_attention_plain_batch, feats, params))]
            errs = [close(f"{label} {which}", a, b, gtol["rtol"],
                          gtol["atol"] * max(float(b.float().abs().max()), 1e-30))
                    for which, a, b in zip(("dfeat1", "dother1", "dother2", "dprior"), g, w)]
            if g[3][:, :, 0, :DEAD_QUERIES].abs().max().item() != 0.0:
                raise AssertionError(f"{label}: dprior on the out-of-range queries is not 0")
            if not all(torch.equal(a, b) for a, b in
                       zip(g, grads(attn.epipolar_attention_batch, feats, params))):
                raise AssertionError(f"{label}: two backward runs differ")
            if dt == "f32":
                prior_err = max(prior_err, errs[3])
            log(f"  {label}: forward max abs err {e_fwd:.3g}; backward dfeat1 {errs[0]:.3g}, "
                f"dother1 {errs[1]:.3g}, dother2 {errs[2]:.3g}, dprior {errs[3]:.3g}; dprior "
                f"exactly 0 on the {B * DEAD_QUERIES} queries out of range; two runs bit-equal")

    def backward_only(fn, with_prior):
        f1 = f32[0].clone().requires_grad_()
        f2 = f32[1].clone().requires_grad_()
        pr = prior.clone().requires_grad_(with_prior)
        out = fn(f1, f2, f2, locs, AttentionParams(softmax_scale=cfg.EPIPOLAR.SOFTMAXSCALE), pr)[0]
        r = torch.randn_like(out)
        wrt = (f1, f2, pr) if with_prior else (f1, f2)
        return lambda: torch.autograd.grad(out, wrt, r, retain_graph=True)

    with_ms, without_ms = in_turns(backward_only(attn.epipolar_attention_batch, True),
                                   backward_only(attn.epipolar_attention_batch, False))
    plain_ms = cuda_ms(backward_only(attn.epipolar_attention_plain_batch, True))
    log(f"  (b) attention backward alone, B={B} {H}x{W} K={K} C={C} f32, additive prior, grads "
        f"to queries and keys=values: kernel with the prior gradient {with_ms:.4f} ms, without "
        f"{without_ms:.4f} ms (in turns); plain autograd with it {plain_ms:.4f} ms")

    with tempfile.TemporaryDirectory() as out_dir:
        tcfg = update_from_dict(cfg, {"EPIPOLAR": {"PRIOR": True},
                                      "DATASETS": {"CAMERAS": RIG_CAMERAS},
                                      "OUTPUT_DIR": out_dir, "LOG_FREQ": 1,
                                      "TENSORBOARD": {"USE": False}})
        model, _, launches, backward_launches, tiles, losses, wall, _ = counted_train(
            "[11](b) PRIOR", tcfg, FUSION_TRAIN_STEPS, device)
    table = model.reference.epipolar_sampler.prior
    if table.grad is None or not torch.isfinite(table.grad).all() or \
            float(table.grad.abs().max()) == 0.0:
        raise AssertionError("(b) the prior table's gradient is missing, zero or not finite")
    log(f"  (b) train() on the flagship with EPIPOLAR.PRIOR True DATASETS.CAMERAS "
        f"{RIG_CAMERAS}: {FUSION_TRAIN_STEPS} steps in {wall:.1f} s, losses "
        f"{', '.join(f'{v:.5g}' for v in losses)}; forward kernel launches {launches}, backward "
        f"{backward_launches} (one each per step); tiles {tiles[0]} / {tiles[1]}; the table "
        f"{tuple(table.shape)} got a finite gradient, max |g| {float(table.grad.abs().max()):.3g}")
    step_parity(tcfg, device, per_param=False)
    return dict(launches=launches, backward_launches=backward_launches, tiles=tiles,
                prior_grad={"ms": with_ms, "ms_without_prior_grad": without_ms,
                            "plain_ms": plain_ms, "max_abs_err": prior_err})


def fusion_phase(cfg, device):
    """[11](c): `train` on the flagship with MERGE 'both' (two fusion
    layers, two forward and two backward launches a step); then a step each
    with MERGE 'early', with the reprojection loss, and on epipolarHG1 with
    WARPEDHEATMAP and FIND_CORR 'rgb'.  Returns the main path's launches and
    tiles."""
    from epipolar_transformers_tpu_torch.config import load_config, update_from_dict

    totals = dict(launches=0, backward_launches=0, tiles=[0, 0])
    runs = [
        ("MERGE both", cfg, {"EPIPOLAR": {"MERGE": "both"}}, FUSION_TRAIN_STEPS, 2, ()),
        ("MERGE early", cfg, {"EPIPOLAR": {"MERGE": "early"}}, 1, 1, ()),
        ("REPROJECT_LOSS_WEIGHT 1.0", cfg, {"EPIPOLAR": {"REPROJECT_LOSS_WEIGHT": 1.0}}, 1, 1,
         ("reproject_loss",)),
        # 'rgb' keys are the images: no gradient to them ('other1'); their 3
        # channels take the plain route
        ("epipolarHG1 WARPEDHEATMAP True FIND_CORR rgb OTHER_GRAD ('other2',)",
         load_config(HG_CONFIG), {"EPIPOLAR": {"WARPEDHEATMAP": True, "FIND_CORR": "rgb",
                                               "OTHER_GRAD": ("other2",)}}, 1, 0, ()),
    ]
    for name, base, d, steps, per_step, terms in runs:
        with tempfile.TemporaryDirectory() as out_dir:
            tcfg = update_from_dict(base, {**d, "OUTPUT_DIR": out_dir, "LOG_FREQ": 1,
                                           "TENSORBOARD": {"USE": False}})
            _, _, launches, backward_launches, tiles, losses, wall, _ = counted_train(
                f"[11](c) {name}", tcfg, steps, device, per_step=per_step, terms=terms)
        totals["launches"] += launches
        totals["backward_launches"] += backward_launches
        totals["tiles"] = [a + b for a, b in zip(totals["tiles"], tiles)]
        log(f"  (c) train() with {name}: {steps} step(s) in {wall:.1f} s, losses "
            f"{', '.join(f'{v:.5g}' for v in losses)}" + (f" ({', '.join(terms)} finite)" if terms
                                                          else "")
            + f"; forward kernel launches {launches}, backward {backward_launches} ({per_step} "
            f"each per step); tiles {tiles[0]} / {tiles[1]}")
    return totals


def cli_run(name, argv):
    """The port's command line in this process, with the trainer's step
    log lines collected.  Returns the RESULTS dict, the logged losses, the
    loop's wall ms per step after the first (between two step log lines:
    loader, upload and step), the peak device memory (GiB) and the wall
    seconds."""
    import torch

    from epipolar_transformers_tpu_torch import main as cli
    from epipolar_transformers_tpu_torch.engine import trainer

    messages = _Messages()
    train_log = logging.getLogger(trainer.__name__)
    train_log.addHandler(messages)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        results = cli.main(argv)
    finally:
        train_log.removeHandler(messages)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    logged = [(t, float(m)) for t, msg in zip(messages.times, messages.messages)
              for m in re.findall(r"\bloss (\S+)", msg)]
    losses = [loss for _, loss in logged]
    if not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: train losses {losses}")
    return results, losses, [(b[0] - a[0]) * 1e3 for a, b in zip(logged, logged[1:])], peak, wall


def device_step_ms(cfg, inputs, device, steps: int = 3) -> float:
    """CUDA-event ms per train step (forward, backward, optimizer) of a
    fresh model of `cfg` on `inputs`, after one warm-up step."""
    from epipolar_transformers_tpu_torch.engine import trainer

    model = trainer.build_model(cfg, device)
    step = trainer.make_train_step(cfg, model, trainer.make_optimizer(cfg, model))
    return cuda_ms(lambda: step(inputs), iters=steps, warmup=1)


def rhd_recipes_phase(device):
    """[12](a): the three RHD recipes as written through the command line
    on a fake RHD tree (DatasetCatalog.DATA_DIR pointed at it): train
    LIFTING_TRAIN_STEPS steps, then `_test_lifting` on LIFTING_EVAL_BATCHES
    batches; the host loader's ms per batch; ms per train step and peak
    memory."""
    import os

    import torch

    from epipolar_transformers_tpu_torch.config import DatasetCatalog, load_config
    from epipolar_transformers_tpu_torch.data.pipeline import make_train_loader
    from epipolar_transformers_tpu_torch.engine import trainer

    out = {}
    saved = DatasetCatalog.DATA_DIR
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_fake_rhd(tmp, RHD_ITEMS)
        log(f"  (a) fake RHD tree: {RHD_ITEMS} training and {RHD_ITEMS} evaluation samples of "
            f"320 px PNGs (all five row filters) written in {time.perf_counter() - t0:.1f} s")
        DatasetCatalog.DATA_DIR = tmp
        try:
            cfg = load_config(LIFTING_RECIPES[0])
            batches, loader_ms = iter(make_train_loader(cfg)), []
            for _ in range(LOADER_BATCHES):
                t0 = time.perf_counter()
                batch = next(batches)
                loader_ms.append((time.perf_counter() - t0) * 1e3)
            B = cfg.SOLVER.IMS_PER_BATCH
            log(f"  (a) host loader, batch {B}: {statistics.mean(loader_ms):.1f} ms a batch "
                f"(batches {', '.join(f'{t:.1f}' for t in loader_ms)}; two PNG decodes, the "
                f"crop resized to {cfg.LIFTING.CROP_SIZE} px and 21 scoremaps of "
                f"{cfg.KEYPOINT.HEATMAP_SIZE} an item)")
            out["loader_ms_per_batch"] = statistics.mean(loader_ms)
            for recipe in LIFTING_RECIPES:
                name = os.path.splitext(os.path.basename(recipe))[0]
                argv = ["--cfg", recipe, "--max-steps", str(LIFTING_TRAIN_STEPS),
                        "--max-eval-batches", str(LIFTING_EVAL_BATCHES), "LOG_FREQ", "1",
                        "TENSORBOARD.USE", "False", "OUTPUT_DIR", os.path.join(tmp, name)]
                results, losses, loop_ms, peak, wall = cli_run(f"[12](a) {name}", argv)
                keys = {"EPEmean_can"} | ({"EPEmean"} if "rot" in name else set())
                if not keys <= set(results) or not all(math.isfinite(v)
                                                       for v in results.values()):
                    raise AssertionError(f"[12](a) {name}: RESULTS {results}")
                rcfg = load_config(recipe)
                inputs = trainer.model_inputs(batch, device, None)
                ms = device_step_ms(rcfg, inputs, device)
                out[name] = {"ms_per_step": ms, "loop_ms_per_step": statistics.mean(loop_ms),
                             "peak_gib": peak, **{k: results[k] for k in sorted(keys)}}
                log(f"  (a) {recipe} ({rcfg.DATASETS.TASK}"
                    + (f", {rcfg.BACKBONE.BODY}" if rcfg.DATASETS.TASK == "img_lifting_rot"
                       else "") + f", batch {B}) through the command line in {wall:.1f} s: "
                    f"losses {', '.join(f'{v:.5g}' for v in losses)}; RESULTS "
                    + ", ".join(f"{k} {results[k]:.4f}" for k in sorted(keys))
                    + f" (finite); train step {ms:.3f} ms (CUDA events), loop wall "
                    f"{statistics.mean(loop_ms):.1f} ms a step after the first; peak memory "
                    f"{peak:.3f} GiB")
                del inputs
                torch.cuda.empty_cache()
        finally:
            DatasetCatalog.DATA_DIR = saved
    return out


def multiview_lifting_phase(cfg, device):
    """[12](b): multiview_img_lifting_rot at the flagship's widths
    (epipolarposeR-50, 256 px, bf16 convolutions, 64x64, K=64, 17 joints,
    batch 8) on the synthetic rig's images and cameras, lifting targets
    from SEED: three train steps through `make_train_step` (the main path,
    one forward and one backward kernel launch a step); one step kernel
    path against plain path ([6]'s limits); the fusion BN's scale gets a
    gradient; no gradient reaches `other_img`; ms per step and peak memory."""
    import numpy as np
    import torch

    from epipolar_transformers_tpu_torch.config import update_from_dict
    from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
    from epipolar_transformers_tpu_torch.data.pipeline import collate
    from epipolar_transformers_tpu_torch.engine import trainer
    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn

    mcfg = update_from_dict(cfg, {"DATASETS": {"TASK": "multiview_img_lifting_rot"},
                                  "LIFTING": {"ENABLED": True},
                                  "SOLVER": {"IMS_PER_BATCH": BENCH_BATCH}})
    B, J = BENCH_BATCH, mcfg.KEYPOINT.NUM_PTS
    np.random.seed(SEED)
    ds = SyntheticMultiview(mcfg, is_train=True, n_samples=B, seed=SEED)
    host = collate([ds[i] for i in range(B)])
    rng = np.random.RandomState(SEED)
    rotations = [np.linalg.qr(rng.randn(3, 3))[0] for _ in range(B)]
    host.update({"can-points-3d": rng.randn(B, J, 3).astype(np.float32),
                 "normed-points-3d": rng.randn(B, J, 3).astype(np.float32),
                 "rotation": np.stack([q * np.sign(np.linalg.det(q)) for q in rotations]
                                      ).astype(np.float32)})
    inputs = trainer.model_inputs(host, device, None)
    model = trainer.build_model(mcfg, device)
    randomize(model, torch.cat([inputs["img"], inputs["other_img"]]), SEED)
    step = trainer.make_train_step(mcfg, model, trainer.make_optimizer(mcfg, model))

    attn.LAUNCHES = attn.BACKWARD_LAUNCHES = 0
    attn.TILE_COUNTS.clear()
    losses = [step(inputs) for _ in range(3)]
    torch.cuda.synchronize()
    launches, backward_launches = attn.LAUNCHES, attn.BACKWARD_LAUNCHES
    tiles = attn.tile_counts()
    if not launches == backward_launches == 3:
        raise AssertionError(f"[12](b) 3 steps launched the forward kernel {launches} and the "
                             f"backward kernel {backward_launches} times")
    if not all(bool(torch.isfinite(v).all()) for m in losses for v in m.values()):
        raise AssertionError(f"[12](b) losses {losses}")
    h, w = mcfg.KEYPOINT.HEATMAP_SIZE
    check_main_path_tiles("[12](b) train", tiles, launches * B * -(-h * w // attn.TILE_QUERIES))
    log(f"  (b) multiview_img_lifting_rot (epipolarposeR-50, 256 px, bf16 convolutions, "
        f"{h}x{w}, K={mcfg.EPIPOLAR.SAMPLESIZE}, {J} joints, batch {B}): 3 train steps, losses "
        + ", ".join(f"{float(m['loss']):.5g} (xyz {float(m['xyz_loss']):.4g}, rot "
                    f"{float(m['rot_loss']):.4g})" for m in losses)
        + f"; forward kernel launches {launches}, backward kernel launches {backward_launches} "
        f"(one each a step); tiles {tiles[0]} / {tiles[1]}")

    grads = compare_step_paths("[12](b) bf16 multiview_img_lifting_rot", model, inputs,
                               per_param=False)
    bn_grad = grads.get("reference.epipolar_sampler.bn.weight")
    if bn_grad is None or not bool(torch.isfinite(bn_grad).all()) or \
            float(bn_grad.abs().max()) == 0.0:
        raise AssertionError("[12](b) the epipolar sampler's BN scale got no gradient")
    other = inputs["other_img"].clone().requires_grad_()
    model.zero_grad(set_to_none=True)
    model({**inputs, "other_img": other})[0]["loss"].backward()
    if other.grad is not None:
        raise AssertionError("[12](b) a gradient reached other_img through the sibling")
    log(f"  (b) the epipolar sampler's BN scale gradient max |g| "
        f"{float(bn_grad.abs().max()):.4g}; no gradient reaches other_img (the sibling runs "
        f"under no-grad)")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(inputs), iters=5, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  (b) train step at batch {B} (forward, backward, adam): {ms:.3f} ms (CUDA events, "
        f"mean of 5 after 1), peak memory {peak:.3f} GiB")
    return dict(launches=launches, backward_launches=backward_launches, tiles=tiles,
                entry={"ms_per_step": ms, "peak_gib": peak})


def keypoint_phase(device):
    """[12](c): the single-view keypoint task (poseR-50, 256 px, batch 8) on
    the flagship recipe's synthetic rig through the command line: train
    KEYPOINT_STEPS steps, then `test` under pymvg on KEYPOINT_EVAL_GROUPS
    groups; no attention kernel runs."""
    import numpy as np

    from epipolar_transformers_tpu_torch.config import load_config
    from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
    from epipolar_transformers_tpu_torch.data.pipeline import collate
    from epipolar_transformers_tpu_torch.engine import trainer
    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn
    from epipolar_transformers_tpu_torch.ops.synthetic_render import make_batch_renderer

    with tempfile.TemporaryDirectory() as out_dir:
        argv = ["--cfg", FLAGSHIP_RECIPE, "--max-steps", str(KEYPOINT_STEPS),
                "--max-eval-batches", str(KEYPOINT_EVAL_GROUPS), *KEYPOINT_OVERRIDES,
                "LOG_FREQ", "1", "TENSORBOARD.USE", "False", "OUTPUT_DIR", out_dir]
        attn.LAUNCHES = attn.BACKWARD_LAUNCHES = 0
        results, losses, loop_ms, peak, wall = cli_run("[12](c) keypoint", argv)
    if attn.LAUNCHES or attn.BACKWARD_LAUNCHES:
        raise AssertionError("[12](c) the single-view task launched an attention kernel")
    finite_metrics("[12](c) keypoint", results)
    kcfg = load_config(FLAGSHIP_RECIPE, KEYPOINT_OVERRIDES)
    B = kcfg.SOLVER.IMS_PER_BATCH
    np.random.seed(SEED)
    ds = SyntheticMultiview(kcfg, is_train=True, n_samples=B, seed=SEED, device_render=True)
    inputs = trainer.model_inputs(collate([ds[i] for i in range(B)]), device,
                                  make_batch_renderer(kcfg))
    ms = device_step_ms(kcfg, inputs, device)
    log(f"  (c) {FLAGSHIP_RECIPE} with {' '.join(KEYPOINT_OVERRIDES)} through the command "
        f"line in {wall:.1f} s: losses {', '.join(f'{v:.5g}' for v in losses)}; "
        f"EPEmean_global (MPJPE) {results['EPEmean_global']:.4f} mm, JDR "
        f"{results['JDR']:.4f} over {KEYPOINT_EVAL_GROUPS} groups (pymvg), all finite; train "
        f"step {ms:.3f} ms (CUDA events, device-rendered inputs), loop wall "
        f"{statistics.mean(loop_ms):.1f} ms a step after the first; peak memory {peak:.3f} GiB")
    return {"ms_per_step": ms, "loop_ms_per_step": statistics.mean(loop_ms), "peak_gib": peak,
            "MPJPE": results["EPEmean_global"], "JDR": results["JDR"]}


def lifting_net_phase(device):
    """[12](d): LiftingNet of each task on the card against the same module
    on the CPU, eval mode, f32 (TF32 off): the RHD recipes' widths (224 px
    heatmaps, 21 joints, image features of R-50's 2048) and the flagship's
    for multiview_img_lifting_rot (64x64, 17 joints); then a hand3d TF
    pickle written from SEED imported through cfg.WEIGHTS, with the same
    outputs on both devices."""
    import copy
    import os
    import pickle

    import numpy as np
    import torch

    from epipolar_transformers_tpu_torch.config import Config, update_from_dict
    from epipolar_transformers_tpu_torch.models import ModelBuilder
    from epipolar_transformers_tpu_torch.models.lifting import LiftingNet
    from epipolar_transformers_tpu_torch.utils.pretrained import apply_pretrained

    gen = torch.Generator().manual_seed(SEED)
    B, errs = BENCH_BATCH, {}
    hand = torch.tensor([0, 1] * (B // 2), dtype=torch.int32)
    cases = [("lifting_direct", (224, 224), 21), ("lifting_rot", (224, 224), 21),
             ("keypoint_lifting_rot", (224, 224), 21), ("img_lifting_rot", None, 21),
             ("multiview_img_lifting_rot", (64, 64), 17)]
    for task, hm, joints in cases:
        lcfg = update_from_dict(Config(), {
            "DATASETS": {"TASK": task}, "LIFTING": {"ENABLED": True, "FLIP_ON": True},
            "KEYPOINT": {"NUM_PTS": joints, "HEATMAP_SIZE": hm or (224, 224)}})
        side = task != "multiview_img_lifting_rot"
        net = LiftingNet(lcfg, in_features=2048, hand_side=side)
        net.init_weights(gen)
        net.eval()
        x = torch.randn(B, 2048, generator=gen) if hm is None else \
            torch.rand(B, joints, *hm, generator=gen)
        with torch.no_grad():
            want = net(x, hand if side else None)
            got = copy.deepcopy(net).to(device)(x.to(device), hand.to(device) if side else None)
        errs[task] = max(close(f"[12](d) {task} output {i}", g.cpu(), w, **LIFTING_NET_TOL)
                         for i, (g, w) in enumerate(zip(got, want)) if w is not None)
    log(f"  (d) LiftingNet on the card vs the CPU, f32, batch {B}, max abs err (rtol "
        f"{LIFTING_NET_TOL['rtol']}, atol {LIFTING_NET_TOL['atol']}): "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "hand3d.pickle")
        write_hand3d_pickle(path, np.random.RandomState(SEED), hw=4 * 4, side=2)
        pcfg = update_from_dict(Config(), {
            "DATASETS": {"TASK": "lifting_rot"}, "LIFTING": {"ENABLED": True},
            "KEYPOINT": {"NUM_PTS": 21, "HEATMAP_SIZE": (224, 224)},
            "DATASET_FAMILY": "rhd", "WEIGHTS": path})
        model = ModelBuilder(pcfg)
        model.init_weights(gen)
        if not apply_pretrained(pcfg, model):
            raise AssertionError("[12](d) the TF pickle was not imported")
        with open(path, "rb") as f:
            first = torch.from_numpy(pickle.load(f)["PosePrior/conv_pose_0_1/weights"])
        first = first.permute(3, 2, 0, 1)  # HWCN -> OIHW
        if not torch.equal(model.liftingnet.conv1[0].weight, first):
            raise AssertionError("[12](d) conv_pose_0_1 did not land in liftingnet.conv1.0")
    model.eval()
    x = torch.rand(B, 21, 224, 224, generator=gen)
    inputs = {"heatmap": x, "hand-side": hand, "visibility": torch.ones(B, 21),
              "can-points-3d": torch.zeros(B, 21, 3), "normed-points-3d": torch.zeros(B, 21, 3),
              "rotation": torch.eye(3).repeat(B, 1, 1)}
    with torch.no_grad():
        want = model(inputs)[2]
        got = copy.deepcopy(model).to(device)({k: v.to(device) for k, v in inputs.items()})[2]
    errs["tf_pickle"] = max(close(f"[12](d) TF pickle {k}", got[k].cpu(), v, **LIFTING_NET_TOL)
                            for k, v in want.items())
    log(f"  (d) a hand3d TF pickle written from seed {SEED} through cfg.WEIGHTS "
        f"(lifting_rot): imported (conv_pose_0_1 bit-equal in liftingnet.conv1.0), card vs CPU "
        f"max abs err {errs['tf_pickle']:.3g}")
    return errs


def lifting_phase(cfg, device):
    """[12]: the lifting and single-view tasks on the card."""
    return {"rhd_recipes": rhd_recipes_phase(device),
            "multiview_img_lifting_rot": multiview_lifting_phase(cfg, device),
            "keypoint": keypoint_phase(device),
            "lifting_net_max_abs_err": lifting_net_phase(device)}


def live_pairs(locs, distinct: bool = True) -> int:
    """The (query, key row) pairs that the bilinear corners with a non-zero
    weight touch at these locations: distinct per query, or every corner
    hit (distinct=False; two samples of a line often share a row)."""
    import torch

    from epipolar_transformers_tpu_torch.ops.epipolar_attention_cuda import _corners

    B, K, H, W, _ = locs.shape
    rows, wc = _corners(locs.reshape(B, K, H * W, 2), H, W)
    rows = torch.where(wc != 0, rows, -1).reshape(B, H * W, K * 4)
    if not distinct:
        return int((rows >= 0).sum())
    rows = torch.sort(rows, dim=-1).values
    new = torch.ones_like(rows, dtype=torch.bool)
    new[..., 1:] = rows[..., 1:] != rows[..., :-1]
    return int((new & (rows >= 0)).sum())


def bound(feats, locs, backward: bool, distinct: bool = True, prior: bool = False):
    """(ms, "operations" or "bytes"): the least time the card could take for
    the attention forward (queries, keys, values) or backward (queries and
    keys = values one tensor, all gradients) on these f32 inputs.  The
    operations count 2C flops per distinct live (query, key row) pair at
    these locations (the least work any implementation must do; with
    distinct=False per live corner hit, as PR 1-3 counted) for each time
    the function reads that row: the forward twice (similarity, output), the
    backward five times (similarity, g, dfeat1, and the key and value
    gradients).  The bytes read each input once (a tensor passed as both
    keys and values is one input) and write each output once; `prior` adds
    the (B, K, HW) f32 prior read and, in the backward, its gradient
    written."""
    B, K, H, W, _ = locs.shape
    C = feats[0].shape[-1]
    flops = live_pairs(locs, distinct) * 2 * C * (5 if backward else 2)
    feature = B * H * W * C * 4
    # inputs (features, locations; the backward's dout) and outputs (out and
    # depth; the backward's dfeat1 and keys' = values' gradient)
    nbytes = len({f.data_ptr() for f in feats}) * feature + locs.numel() * 4 + (
        3 * feature if backward else feature + B * K * H * W * 4)
    if prior:
        nbytes += B * K * H * W * 4 * (2 if backward else 1)
    t_ops, t_bytes = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def peak_step_memory(train_step, plain: bool) -> float:
    """Peak device memory of one train step, GiB."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train_step(plain)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2 ** 30


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a GPU",
              file=sys.stderr)
        return 2
    from epipolar_transformers_tpu_torch.config import flagship_cfg
    from epipolar_transformers_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.load_library("epipolar_attention")
    log(f"    kernel build and load {time.perf_counter() - t0:.1f} s")

    cfg = flagship_cfg()
    log("[2] attention kernel vs plain version")
    err, (f32, rig, rand_locs, params) = attention_phase(cfg, device)

    log("[3] slice: flagship multiview inference")
    launches, slice_tiles, forward, slice_model = slice_phase(cfg, device)

    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn

    log(f"[4] times (CUDA events, mean of 2x20 calls in turns), {card}")
    k_ms, p_ms = in_turns(lambda: attn.epipolar_attention_batch(*f32, rig, params),
                          lambda: attn.epipolar_attention_plain_batch(*f32, rig, params))
    log(f"    attention alone, B=8 64x64 K=64 C=256 f32: kernel {k_ms:.4f} ms, "
        f"plain {p_ms:.4f} ms" + ("  (kernel SLOWER)" if k_ms > p_ms else ""))
    ke_ms, pe_ms = in_turns(lambda: attn.epipolar_attention_batch(*f32, rand_locs, params),
                            lambda: attn.epipolar_attention_plain_batch(*f32, rand_locs, params))
    log(f"    attention alone, same shape f32, edge-crossing locs (per-query kernel): "
        f"kernel {ke_ms:.4f} ms, plain {pe_ms:.4f} ms"
        + ("  (kernel SLOWER)" if ke_ms > pe_ms else ""))
    bf16 = [t.to(torch.bfloat16) for t in f32]
    kb_ms, pb_ms = in_turns(lambda: attn.epipolar_attention_batch(*bf16, rig, params),
                            lambda: attn.epipolar_attention_plain_batch(*bf16, rig, params))
    log(f"    attention alone, same shape bf16: kernel {kb_ms:.4f} ms, plain {pb_ms:.4f} ms"
        + ("  (kernel SLOWER)" if kb_ms > pb_ms else ""))
    sk_ms, sp_ms = in_turns(lambda: forward(False), lambda: forward(True), iters=10)
    log(f"    slice forward, batch {BENCH_BATCH}: kernel path {sk_ms:.3f} ms "
        f"({BENCH_BATCH * 1000 / sk_ms:.1f} frames/s), plain path {sp_ms:.3f} ms "
        f"({BENCH_BATCH * 1000 / sp_ms:.1f} frames/s)")
    del bf16, forward

    log("[5] attention backward kernel vs autograd of the plain version")
    bwd_err = backward_phase(cfg, device)

    log("[6] training slice: engine.trainer.train on the flagship config")
    train_launches, backward_launches, train_tiles, train_step = train_phase(cfg, device)

    log(f"[4] times, continued after [6]: backward and train step, {card}")

    # the backward alone: autograd.grad over a graph built once, queries
    # and keys = values as in the model (OTHER_GRAD), f32 as the slice feeds it
    def backward_only(fn, need_kv=True):
        f1 = f32[0].clone().requires_grad_()
        f2 = f32[1].clone().requires_grad_(need_kv)
        out = fn(f1, f2, f2, rig, params)[0]
        r = torch.randn_like(out)
        wrt = (f1, f2) if need_kv else (f1,)
        return lambda: torch.autograd.grad(out, wrt, r, retain_graph=True)

    kbw_ms, pbw_ms = in_turns(backward_only(attn.epipolar_attention_batch),
                              backward_only(attn.epipolar_attention_plain_batch))
    log(f"    attention backward alone, B=8 64x64 K=64 C=256 f32, grads to queries and "
        f"keys=values: kernel {kbw_ms:.4f} ms, plain autograd {pbw_ms:.4f} ms"
        + ("  (kernel SLOWER)" if kbw_ms > pbw_ms else ""))
    # the same without the key/value gradients: the query pass alone
    kq_ms, pq_ms = in_turns(backward_only(attn.epipolar_attention_batch, need_kv=False),
                            backward_only(attn.epipolar_attention_plain_batch, need_kv=False))
    log(f"    attention backward, query gradient only (keys and values detached): "
        f"kernel {kq_ms:.4f} ms, plain autograd {pq_ms:.4f} ms")
    tk_ms, tp_ms = in_turns(lambda: train_step(False), lambda: train_step(True), iters=10)
    log(f"    train step (forward, backward, adam), batch {BENCH_BATCH}: kernel path "
        f"{tk_ms:.3f} ms, plain path {tp_ms:.3f} ms")
    mem_k, mem_p = peak_step_memory(train_step, False), peak_step_memory(train_step, True)
    log(f"    train step peak memory (max_memory_allocated): kernel path {mem_k:.3f} GiB, "
        f"plain path {mem_p:.3f} GiB")

    log("[7] eval engine: engine.tester.test and the command line on the flagship config")
    eval_launches, eval_tiles, ecfg, seen = eval_phase(cfg, slice_model, device)

    log(f"[4] times, continued after [7]: the eval engine, {card}")
    eval_times(ecfg, slice_model, seen, device)
    launches += eval_launches
    del slice_model, seen
    fwd_bound = bound(f32, rig, backward=False)
    prior_bound = bound(f32[:2], rig, backward=True, prior=True)
    bwd_bound = bound(f32[:2], rig, backward=True)
    fwd_hits, bwd_hits = (bound(f, rig, b, distinct=False)[0]
                          for f, b in ((f32, False), (f32[:2], True)))
    log(f"    bounds at these inputs: forward {fwd_bound[0]:.4f} ms, backward "
        f"{bwd_bound[0]:.4f} ms (set by {fwd_bound[1]}, {bwd_bound[1]}; "
        f"{live_pairs(rig)} distinct live (query, key row) pairs; counted per live "
        f"corner hit, {live_pairs(rig, False)} of them, as before: {fwd_hits:.4f} and "
        f"{bwd_hits:.4f} ms)")

    log(f"[8] epipolarHG1 as {HG_CONFIG} writes it (64 px, NFEATS 128, K=16, 16x16, "
        f"5 joints, batch 16, DEVICE_RENDER on), {card}")
    hg = hourglass_phase(device)
    log(f"[9] the flagship recipe as written: {FLAGSHIP_RECIPE} (R-50 f32, 256 px, K=64, "
        f"batch 16, DEVICE_RENDER on), {card}")
    recipe_launches, recipe_backward, recipe_tiles = recipe_phase(device)
    log("[10] weight import through the command line")
    weight_import_phase(device)
    log(f"[11] the other attention configs: the param recipe, the learned prior through "
        f"the kernels, MERGE early/both, the reprojection loss, {card}")
    param = param_recipe_phase(device)
    prior = prior_phase(cfg, device)
    fusion = fusion_phase(cfg, device)
    log(f"[12] the lifting and single-view tasks: the RHD recipes, multiview_img_lifting_rot, "
        f"keypoint, LiftingNet on the card, {card}")
    lifting = lifting_phase(cfg, device)
    extra = [prior, fusion, lifting["multiview_img_lifting_rot"]]

    log(json.dumps({"kernels": [{
        "name": "epipolar_attention", "route": "cuda",
        "source": "epipolar_transformers_tpu_torch/csrc/epipolar_attention.cu",
        "replaces": REPLACES,
        "launches": (launches + train_launches + hg["launches"] + recipe_launches
                     + sum(e["launches"] for e in extra)),
        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": fwd_bound[0],
        "bound_by": fwd_bound[1], "library_ms": None, "main_path_tiles": {
            "tile_path": (slice_tiles[0] + train_tiles[0] + eval_tiles[0] + hg["tiles"][0]
                          + recipe_tiles[0] + sum(e["tiles"][0] for e in extra)),
            "per_query_path": (slice_tiles[1] + train_tiles[1] + eval_tiles[1]
                               + hg["tiles"][1] + recipe_tiles[1]
                               + sum(e["tiles"][1] for e in extra))},
        "hourglass_shape": hg["entry"],
    }, {
        "name": "epipolar_attention_backward", "route": "cuda",
        "source": "epipolar_transformers_tpu_torch/csrc/epipolar_attention.cu",
        "replaces": BACKWARD_REPLACES,
        "launches": (backward_launches + hg["backward_launches"] + recipe_backward
                     + sum(e["backward_launches"] for e in extra)),
        "max_abs_err": bwd_err, "ms": kbw_ms, "plain_ms": pbw_ms, "bound_ms": bwd_bound[0],
        "bound_by": bwd_bound[1], "library_ms": None,
        "hourglass_shape": hg["backward_entry"],
        "prior_gradient": {**prior["prior_grad"], "bound_ms": prior_bound[0],
                           "bound_by": prior_bound[1]},
    }], "param_recipe": param, "lifting_tasks": {
        k: {kk: vv for kk, vv in v.items() if kk not in ("launches", "backward_launches", "tiles")}
        if k == "multiview_img_lifting_rot" else v for k, v in lifting.items()}}))
    jax_side = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "flax", "epipolar_transformers_tpu"))
    if jax_side:
        raise AssertionError(f"the port imported {jax_side[:5]}")
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
