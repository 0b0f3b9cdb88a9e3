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
     the same outputs on both devices;
 13. the flagship recipe on H36M-layout data: (a) a fake H36M tree
     (`write_fake_h36m`: 8 train and 4 validation groups of 4 views,
     1002x1000 JPEG frames written by the port's encoder, images.zip and
     undistoredimages.zip); (b) one item in each DATA_FORMAT (zip bit-equal
     to jpg, undistoredzip within tests/test_fake_h36m.py's mean of jpg) and
     the host ms of one frame's read and decode, undistortion, warp and
     heatmaps; (c) configs/epipolar/fake_h36m_zresidual.yaml as written
     (R-50 f32, 256 px, K=64, batch 8, NUM_WORKERS 4 loader processes)
     through the command line: 3 train steps and `test` on 2 groups under
     pymvg, both attention kernels launched, finite losses, MPJPE and JDR;
     the loader's wall per batch, the device step, the loop's wall per step
     and the peak memory; (d) neither cv2 nor PIL imported.
 14. the ResNet-152 recipes as written on a fake H36M tree (40 train and 72
     validation groups of 1002x1000 JPEG frames, 4 and 2 of them distinct,
     and a seeded random torchvision-layout R-152 where the `_8gpu` recipes
     read it), their command lines in processes of their own started in
     the tree's directory (the torchrun rank in one, the others one after
     another in another): (a) keypoint_h36m_resnet152_384_fixed.yaml (batch 8,
     384 px, 96x96, K=64): 3 steps and 2 eval groups, the device ms a step
     (CUDA events), the loop's wall and the loader's share, the peak, both
     kernels' launches and the tiles on each path, finite MPJPE and JDR;
     then the attention alone at B=8 96x96 K=64 C=256 on that run's sample
     locations, forward and backward against the plain version ([2]/[5]'s
     tolerances), times and bounds; (b) ..._384_fixed_8gpu.yaml at its
     global batch of 32 under `torchrun --nproc_per_node 1 ... --multihost`
     (NCCL, world 1: DDP and BatchNorm's all-reduces run, as on each rank
     of eight; each step an epoch, rank 0's checkpoint and eval between
     them) beside the same without --multihost; (c) the same recipe
     at a batch of 8 through one rank here and through 2 ranks x 4 on the
     one card over gloo (processes this script starts, which make the gloo
     group themselves): the ranks' mean loss, the all-reduced gradients and
     the BN running statistics against the one rank's, the model's and each
     parameter's gradient within the train-step parity's 2e-2, and the
     ranks' parameters bit-equal after 3 steps; (d) ..._320_fixed_8gpu.yaml (batch 32, 80x80) and
     keypoint_h36m_resnet50_384_strong_fixed.yaml (K=85): a step and an
     eval group each, and the attention alone at their shapes.  Every child
     must exit 0 and leave no process in its session.
 15. the fifteen recipes no card had run, as written (the batch, size, K,
     TOPK, MAPPING, DATA_FORMAT, workers and triangulation of each YAML),
     on a fake H36M tree (160 train, 72 validation groups), a fake RHD tree
     and a seeded pose-ResNet-152 at the pretrained recipes'
     datasets/pose_resnet_4.5_pixels_human36m.pth, their command lines
     one after another in one process of their own started in the trees'
     directory: 2 steps (3 for RHD) and 2 eval groups each, the device ms
     a step, the peak, the loop's wall and the loader's share,
     `profile_model`'s FLOPs an item and the step's TFLOP/s, both kernels'
     launches and tiles, and finite metrics; seven stop with the error
     that the CPU tests pin in both packages (C17-C19).  Then both
     kernels against their plain versions at 96x96 on the 19 mm recipe's
     sample locations ([14](a)'s tolerances, times, bounds); the 19 mm
     recipe's eval on one group, kernel route against plain route
     (corr_pos, and the 3D of its epipolar triangulation); and the
     tooling: (a) `_384_aug`'s run is under --trace, whose trace must name
     every hand kernel, with the device's busy share over the traced
     steps; (b) VIS.FLOPS on the flagship (the same count on the card and
     the host) and on the 384 fixed recipe; (c) DATALOADER.BENCHMARK of
     keypoint_h36m_zresidual_fixed.yaml with its 15 workers, every stage's
     ms nonzero; (d) that recipe's event files, read back, against its
     logged values.
 16. the last modules, on the flagship: (a) its weights (the seeded
     initial ones, every BN's statistics and the fusion BN's scale moved
     by seeded noise) packed as a JAX checkpoint (flax msgpack `.ckpt`,
     utils/flax_msgpack.py) and loaded through cfg.WEIGHTS into a model
     drawn from another seed: every tensor bit-equal, and both models'
     heatmaps at batch 8 bit-equal through the forward kernel; (b)
     configs/epipolar/synthetic_zresidual_flagship.yaml with DTYPE
     bfloat16 and that `.ckpt` through the command line, `test` on
     VIS_GROUPS groups with VIS.VIDEO and SAVE_PRED: one forward launch a
     group, the PNG frames and the AVI that the dispatch assembles, read
     back bit-equal to them; (c) VIDEO_GT (no forward) and its AVI,
     EPIPOLAR_LINE on the card (17 heatmap channels: the plain route, no
     launch), AUC and POINTCLOUD on (b)'s files, and the score panel
     where matplotlib imports (a line says whether it does); (d) the
     batched triangulation (geometry/triangulate.py) on the card in f64:
     pymvg on (b)'s saved predictions within 1e-4 mm of the host copy,
     and the ground-truth 2D points through naive (a torch generator on
     the card), refine and pymvg within 0.1 mm; (e) `graft_entry.entry()`
     on cuda:0 bit-equal to the builder at the same weights.

The line before the card line is a JSON object with both kernels'
launches on the main path (phases 3, 6, 7(a), 8, 9, 11, 12(b), 13(c), 14, 15 and 16), errors and times,
each entry's `hourglass_shape` times at [8]'s shape, `r152_shapes` at
[14]'s (96x96 K=64, 80x80 K=64, 96x96 K=85) and `a11d_19mm_shape` at
[15]'s 19 mm recipe's locations, and each kernel's
bound: the larger of its
operations over the f32 rate outside the tensor cores and its bytes (each
input read once, a tensor passed as keys and values once, each output
written once) over the memory rate, counted
from this run's inputs (the operations per distinct live (query, key row)
pair).  The forward's entry also holds `main_path_tiles`, its tiles on
each path over the forwards of phases 3, 6, 7(a), 8, 9, 11, 12(b), 13(c), 14, 15 and 16; the
backward's, `prior_gradient`, its time with and without the prior's
gradient at the flagship shape; `param_recipe` holds [11](a)'s times,
`lifting_tasks` [12]'s, `h36m_path` [13]'s, `r152_recipes` [14]'s,
`a11d_recipes` [15]'s, `last_modules` [16]'s.  No
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
import os
import re
import signal
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
# error.  Under bf16 convolutions any f32-level difference in the attention
# flips bf16 roundings through the trunk, and the whole-model error of a
# correct attention moves with the weights (scripts/torch_bf16_step_noise.py),
# so bf16 holds it within STEP_BF16_NOISE_FACTOR times the largest of
# `rounding_references`' errors at the same weights, never below
# STEP_GRAD_REL_L2
STEP_LOSS_RTOL = 2e-2
STEP_GRAD_REL_L2 = 2e-2
STEP_BF16_NOISE_FACTOR = 1.5
ROUNDING_JITTER = 1e-6
ROUNDING_DRAWS = 3
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
# [13]: configs/epipolar/fake_h36m_zresidual.yaml as written (R-50 f32,
# 256 px, K=64, batch 8, NUM_WORKERS 4) on a fake H36M tree: one batch of 8
# train groups, so each train step is an epoch; the undistoredzip item may
# lie this far from the jpg one on average (ImageNet-normalized units, one
# more JPEG round trip; tests/test_fake_h36m.py)
H36M_RECIPE = "configs/epipolar/fake_h36m_zresidual.yaml"
H36M_TRAIN_GROUPS = 8
H36M_VAL_GROUPS = 4
H36M_IMAGE_SIZE = 1000
H36M_STEPS = 3
H36M_EVAL_GROUPS = 2
H36M_LOADER_BATCHES = 6
UNDISTORTED_MEAN_GAP = 0.05
# [14]: the ResNet-152 recipes as written (and the K=85 one) on a fake H36M
# tree of 1002x1000 frames, data parallel under torchrun and over gloo.
# 40 train groups: a batch of 32 takes one a step, a batch of 8 runs 3
# steps inside one epoch; 72 validation groups, of which TEST_SAMPLE 64
# keeps 2; the frames of 4 train and 2 validation groups repeat
R152_RECIPE = "configs/epipolar/keypoint_h36m_resnet152_384_fixed.yaml"
R152_DDP_RECIPE = "configs/epipolar/keypoint_h36m_resnet152_384_fixed_8gpu.yaml"
R152_320_RECIPE = "configs/epipolar/keypoint_h36m_resnet152_320_fixed_8gpu.yaml"
K85_RECIPE = "configs/epipolar/keypoint_h36m_resnet50_384_strong_fixed.yaml"
R152_WEIGHTS = "datasets/resnet152-b121ed2d.pth"  # the _8gpu recipes' PRETRAINED_WEIGHTS
R152_TRAIN_GROUPS, R152_VAL_GROUPS, R152_DISTINCT = 40, 72, (4, 2)
R152_STEPS = 3
R152_EVAL_GROUPS = 2
# (b): the _8gpu recipe's global batch on one rank under torchrun, and
# without; its loader takes ~16 s a batch of 32, so 2 steps (the second
# timed), each an epoch
DDP_BATCH = 32
DDP_STEPS = 2
# (c): two ranks on the one card over gloo, the _8gpu recipe cut to a batch
# of 8 (4 a rank) for memory and time
GLOO_RANKS = 2
GLOO_BATCH = 8
GLOO_STEPS = 3
CHILD_TIMEOUT = 600
# [15]: the fifteen recipes no card had run, as written, on one fake H36M
# tree, one fake RHD tree and one seeded pose-ResNet file, their command
# lines one after another in one process.  160 train groups: TRAIN_SAMPLE
# 5 (the union recipes' default) keeps 32, two steps at a batch of 16; 72
# validation groups, of which TEST_SAMPLE 64 keeps 2.  Each entry: the
# recipe and the error its command line raises in both packages (ROADMAP
# C17-C19), else None.  The union-joint recipes train, then their eval
# triangulates 20 union joints against 17 targets.
A11D_RECIPES = (
    ("configs/epipolar/keypoint_h36m_resnet152_384_pretrained_8gpu.yaml", None),
    ("configs/epipolar/keypoint_h36m_resnet152_384_aug.yaml", None),
    ("configs/epipolar/keypoint_h36m_resnet152_384_strong.yaml", "IndexError"),
    ("configs/epipolar/keypoint_h36m_resnet152_384.yaml", "ValueError"),
    ("configs/epipolar/keypoint_h36m_resnet152_320.yaml", "ValueError"),
    ("configs/epipolar/keypoint_h36m.yaml", "ValueError"),
    ("configs/epipolar/keypoint_h36m_zresidual_aug.yaml", None),
    ("configs/epipolar/keypoint_h36m_zresidual_fixed.yaml", None),
    ("configs/benchmark/keypoint_h36m.yaml", "ValueError"),
    ("configs/benchmark/keypoint_h36m_resnet152_384.yaml", None),
    ("configs/lifting/img_lifting_rot_h36m.yaml", "KeyError"),
    ("configs/lifting/lifting_direct_h36m.yaml", "KeyError"),
    ("configs/lifting/lifting.yaml", None),
    ("configs/lifting/lifting_sgd.yaml", None),
    ("configs/lifting/lifting_rot_sgd.yaml", None),
)
# the pinned errors' messages (tests/test_torch_recipes_a11d.py)
A11D_ERRORS = {"IndexError": "list index out of range",
               "ValueError": "(20,3) (17,3)",
               "configs/lifting/img_lifting_rot_h36m.yaml": "can-points-3d",
               "configs/lifting/lifting_direct_h36m.yaml": "other_points-2d"}
A11D_TRAIN_GROUPS, A11D_VAL_GROUPS = 160, 72
A11D_STEPS = 2
A11D_RHD_STEPS = 3
A11D_EVAL_GROUPS = 2
POSE_RESNET_WEIGHTS = "datasets/pose_resnet_4.5_pixels_human36m.pth"
A11D_19MM = A11D_RECIPES[0][0]
A11D_TRACE_RECIPE = "configs/epipolar/keypoint_h36m_resnet152_384_aug.yaml"
A11D_BENCHMARK_RECIPE = "configs/epipolar/keypoint_h36m_zresidual_fixed.yaml"
A11D_BENCHMARK_BATCHES = 4  # the first (the workers' start in it) and 3 more
# command lines run one after another in one process: its limit
JOBS_TIMEOUT = 900
A11D_STAGES = ("setup", "read", "undistort", "warp", "heatmap")
# the hand kernels a trace of a 96x96 recipe's train steps must name: the
# forward's grouping, tile and per-query kernels, the backward's passes
TRACE_KERNELS = ("group_kernel", "tile_forward_kernel", "epipolar_attention_kernel",
                 "query_backward_kernel", "tile_histogram_kernel", "tile_scan_kernel",
                 "row_offset_kernel", "fill_kernel", "row_gather_kernel", "row_fixup_kernel")
# the 19 mm recipe's eval, kernel route against plain route: corr_pos as
# [8] holds it, the 3D of its `epipolar` triangulation per joint
CORR_POS_TOL = 1e-3
EPIPOLAR_3D_MM = 0.1
# the attention alone on a recipe's whole batch: its plain version runs on
# slices of this many items (a batch of 32 at 96x96 would need ~20 GB a
# gathered tensor); the multiview recipes of [15] that set each (batch,
# heatmap size) once: 32 and 16 at 96x96, 12 at 80x80, 16 at 64x64
PLAIN_SLICE = 8
# [16] the last modules: the .ckpt import, VIS and the batched triangulation,
# on the flagship recipe's eval groups
VIS_GROUPS = 4
VIS_GT_GROUPS = 2
TRIANGULATION_MM = 1e-4  # the batched f64 pymvg on the card against the host copy
A11D_ATTENTION_RECIPES = (
    "configs/epipolar/keypoint_h36m_resnet152_384_pretrained_8gpu.yaml",
    "configs/epipolar/keypoint_h36m_resnet152_384.yaml",
    "configs/epipolar/keypoint_h36m_resnet152_320.yaml",
    "configs/epipolar/keypoint_h36m_zresidual_fixed.yaml",
)
REPLACES = "epipolar_transformers_tpu/ops/epipolar_attention_pallas.py:66"
BACKWARD_REPLACES = ("jax.grad of epipolar_transformers_tpu/ops/"
                     "epipolar_attention_matmul.py:158 (no TPU backward kernel)")
# published H100 SXM peaks: f32 outside the tensor cores, HBM
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def child_pids() -> list:
    """The pids of this process's children that are still there."""
    pids = []
    for task in os.listdir("/proc/self/task"):
        with open(f"/proc/self/task/{task}/children") as f:
            pids += [int(p) for p in f.read().split()]
    return pids


def stop_children() -> list:
    """Stop every process this script started and wait for each: the
    loader's workers, its forkserver and resource tracker (which would
    outlive the script for a moment), then any other child, killed.
    Returns the pids that had to be killed."""
    pipeline = sys.modules.get("epipolar_transformers_tpu_torch.data.pipeline")
    if pipeline is not None:
        pipeline.stop_workers()
    killed = child_pids()
    for pid in killed:
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGKILL)
        with contextlib.suppress(ChildProcessError):
            os.waitpid(pid, 0)
    return killed


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


# the fake H36M tree's lens: H36M-magnitude radial and tangential distortion
FAKE_H36M_K = (-0.207, 0.244, -0.0021)
FAKE_H36M_P = (0.0014, -0.0007)


def distort_points(pts, K):
    """OpenCV's distortion model with FAKE_H36M_K/_P: pinhole pixels ->
    distorted pixels."""
    import numpy as np

    k, p = FAKE_H36M_K, FAKE_H36M_P
    x = (pts[:, 0] - K[0, 2]) / K[0, 0]
    y = (pts[:, 1] - K[1, 2]) / K[1, 1]
    r2 = x * x + y * y
    radial = 1 + k[0] * r2 + k[1] * r2 ** 2 + k[2] * r2 ** 3
    xd = x * radial + 2 * p[0] * x * y + p[1] * (r2 + 2 * x * x)
    yd = y * radial + p[0] * (r2 + 2 * y * y) + 2 * p[1] * x * y
    return np.stack([xd * K[0, 0] + K[0, 2], yd * K[1, 1] + K[1, 2]], axis=1)


def render_fake_frame(pts2d, colors, size: int, sigma: float):
    """Coloured Gaussian splats at `pts2d` on a low-frequency gradient,
    uint8 BGR, (size + 2, size): H36M's frames are 1002 x 1000 and the
    loader keeps the first 1000 rows."""
    import numpy as np

    clip = 4.60517019
    img = np.zeros((size, size, 3), np.float32)
    img += (np.linspace(0.06, 0.16, size, dtype=np.float32)[:, None]
            + np.linspace(0.10, 0.04, size, dtype=np.float32)[None, :])[..., None]
    sig = sigma * np.sqrt(2.0)
    rad = int(np.ceil(sig * np.sqrt(clip))) + 2
    for j, (px, py) in enumerate(pts2d):
        y0, y1 = (min(max(int(py) + d, 0), size) for d in (-rad, rad + 1))
        x0, x1 = (min(max(int(px) + d, 0), size) for d in (-rad, rad + 1))
        if y0 >= y1 or x0 >= x1:
            continue
        yy = (np.arange(y0, y1, dtype=np.float32) - py) / sig
        xx = (np.arange(x0, x1, dtype=np.float32) - px) / sig
        val = np.exp(-np.clip(yy[:, None] ** 2 + xx[None, :] ** 2, 0, clip)) - np.float32(
            np.exp(-clip))
        img[y0:y1, x0:x1] += val[..., None] * colors[j]
    np.clip(img, 0.0, 1.0, out=img)
    bgr = (img[..., ::-1] * 255).astype(np.uint8)
    return np.concatenate([bgr, np.tile(bgr[-1:], (2, 1, 1))], axis=0)


def write_fake_h36m(data_dir: str, train_groups: int = 8, val_groups: int = 4,
                    image_size: int = 1000, seed: int = SEED, quality: int = 92,
                    distinct_groups=None) -> None:
    """A fake H36M tree under `data_dir` in the reference layout, with the
    port's own code: h36m/annot/h36m_{train,validation}.pkl, the frames as
    (image_size + 2) x image_size JPEGs written by the port's baseline
    encoder at `quality`, h36m/images.zip with the same files and
    h36m/undistoredimages.zip with each frame's first image_size rows
    undistorted by the port.  Four cameras a group on a ring, random
    17-joint skeletons, coloured splats at the distorted projections; the
    records are those of scripts/make_fake_h36m.py's make_split for the
    same seeds (train `seed`, validation seed + 7919).  With
    `distinct_groups` (train, validation) = (a, b), group g of a split
    repeats the skeleton and encoded frames of its group g % a (or b) under
    its own names, so that a large tree costs a few groups' encodes."""
    import pickle
    import zipfile

    import numpy as np

    from epipolar_transformers_tpu_torch.data.datasets.synthetic import make_camera_ring
    from epipolar_transformers_tpu_torch.data.jpeg import encode_jpeg, read_jpeg
    from epipolar_transformers_tpu_torch.geometry.undistort import undistort_image
    from epipolar_transformers_tpu_torch.ops.synthetic_render import joint_colors

    dist = np.array([*FAKE_H36M_K[:2], *FAKE_H36M_P, FAKE_H36M_K[2]])
    root = os.path.join(data_dir, "h36m")
    os.makedirs(os.path.join(root, "annot"), exist_ok=True)
    rig = make_camera_ring(image_size=(image_size, image_size), focal=1.15 * image_size,
                           radius=3000.0)
    colors = joint_colors(17)
    distinct = distinct_groups or (None, None)
    for split, n_groups, split_seed, subject, every in (
            ("train", train_groups, seed, 1, distinct[0]),
            ("validation", val_groups, seed + 7919, 9, distinct[1])):
        rng = np.random.RandomState(split_seed)
        db, frames, made = [], [], {}
        for g in range(n_groups):
            action = 2 + g % 15
            src = g % every if every else g
            if src not in made:
                center = np.array([0.0, 0.0, 1000.0]) + rng.uniform(-150, 150, 3)
                made[src] = (center[None] + rng.uniform(-350.0, 350.0, (17, 3)), {})
            X, encoded = made[src]
            for cam in range(4):
                R, K = rig["R"][cam], rig["K"][cam]
                cam3d = (R @ (X.T - rig["T"][cam].reshape(3, 1))).T
                proj = (K @ cam3d.T).T
                dist2d = distort_points(proj[:, :2] / proj[:, 2:], K)
                seq = f"s_{subject:02d}_act_{action:02d}_subact_01_ca_{cam + 1:02d}"
                name = os.path.join(seq, f"{seq}_{g + 1:06d}.jpg")
                if cam not in encoded:
                    encoded[cam] = encode_jpeg(render_fake_frame(dist2d, colors, image_size,
                                                                 0.01 * image_size), quality)
                data = encoded[cam]
                path = os.path.join(root, "images", name)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "wb") as f:
                    f.write(data)
                frames.append((os.path.join("images", name), data, K))
                extent = (dist2d.max(0) - dist2d.min(0)).max()
                db.append({
                    "subject": subject, "action": action, "subaction": 1, "image_id": g,
                    "camera_id": cam, "source": "h36m", "image": name,
                    "joints_2d": dist2d.astype(np.float64), "joints_3d": X.astype(np.float64),
                    "joints_3d_camera": cam3d.astype(np.float64),
                    "joints_vis": np.ones((17, 3)),
                    "center": (0.5 * (dist2d.min(0) + dist2d.max(0))).astype(np.float64),
                    "scale": np.full(2, 1.3 * extent / 200.0),
                    "camera": {"R": R, "T": rig["T"][cam].reshape(3, 1), "fx": K[0, 0],
                               "fy": K[1, 1], "cx": K[0, 2], "cy": K[1, 2],
                               "k": np.array(FAKE_H36M_K).reshape(3, 1),
                               "p": np.array(FAKE_H36M_P).reshape(2, 1)},
                })
        anno = "h36m_train.pkl" if split == "train" else "h36m_validation.pkl"
        with open(os.path.join(root, "annot", anno), "wb") as f:
            pickle.dump(db, f)
        undistorted = {}
        with zipfile.ZipFile(os.path.join(root, "images.zip"), "a") as zraw, \
                zipfile.ZipFile(os.path.join(root, "undistoredimages.zip"), "a") as zund:
            for member, data, K in frames:
                zraw.writestr(member, data)
                if id(data) not in undistorted:
                    und = undistort_image(read_jpeg(data)[:image_size], K, dist)
                    undistorted[id(data)] = encode_jpeg(und, quality)
                zund.writestr(member, undistorted[id(data)])


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


def attention_path(model, plain: bool):
    """Run `model`'s epipolar layers through the plain version (plain) or
    the kernels, on the same weights."""
    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn

    return attention_via(model, attn.epipolar_attention_plain_batch if plain
                         else attn.epipolar_attention_batch)


@contextlib.contextmanager
def attention_via(model, fn):
    """Run `model`'s epipolar layers through the attention function `fn`
    (`epipolar_attention_batch`'s contract), on the same weights."""
    from epipolar_transformers_tpu_torch.models.epipolar import Epipolar

    samplers = [m for m in model.modules() if isinstance(m, Epipolar)]
    for sampler in samplers:
        sampler.attention = fn
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
              for m in re.findall(r"\bloss: (\S+)", msg)]
    losses = [loss for _, loss in logged]
    step_ms = [(b[0] - a[0]) * 1e3 for a, b in zip(logged, logged[1:])]
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"{name} train losses {losses}")
    for term in terms:
        values = [float(v) for msg in messages.messages
                  for v in re.findall(rf"\b{term}: (\S+)", msg)]
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


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms inside the block."""
    import torch

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def step_grads(model, batch):
    """One train step's loss and parameter gradients of `model` on `batch`
    (ZERO_GRAD_PARAMS left out); the dropout masks restart from SEED."""
    model.zero_grad(set_to_none=True)
    model.seed_dropout(SEED)
    loss = model(batch)[0]["loss"]
    loss.backward()
    return loss.item(), {k: p.grad.detach().clone() for k, p in model.named_parameters()
                         if p.grad is not None and k not in ZERO_GRAD_PARAMS}


def rel_l2(a, b) -> float:
    """|a - b| / |b| in f64."""
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


def rounding_references() -> dict:
    """{name: attention function} of correct attentions that differ from
    the f32 plain version by rounding alone (`epipolar_attention_batch`'s
    contract): the plain version in f64, and the plain version with its
    output moved by ROUNDING_JITTER relative noise (the kernel's own
    distance from it, ~1e-6), from ROUNDING_DRAWS seeds."""
    import torch

    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn

    plain = attn.epipolar_attention_plain_batch

    def f64(f1, f2, f3, sample_locs, params, prior=None):
        out, corr_pos, depth = plain(f1.double(), f2.double(), f3.double(),
                                     sample_locs.double(), params,
                                     None if prior is None else prior.double())
        return out.to(f3.dtype), corr_pos.float(), depth.float()

    def jittered(seed):
        def fn(f1, f2, f3, sample_locs, params, prior=None):
            out, corr_pos, depth = plain(f1, f2, f3, sample_locs, params, prior)
            gen = torch.Generator(device=out.device).manual_seed(seed)
            noise = torch.randn(out.shape, device=out.device, generator=gen)
            return out * (1 + ROUNDING_JITTER * noise).to(out.dtype), corr_pos, depth
        return fn

    return {"plain in f64": f64, **{f"plain, output jittered (seed {s})": jittered(s)
                                    for s in range(SEED + 1, SEED + 1 + ROUNDING_DRAWS)}}


def compare_step_paths(name, model, batch, per_param: bool):
    """One train step's loss and gradients of `model` on `batch`, kernel
    path (twice) against plain path, held as `step_parity` says; the
    dropout masks (the lifting net's) restart from SEED for each run.
    Under bf16 convolutions the noise that the limit scales with is the
    largest error of the `rounding_references` against the plain path:
    how far rounding-level differences in the attention move the gradient
    through the bf16 trunk at these weights.  Returns the kernel path's
    gradients."""
    import numpy as np
    import torch

    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn

    model.train()

    def loss_and_grads(fn):
        with attention_via(model, fn):
            return step_grads(model, batch)

    # cuDNN's deterministic algorithms, so that the paths differ by their
    # attention alone: the bf16 weight gradients of its default algorithms
    # add in an order that varies between runs
    with cudnn_deterministic():
        loss_k, grads_k = loss_and_grads(attn.epipolar_attention_batch)
        _, grads_k2 = loss_and_grads(attn.epipolar_attention_batch)
        loss_p, grads_p = loss_and_grads(attn.epipolar_attention_plain_batch)
        refs = {} if per_param else {name: loss_and_grads(fn)[1]
                                     for name, fn in rounding_references().items()}
    kept = dict(grads_k)
    if abs(loss_k - loss_p) > STEP_LOSS_RTOL * abs(loss_p) or not np.isfinite(loss_k):
        raise AssertionError(f"{name} train step loss: kernel path {loss_k}, plain {loss_p}")
    if set(grads_k) != set(grads_p):
        raise AssertionError("the two paths give gradients to different parameters")
    floor = STEP_NOISE_FLOOR * max(float(g.abs().max()) for g in grads_p.values())
    noise = {k for k in grads_p
             if max(float(grads_k[k].abs().max()), float(grads_p[k].abs().max())) < floor}
    for grads in (grads_k, grads_k2, grads_p, *refs.values()):
        for k in noise:
            grads.pop(k, None)

    def whole_rel(got, want):
        return rel_l2(torch.cat([g.flatten() for g in got.values()]),
                      torch.cat([want[k].flatten() for k in got]))

    whole, whole_self = whole_rel(grads_k, grads_p), whole_rel(grads_k2, grads_k)
    rounding = {name: whole_rel(g, grads_p) for name, g in refs.items()}
    limit = STEP_GRAD_REL_L2 if per_param else max(
        STEP_GRAD_REL_L2, STEP_BF16_NOISE_FACTOR * max(rounding.values()))
    reference = f"kernel path against itself {whole_self:.3g}" + "".join(
        f", {name} {v:.3g}" for name, v in rounding.items())
    if not whole <= limit:
        raise AssertionError(f"{name} whole-model gradient relative L2 error {whole:.3g} "
                             f"above {limit:.3g} ({reference})")
    errs = {k: rel_l2(grads_k[k], g) for k, g in grads_p.items()}
    worst = max(errs, key=errs.get)
    if per_param and not errs[worst] <= STEP_GRAD_REL_L2:
        raise AssertionError(f"{name} {worst}: gradient relative L2 error {errs[worst]:.3g}")
    n = next(iter(batch.values())).shape[0]
    log(f"  one {name} step (batch {n}), kernel vs plain path: loss {loss_k:.6g} vs "
        f"{loss_p:.6g}; gradient relative L2 error {whole:.3g} over the model, limit "
        f"{limit:.3g} ({reference}), worst parameter {errs[worst]:.3g} ({worst}; kernel "
        f"path against itself {rel_l2(grads_k2[worst], grads_k[worst]):.3g}) over {len(errs)} "
        f"parameters ({len(noise)} with a true gradient of 0 left out)")
    return kept


def finite_metrics(name, results) -> None:
    """Raise unless the eval metrics are all there and finite."""
    import math

    keys = {"EPEmean_global", "JDR"}
    if not keys <= set(results) or not all(any(k.startswith(p) for k in results)
                                           for p in ("MPJPE@", "PCK@")):
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
    log lines collected.
    Returns the RESULTS dict, the logged losses, the loop's wall ms per step
    after the first (between two step log lines: loader, upload and step),
    the peak device memory (GiB) and the wall seconds."""
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
              for m in re.findall(r"\bloss: (\S+)", msg)]
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


def lifting_rot_case(cfg, device, seed: int = SEED):
    """[12](b)'s case: multiview_img_lifting_rot at the flagship's widths
    (`cfg`) and batch BENCH_BATCH on the synthetic rig's images and cameras,
    lifting targets from SEED, the weights randomized from `seed`.
    Returns (config, inputs, model)."""
    import numpy as np
    import torch

    from epipolar_transformers_tpu_torch.config import update_from_dict
    from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
    from epipolar_transformers_tpu_torch.data.pipeline import collate
    from epipolar_transformers_tpu_torch.engine import trainer

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
    randomize(model, torch.cat([inputs["img"], inputs["other_img"]]), seed)
    return mcfg, inputs, model


def multiview_lifting_phase(cfg, device):
    """[12](b): multiview_img_lifting_rot at the flagship's widths
    (epipolarposeR-50, 256 px, bf16 convolutions, 64x64, K=64, 17 joints,
    batch 8) on the synthetic rig's images and cameras, lifting targets
    from SEED: three train steps through `make_train_step` (the main path,
    one forward and one backward kernel launch a step); one step kernel
    path against plain path ([6]'s limits); the fusion BN's scale gets a
    gradient; no gradient reaches `other_img`; ms per step and peak memory."""
    import torch

    from epipolar_transformers_tpu_torch.engine import trainer
    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn

    mcfg, inputs, model = lifting_rot_case(cfg, device)
    B, J = BENCH_BATCH, mcfg.KEYPOINT.NUM_PTS
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


def h36m_phase(device):
    """[13]: the flagship recipe on H36M-layout data.  (a) a fake H36M tree
    of 1002x1000 JPEG frames written with the port's own encoder; (b) one
    item in each DATA_FORMAT (zip bit-equal to jpg, undistoredzip within
    tests/test_fake_h36m.py's mean of jpg) and the host ms of each stage of
    one frame; (c) H36M_RECIPE as written through the command line:
    H36M_STEPS train steps, `test` on H36M_EVAL_GROUPS groups under pymvg,
    both attention kernels launched; the loader's wall per batch, the device
    step, the loop's wall per step and the peak memory; (d) neither cv2 nor
    PIL imported."""
    import numpy as np
    import torch

    from epipolar_transformers_tpu_torch.config import DatasetCatalog, load_config
    from epipolar_transformers_tpu_torch.data import pipeline
    from epipolar_transformers_tpu_torch.data.datasets.joints_dataset import JointsDataset
    from epipolar_transformers_tpu_torch.data.jpeg import read_jpeg
    from epipolar_transformers_tpu_torch.data.transforms.affine import get_affine_transform
    from epipolar_transformers_tpu_torch.data.transforms.warp import render_heatmaps, warp_affine
    from epipolar_transformers_tpu_torch.engine import trainer
    from epipolar_transformers_tpu_torch.geometry.undistort import undistort_image
    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn

    out = {}
    saved = DatasetCatalog.DATA_DIR
    phase_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_fake_h36m(tmp, H36M_TRAIN_GROUPS, H36M_VAL_GROUPS, H36M_IMAGE_SIZE)
        log(f"  (a) fake H36M tree: {H36M_TRAIN_GROUPS} train and {H36M_VAL_GROUPS} validation "
            f"groups of 4 views, {H36M_IMAGE_SIZE + 2}x{H36M_IMAGE_SIZE} JPEG frames (quality "
            f"92, 4:2:0, the port's encoder), images.zip and undistoredimages.zip, written in "
            f"{time.perf_counter() - t0:.1f} s")
        DatasetCatalog.DATA_DIR = tmp
        try:
            cfg = load_config(H36M_RECIPE)

            # (b) one item per DATA_FORMAT, and one frame's stages
            items = {}
            for fmt in ("undistoredzip", "zip", "jpg"):
                fcfg = cfg.replace(DATASETS=cfg.DATASETS.replace(DATA_FORMAT=fmt))
                ds = pipeline.build_dataset(fcfg, cfg.DATASETS.TRAIN[0])
                ds.reseed(SEED)
                items[fmt] = ds[0]
            if any(not np.array_equal(items["zip"][k], items["jpg"][k]) for k in items["jpg"]):
                raise AssertionError("[13](b) the zip item differs from the jpg item")
            gap = float(np.abs(items["undistoredzip"]["img"] - items["jpg"]["img"]).mean())
            if gap >= UNDISTORTED_MEAN_GAP:
                raise AssertionError(f"[13](b) undistoredzip img {gap} from jpg's on average")
            rec = ds.db[0]
            cam = rec["camera"]
            K = np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]], [0, 0, 1.0]])
            dist = np.array([*np.ravel(cam["k"])[:2], *np.ravel(cam["p"]), np.ravel(cam["k"])[2]])
            path = os.path.join(tmp, "h36m", "images", rec["image"])
            trans = get_affine_transform(rec["center"], rec["scale"], 0, cfg.DATASETS.IMAGE_SIZE)
            stages = {}

            def stage(name, fn, *args):
                t0 = time.perf_counter()
                result = fn(*args)
                stages[name] = (time.perf_counter() - t0) * 1e3
                return result

            frame = stage("read_decode", lambda p: read_jpeg(p)[:1000], path)
            frame = stage("undistort", undistort_image, frame, K, dist)
            stage("warp", warp_affine, frame.astype(np.float32), trans,
                  tuple(cfg.DATASETS.IMAGE_SIZE))
            stage("heatmaps", render_heatmaps, rec["joints_2d"], tuple(cfg.KEYPOINT.HEATMAP_SIZE),
                  cfg.KEYPOINT.SIGMA, cfg.BACKBONE.DOWNSAMPLE)
            stage("item", JointsDataset.__getitem__, ds, 0)
            out["frame_host_ms"] = stages
            log(f"  (b) one train item per DATA_FORMAT: zip bit-equal to jpg, undistoredzip's "
                f"img {gap:.4f} from jpg's on average (limit {UNDISTORTED_MEAN_GAP}); one "
                f"{H36M_IMAGE_SIZE + 2}x{H36M_IMAGE_SIZE} frame on the host: read and decode "
                f"{stages['read_decode']:.1f} ms, undistort {stages['undistort']:.1f} ms, warp to "
                f"{cfg.DATASETS.IMAGE_SIZE[0]} px {stages['warp']:.1f} ms, heatmaps "
                f"{stages['heatmaps']:.1f} ms; one view's whole item (jpg: these and the "
                f"rest) {stages['item']:.1f} ms")

            # (c) the recipe as written through the command line
            argv = ["--cfg", H36M_RECIPE, "--max-steps", str(H36M_STEPS), "--max-eval-batches",
                    str(H36M_EVAL_GROUPS), "LOG_FREQ", "1", "TENSORBOARD.USE", "False",
                    "OUTPUT_DIR", os.path.join(tmp, "out")]
            attn.LAUNCHES = attn.BACKWARD_LAUNCHES = 0
            attn.TILE_COUNTS.clear()
            results, losses, loop_ms, peak, wall = cli_run("[13](c) H36M recipe", argv)
            torch.cuda.synchronize()
            launches, backward_launches = attn.LAUNCHES, attn.BACKWARD_LAUNCHES
            tiles = attn.tile_counts()
            if not (launches > 0 and backward_launches > 0):
                raise AssertionError(f"[13](c) forward kernel launches {launches}, backward "
                                     f"{backward_launches}")
            finite_metrics("[13](c) H36M recipe", results)
            out.update(launches=launches, backward_launches=backward_launches, tiles=tiles,
                       MPJPE=results["EPEmean_global"], JDR=results["JDR"], peak_gib=peak,
                       loop_ms_per_step=statistics.mean(loop_ms), cli_seconds=wall)

            # the loader alone: H36M_LOADER_BATCHES batches from one worker pool
            ds = pipeline.build_dataset(cfg, cfg.DATASETS.TRAIN[0])
            B = cfg.SOLVER.IMS_PER_BATCH
            loader = pipeline.TrainLoader(pipeline.ConcatDataset([ds] * H36M_LOADER_BATCHES), B,
                                          cfg.SEED, pipeline.num_workers_for(cfg, ds),
                                          cfg.DATALOADER.MP_START_METHOD)
            batch_ms, t0 = [], time.perf_counter()
            for batch in loader:
                batch_ms.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
            inputs = trainer.model_inputs(batch, device, None)
            ms = device_step_ms(cfg, inputs, device)
            out.update(loader_ms_first_batch=batch_ms[0],
                       loader_ms_per_batch=statistics.mean(batch_ms[1:]), ms_per_step=ms)
            log(f"  (c) {H36M_RECIPE} as written ({cfg.BACKBONE.BODY}, "
                f"{cfg.DATASETS.IMAGE_SIZE[0]} px, K={cfg.EPIPOLAR.SAMPLESIZE}, batch {B}, "
                f"DATA_FORMAT {cfg.DATASETS.DATA_FORMAT}, NUM_WORKERS "
                f"{cfg.DATALOADER.NUM_WORKERS}) through the command line in {wall:.1f} s: "
                f"losses {', '.join(f'{v:.5g}' for v in losses)}; EPEmean_global (MPJPE) "
                f"{results['EPEmean_global']:.4f} mm, JDR {results['JDR']:.4f} over "
                f"{H36M_EVAL_GROUPS} groups (pymvg), all finite; forward kernel launches "
                f"{launches}, backward kernel launches {backward_launches}, forward tiles "
                f"{tiles[0]} / {tiles[1]}; loop wall "
                f"{statistics.mean(loop_ms):.1f} ms a step after the first; peak memory "
                f"{peak:.3f} GiB")
            log(f"  (c) loader, batch {B} ({4 * B} frames), {loader.num_workers} workers: first batch "
                f"{batch_ms[0]:.1f} ms (the workers' start), then "
                f"{statistics.mean(batch_ms[1:]):.1f} ms a batch "
                f"({', '.join(f'{t:.1f}' for t in batch_ms[1:])}); train step {ms:.3f} ms "
                f"(CUDA events) on a loader batch")
            del inputs
            torch.cuda.empty_cache()
        finally:
            DatasetCatalog.DATA_DIR = saved
    seen = sorted(m for m in sys.modules if m.split(".")[0] in ("cv2", "PIL"))
    if seen:
        raise AssertionError(f"[13](d) the H36M path imported {seen}")
    out["phase_seconds"] = time.perf_counter() - phase_start
    log(f"  (d) neither cv2 nor PIL was imported; [13] took {out['phase_seconds']:.1f} s")
    return out


def write_torchvision_resnet(path: str, depth: int = 152, seed: int = SEED,
                             zero_init_residual: bool = True) -> None:
    """A seeded random ImageNet ResNet state dict in torchvision's layout
    (conv1, bn1, layer1-4 with downsample.0/1, fc), the file the recipes'
    BACKBONE.PRETRAINED_WEIGHTS names: He-normal kernels, BN weights near 1
    and small biases and running means, running variances near 1.  With
    `zero_init_residual` (torchvision's option) the last BN of each block
    starts near 0, so that each block starts near the identity and the
    trunk's activations stay bounded, as a trained trunk's do.  Without
    it, R-152's 50 blocks on these running statistics grow them so far
    that after one step the 320 px recipe's heatmap peaks lie near +-1e4,
    some joints peak below -1 in every view, and the pymvg triangulation
    (the JAX package's too) has no view to solve them with: MPJPE NaN
    (scripts/torch_r152_eval_nan.py)."""
    import torch

    sd = random_resnet_state(depth, seed, zero_init_residual, head=False)
    gen = torch.Generator().manual_seed(seed + 1)
    sd["fc.weight"] = 0.01 * torch.randn(1000, 512 * 4 if depth >= 50 else 512, generator=gen)
    sd["fc.bias"] = torch.zeros(1000)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(sd, path)


def write_pose_resnet(path: str, depth: int = 152, seed: int = SEED) -> None:
    """A seeded random pose-ResNet checkpoint in the reference's layout (the
    trunk, `deconv_layers` and `final_layer` of 17 joints, every key under
    `module.`), the file that the 384 px pretrained recipes'
    BACKBONE.PRETRAINED_WEIGHTS names; its trunk as `write_torchvision_resnet`
    writes it, with each block's last BN near 0."""
    import torch

    sd = random_resnet_state(depth, seed, zero_init_residual=True, head=True)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({f"module.{k}": v for k, v in sd.items()}, path)


def random_resnet_state(depth: int, seed: int, zero_init_residual: bool, head: bool) -> dict:
    """The seeded random state dict of a pose-ResNet of `depth` (17
    joints), with or without its deconv head and final layer: He-normal
    kernels, BN weights near 1 and small biases and running means, running
    variances near 1; with `zero_init_residual` each block's last BN weight
    near 0."""
    import torch

    from epipolar_transformers_tpu_torch.config import Config, update_from_dict
    from epipolar_transformers_tpu_torch.models.resnet import PoseResNet

    cfg = update_from_dict(Config(), {"BACKBONE": {"BODY": f"poseR-{depth}"},
                                      "KEYPOINT": {"NUM_PTS": 17}})
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in PoseResNet(cfg).state_dict().items():
        if not head and k.startswith(("deconv_layers.", "final_layer.")):
            continue
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.zeros((), dtype=torch.long)
        elif v.ndim == 4:
            sd[k] = torch.randn(v.shape, generator=gen) * math.sqrt(2.0 / v[0].numel())
        elif k.endswith("running_var"):
            sd[k] = 0.5 + torch.rand(v.shape, generator=gen)
        elif k.endswith("weight"):
            last = zero_init_residual and k.startswith("layer") and k.endswith(
                "bn3.weight" if depth >= 50 else "bn2.weight")
            sd[k] = (0.01 if last else 0.1) * torch.randn(v.shape, generator=gen) + (not last)
        else:  # bias, running_mean
            sd[k] = 0.1 * torch.randn(v.shape, generator=gen)
    return sd


def session_pids(sid: int) -> list:
    """The processes of session `sid` that are still there."""
    pids = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[3]) == sid and fields[0] != "Z":
            pids.append(int(entry))
    return pids


def run_children(name, cmds, cwd, env, timeout=CHILD_TIMEOUT):
    """Start each command in a session of its own, wait for all (at most
    `timeout` s), and check that every one exited 0 and left no
    process behind (a moment's grace for the loader's forkserver and
    resource tracker); on a failure kill every session's processes and
    raise with the children's last output.  Returns their outputs."""
    procs = [subprocess.Popen(c, cwd=cwd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, start_new_session=True)
             for c in cmds]
    outs, failed = [], []
    deadline = time.monotonic() + timeout
    try:
        for i, p in enumerate(procs):
            try:
                out = p.communicate(timeout=max(deadline - time.monotonic(), 1))[0]
            except subprocess.TimeoutExpired:
                p.kill()
                out = p.communicate()[0]
                failed.append(f"child {i} ran past {timeout} s")
            if p.returncode != 0:
                failed.append(f"child {i} exited {p.returncode}")
            outs.append(out)
            if p.returncode != 0:  # the others would wait on it: stop them
                for q in procs:
                    if q.poll() is None:
                        os.killpg(q.pid, signal.SIGKILL)
    finally:
        left = []
        for p in procs:
            end = time.monotonic() + 15
            while session_pids(p.pid) and time.monotonic() < end:
                time.sleep(0.2)
            rest = session_pids(p.pid)
            if rest:
                left += rest
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(p.pid, signal.SIGKILL)
            if p.poll() is None:
                p.kill()
                p.wait()
    if left:
        failed.append(f"processes {left} outlived their children")
    if failed:
        tail = "\n".join(f"--- child {i} ---\n{o[-4000:]}" for i, o in enumerate(outs))
        raise AssertionError(f"{name}: {'; '.join(failed)}\n{tail}")
    return outs


def child_env() -> dict:
    root = os.path.dirname(os.path.abspath(__file__))
    return dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def step_log(messages) -> dict:
    """The trainer's step lines: device ms (CUDA events) and peak GiB of
    each step, and the last line's data_t / step_t (loader and loop wall,
    seconds a step on average)."""
    lines = [m for m in messages if " step " in m and " loss: " in m]
    if not lines:
        raise AssertionError("no train step was logged")

    def values(key, sep=" "):
        return [float(v) for m in lines for v in re.findall(rf"\b{key}{sep}(\S+)", m)]

    return {"device_ms": values("device_ms"), "peak_gib": values("peak_gib"),
            "data_t": values("data_t")[-1], "step_t": values("step_t")[-1],
            "losses": values("loss", ": ")}


def cli_argv(tag, recipe, tmp, steps, eval_groups, extra=(), flags=(), tensorboard=False):
    """(sample locations file, output dir, argv) of a recipe's command line
    for the child runs: --max-steps, --max-eval-batches, LOG_FREQ 1,
    TENSORBOARD.USE as the recipe writes it with `tensorboard`, else off,
    then `extra`; `flags` before the config."""
    root = os.path.dirname(os.path.abspath(__file__))
    key = re.sub(r"\W+", "_", tag)
    argv = [*flags, "--cfg", os.path.join(root, recipe), "--max-steps", str(steps),
            "--max-eval-batches", str(eval_groups), "LOG_FREQ", "1",
            *(() if tensorboard else ("TENSORBOARD.USE", "False")), *extra,
            "OUTPUT_DIR", os.path.join(tmp, f"out_{key}")]
    return os.path.join(tmp, f"locs_{key}.pt"), os.path.join(tmp, f"out_{key}"), argv


def recipe_jobs(name, specs, tmp, torchrun=False) -> dict:
    """Recipes (tag, recipe, steps, eval groups, extra) through `cli_jobs`,
    one process for all (a rank under torchrun, each command line with
    --multihost), each checked by `recipe_checked`; {tag: run}."""
    jobs = []
    for tag, recipe, steps, eval_groups, extra in specs:
        locs, _, argv = cli_argv(tag, recipe, tmp, steps, eval_groups, extra,
                                 flags=("--multihost",) if torchrun else ())
        jobs.append(dict(tag=tag, locs=locs, options={}, argv=argv))
    got = cli_jobs(name, jobs, tmp, torchrun)
    return {tag: recipe_checked(tag, steps, got[tag][0], got[tag][2], got[tag][1])
            for tag, _, steps, _, _ in specs}


def recipe_checked(tag, steps, c, wall, lines) -> dict:
    """A recipe's run that trains `steps` steps with both attention kernels
    and evaluates with finite metrics, from its counts, wall seconds and
    output lines; raises otherwise."""
    import torch

    if sum(line.startswith("RESULTS:") for line in lines) != 1:
        raise AssertionError(f"{tag}: no RESULTS line\n" + "\n".join(lines[-40:]))
    run = dict(results=c["results"], launches=c["launches"], tiles=c["tiles"],
               backward_launches=c["backward_launches"], trained=c["trained"],
               all_reduces=c["all_reduces"], wall=wall, steps=step_log(lines),
               locs=torch.load(c["locs"]))
    run["losses"] = run["steps"]["losses"]
    if not (run["launches"] > 0 and run["backward_launches"] == steps
            and len(run["losses"]) == steps and all(math.isfinite(v) for v in run["losses"])):
        raise AssertionError(f"{tag}: forward kernel launches {run['launches']}, backward "
                             f"{run['backward_launches']}, losses {run['losses']} over {steps} "
                             f"steps\n" + "\n".join(lines[-40:]))
    finite_metrics(tag, run["results"])
    return run


class _Spies:
    """The child's view of the port's main path: the first sample locations
    the attention took, the class of the module that trained, and the
    all-reduces that the port called outside DDP, each from the last
    `reset` on."""

    def __init__(self):
        import torch.distributed as dist

        from epipolar_transformers_tpu_torch.engine import trainer
        from epipolar_transformers_tpu_torch.models import epipolar as layer

        self.kept, self.trained, self.reduces = [], [], 0
        sample_locs, data_parallel, all_reduce = (layer.epipolar_sample_locs,
                                                  trainer.data_parallel, dist.all_reduce)

        def keep(*args, **kwargs):
            locs = sample_locs(*args, **kwargs)
            if not self.kept:
                self.kept.append(locs.detach().cpu())
            return locs

        def wrap(*args, **kwargs):
            module = data_parallel(*args, **kwargs)
            self.trained.append(type(module).__name__)
            return module

        def counted(*args, **kwargs):
            self.reduces += 1
            return all_reduce(*args, **kwargs)

        layer.epipolar_sample_locs, trainer.data_parallel, dist.all_reduce = keep, wrap, counted

    def reset(self):
        import torch

        from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn

        self.kept.clear()
        self.trained.clear()
        self.reduces = 0
        attn.LAUNCHES = attn.BACKWARD_LAUNCHES = 0
        attn.TILE_COUNTS.clear()
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()


def run_command_line(spies, locs_path, options, argv, profiles=None) -> dict:
    """The port's command line in this process; returns its counts: the
    kernels' launches and tiles, RESULTS, what `spies` saw (the sample
    locations saved to `locs_path`), the error and the profile.
    `options`: `expect_error`, the name of the error the command line must
    raise (a recipe that fails in both packages; its message is reported,
    any other error propagates); `profile`, then
    `utils.profiling.profile_model` of the config on the recipe's first
    train item after the run (kept in `profiles` by architecture)."""
    import torch

    from epipolar_transformers_tpu_torch import main as cli
    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn

    error = None
    if options.get("expect_error"):
        try:
            results = cli.main(argv)
        except Exception as exc:  # noqa: BLE001 - held to the expected error below
            if type(exc).__name__ != options["expect_error"]:
                raise
            error = f"{type(exc).__name__}: {exc}"
            results = None
        if error is None:
            raise AssertionError(f"the command line did not raise {options['expect_error']}")
    else:
        results = cli.main(argv)
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    counts = {"launches": attn.LAUNCHES, "backward_launches": attn.BACKWARD_LAUNCHES,
              "tiles": list(attn.tile_counts()), "results": results,
              "trained": list(spies.trained), "all_reduces": spies.reduces, "error": error,
              "locs": None, "profile": None}
    if spies.kept:
        torch.save(spies.kept[0], locs_path)
        counts["locs"] = locs_path
    if options.get("profile"):
        counts["profile"] = recipe_profile(argv, {} if profiles is None else profiles)
    return counts


def cli_jobs_main(jobs_path) -> int:
    """`--cli-jobs`: the command lines of a JSON list of jobs ({tag, locs,
    options, argv}) one after another in this process, each after a
    `CLI_JOB <tag>` line, with the kernels' counters and the peak memory
    at 0 just before it and its counts on a line just after; the process
    starts and imports once for all."""
    import gc

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(jobs_path) as f:
        jobs = json.load(f)
    spies, profiles = _Spies(), {}
    for job in jobs:
        print(f"CLI_JOB {time.perf_counter():.3f} {job['tag']}", flush=True)
        spies.reset()
        counts = run_command_line(spies, job["locs"], job["options"], job["argv"], profiles)
        print("RANK_COUNTS " + json.dumps(counts), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"CLI_JOB {time.perf_counter():.3f} end", flush=True)
    return 0


def recipe_profile(argv, profiles) -> dict:
    """`profile_model` of the command line's config on its first train
    item (the recipe's own data, read in this process); a config of an
    architecture already in `profiles` (the task, the input size and
    every section that builds the model) takes that count."""
    from epipolar_transformers_tpu_torch import main as cli
    from epipolar_transformers_tpu_torch.config import load_config
    from epipolar_transformers_tpu_torch.data.pipeline import build_dataset, collate
    from epipolar_transformers_tpu_torch.utils.profiling import profile_model

    args = cli.parse_args(argv)
    cfg = load_config(args.cfg, args.opts)
    key = repr((cfg.DATASETS.TASK, cfg.DATASETS.IMAGE_SIZE, cfg.BACKBONE, cfg.KEYPOINT,
                cfg.EPIPOLAR, cfg.LIFTING))
    if key not in profiles:
        ds = build_dataset(cfg, cfg.DATASETS.TRAIN[0])
        prof = profile_model(cfg, device=args.device, batch=collate([ds[0]]))
        profiles[key] = {k: (None if math.isnan(v) else v) for k, v in prof.items()}
    return profiles[key]


def describe(run) -> str:
    st = run["steps"]
    dev = st["device_ms"]
    timed = (f"device {statistics.mean(dev[1:]):.1f} ms a step after the first (CUDA events: "
             f"{', '.join(f'{v:.1f}' for v in dev)})" if len(dev) > 1 else
             f"device {dev[0]:.1f} ms for the one step (CUDA events; the first, with cuDNN's "
             f"algorithm search)")
    return (f"losses {', '.join(f'{v:.5g}' for v in run['losses'])}; MPJPE "
            f"{run['results']['EPEmean_global']:.4f} mm, JDR {run['results']['JDR']:.4f}, "
            f"finite; {timed}; loop wall "
            f"{1e3 * st['step_t']:.0f} ms a step, the loader's share "
            f"{st['data_t'] / st['step_t']:.2f}; peak {st['peak_gib'][-1]:.3f} GiB in training; "
            f"forward kernel launches {run['launches']}, backward {run['backward_launches']}; "
            f"forward tiles on the tile path / per-query path {run['tiles'][0]} / "
            f"{run['tiles'][1]}")


def summary(run) -> dict:
    """The numbers of a recipe's run for the kernels' line; the device ms
    a step after the first, where it took more than one."""
    st = run["steps"]
    dev = st["device_ms"][1:]
    return {"device_ms_per_step": statistics.mean(dev) if dev else None,
            "device_ms": st["device_ms"],
            "loop_ms_per_step": 1e3 * st["step_t"], "loader_share": st["data_t"] / st["step_t"],
            "peak_gib": st["peak_gib"][-1], "launches": run["launches"],
            "backward_launches": run["backward_launches"], "all_reduces": run["all_reduces"],
            "tiles": {"tile_path": run["tiles"][0], "per_query_path": run["tiles"][1]},
            "MPJPE": run["results"]["EPEmean_global"], "JDR": run["results"]["JDR"],
            "seconds": run["wall"]}


def attention_at(tag, cfg, locs, device):
    """The attention alone at a recipe's shape, on the sample locations of
    its first train batch, whole (C = NFEATS f32 features, keys = values
    one tensor, channels_last as the model hands them over): the kernels'
    forward and backward on the whole batch against the plain version on
    slices of PLAIN_SLICE items (each item's output and gradients depend on
    that item alone; the plain version of a batch of 32 at 96x96 would not
    fit), [2]/[5]'s tolerances; two kernel runs bit-equal, the forward's
    tiles on each path, the times and the bounds of the whole batch.
    Returns the forward's and the backward's entries for the kernels'
    line."""
    import torch

    from epipolar_transformers_tpu_torch.models.epipolar import Epipolar
    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn

    locs = locs.to(device)
    B, K, H, W, _ = locs.shape
    C = cfg.KEYPOINT.NFEATS
    params = Epipolar(cfg).attention_params
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    f1, f2 = (torch.randn(B, C, H, W, device=device, generator=gen)
              .contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
              for _ in range(2))
    slices = [slice(i, min(i + PLAIN_SLICE, B)) for i in range(0, B, PLAIN_SLICE)]
    shape = f"B={B} {H}x{W} K={K} C={C} f32"

    def kernel():
        return attn.epipolar_attention_batch(f1, f2, f2, locs, params)

    def plain():
        outs = [attn.epipolar_attention_plain_batch(f1[s], f2[s], f2[s], locs[s], params)
                for s in slices]
        return [torch.cat(parts) for parts in zip(*outs)]

    attn.TILE_COUNTS.clear()
    got = kernel()
    tiles = attn.tile_counts()
    want = plain()
    ties, tie_rows, tie_sims = mask_ties(tag, f1, f2, locs, got[2], want[2])
    keep = ~ties
    err = max(close(f"{tag} out", got[0][keep], want[0][keep], **F32_TOL),
              close(f"{tag} depth", got[2].permute(0, 2, 3, 1)[keep],
                    want[2].permute(0, 2, 3, 1)[keep], **F32_TOL))
    agree = agreement(f"{tag} corr_pos", got[1], want[1], 1e-3)
    if not all(torch.equal(a, b) for a, b in zip(got, kernel())):
        raise AssertionError(f"{tag} two forward runs on the same inputs differ")
    if sum(tiles) != B * -(-H * W // attn.TILE_QUERIES):
        raise AssertionError(f"{tag} forward tiles {tiles}")
    r = torch.randn(got[0].shape, device=device,
                    generator=torch.Generator(device=device).manual_seed(SEED + 1))
    del got, want

    def graph(fn, s):
        """(out, leaves, cotangent) of `fn` on the items `s`."""
        q, kv = (f[s].detach().clone().requires_grad_() for f in (f1, f2))
        return fn(q, kv, kv, locs[s], params)[0], (q, kv), r[s]

    def grads(fn, parts):
        gs = []
        for s in parts:
            out, leaves, cot = graph(fn, s)
            gs.append(torch.autograd.grad(out, leaves, cot))
        return [torch.cat(g) for g in zip(*gs)]

    whole = [slice(0, B)]
    got_g = grads(attn.epipolar_attention_batch, whole)
    want_g = grads(attn.epipolar_attention_plain_batch, slices)
    rows_kept = ~tie_rows.reshape(B, H, W)
    bwd_err = close_grads(f"{tag} keys = values one tensor",
                          [got_g[0][keep], got_g[1][rows_kept], None],
                          [want_g[0][keep], want_g[1][rows_kept], None], **GRAD_F32_TOL)
    del want_g
    if not all(torch.equal(a, b) for a, b in
               zip(got_g, grads(attn.epipolar_attention_batch, whole))):
        raise AssertionError(f"{tag} two backward runs on the same inputs differ")
    del got_g

    def backward_only(fn, s):
        out, leaves, cot = graph(fn, s)
        return lambda: torch.autograd.grad(out, leaves, cot, retain_graph=True)

    # the forward in turns; the backward of the whole batch around the plain
    # version's slices, one slice's graph held at a time
    fk, fp = in_turns(kernel, plain)
    bk_first = cuda_ms(backward_only(attn.epipolar_attention_batch, whole[0]))
    bp = sum(cuda_ms(backward_only(attn.epipolar_attention_plain_batch, s)) for s in slices)
    bk = (bk_first + cuda_ms(backward_only(attn.epipolar_attention_batch, whole[0]))) / 2
    fwd_bound, bwd_bound = bound([f1, f2, f2], locs, False), bound([f1, f2], locs, True)
    held = (f"; held out, where the two decide the zero-sentinel mask differently on a "
            f"similarity within f32 rounding of 0 (f64 {', '.join(f'{v:.3g}' for v in tie_sims)}): "
            f"{int(ties.sum())} queries and the {int(tie_rows.sum())} key rows their samples touch"
            if tie_sims else "; no query held out (no mask tie)")
    log(f"  {tag} attention alone at {shape} on the recipe's first batch of sample locations, "
        f"the plain version on slices of {PLAIN_SLICE}: forward max abs err {err:.3g}, corr_pos "
        f"agree {agree:.4f}, backward (keys = values one tensor) max abs err {bwd_err:.3g}{held}; two "
        f"kernel runs bit-equal each way; forward tiles on the tile path / per-query path "
        f"{tiles[0]} / {tiles[1]}; times of the batch (CUDA events, 2x20 calls, the forward in "
        f"turns): forward kernel {fk:.4f} ms, plain {fp:.4f} ms, bound {fwd_bound[0]:.4f} ms "
        f"({fwd_bound[1]}); backward kernel {bk:.4f} ms, plain autograd {bp:.4f} ms, bound "
        f"{bwd_bound[0]:.4f} ms ({bwd_bound[1]})")
    torch.cuda.empty_cache()
    tile_entry = {"tile_path": tiles[0], "per_query_path": tiles[1]}
    return ({"shape": shape, "ms": fk, "plain_ms": fp, "bound_ms": fwd_bound[0],
             "bound_by": fwd_bound[1], "max_abs_err": err, "tiles": tile_entry,
             "mask_ties": {"queries": int(ties.sum()), "key_rows": int(tie_rows.sum()),
                           "f64_similarities": tie_sims}},
            {"shape": shape, "ms": bk, "plain_ms": bp, "bound_ms": bwd_bound[0],
             "bound_by": bwd_bound[1], "max_abs_err": bwd_err})


def mask_ties(tag, f1, f2, locs, depth_k, depth_p):
    """Where the kernel and the plain version decide the zero-sentinel mask
    (masked = sim == 0 ? -1e10 : sim) differently: a sample whose weight is
    exactly 0 on one side and not negligible (> 1e-30, not an underflow) on
    the other.  Each such sample's similarity, recomputed in f64, must lie
    within the f32 rounding bound of its sum (gamma_C = C u / (1 - C u),
    u = 2^-24, times the sum of |w_c f1_i f2_i|), where either side's f32
    sum may be exactly 0; otherwise this raises.  Returns the (B, H, W)
    queries of those samples, the (B, HW) key rows that any live corner of
    their samples touches (their gradients move with the query's weights),
    and the f64 similarities."""
    import torch

    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn

    B, K, H, W, _ = locs.shape
    C = f1.shape[-1]
    split = ((depth_k == 0) & (depth_p > 1e-30)) | ((depth_p == 0) & (depth_k > 1e-30))
    b, k, h, w = torch.nonzero(split, as_tuple=True)
    q = h * W + w
    rows, wc = attn._corners(locs.reshape(B, K, H * W, 2), H, W)  # (B, HW, K, 4)
    terms = (f2.reshape(B, H * W, C)[b[:, None], rows[b, q, k]].double()
             * f1.reshape(B, H * W, C)[b, q].double()[:, None])  # (n, 4, C)
    corner = wc[b, q, k].double()
    sims = (terms.sum(-1) * corner).sum(-1)
    u = 2.0 ** -24
    bound = C * u / (1 - C * u) * (terms.abs().sum(-1) * corner.abs()).sum(-1)
    if bool((sims.abs() > bound).any()):
        raise AssertionError(f"{tag} the kernel and the plain version mask different samples "
                             f"whose similarities are not 0 within f32 rounding: f64 "
                             f"{sims.tolist()[:8]}, bounds {bound.tolist()[:8]}")
    ties = torch.zeros(B, H, W, dtype=torch.bool, device=locs.device)
    ties[b, h, w] = True
    touched = torch.zeros(B, H * W, dtype=torch.bool, device=locs.device)
    tb, tq = torch.nonzero(ties.reshape(B, H * W), as_tuple=True)
    live = wc[tb, tq] != 0  # (n, K, 4)
    touched[tb[:, None, None].expand_as(live)[live], rows[tb, tq][live]] = True
    return ties, touched, sims.tolist()


def gloo_rank_main(rank: int, world: int, port: int, workdir: str) -> int:
    """[14](c), one rank: join the gloo group on `port`, take the rank's
    contiguous share of the batch in `workdir`, and train GLOO_STEPS steps
    of the recipe under DDP on cuda:0; after the first step write the loss,
    the ranks' mean loss, the all-reduced gradients and the BN running
    statistics, after the last check that all ranks hold bit-equal
    parameters and buffers."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from epipolar_transformers_tpu_torch import parallel
    from epipolar_transformers_tpu_torch.config import load_config
    from epipolar_transformers_tpu_torch.engine import trainer
    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn

    root = os.path.dirname(os.path.abspath(__file__))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        device = torch.device("cuda", 0)
        cfg = load_config(os.path.join(root, R152_DDP_RECIPE),
                          ["SOLVER.IMS_PER_BATCH", str(GLOO_BATCH)])
        batch = torch.load(os.path.join(workdir, "gloo_batch.pt"), weights_only=False)
        n = GLOO_BATCH // world
        inputs = trainer.model_inputs({k: v[rank * n:(rank + 1) * n] for k, v in batch.items()},
                                      device, None)
        model = trainer.build_model(cfg, device)
        trainer.load_weights(cfg, model)
        step = trainer.make_train_step(cfg, trainer.data_parallel(cfg, model, device),
                                       trainer.make_optimizer(cfg, model))
        attn.LAUNCHES = attn.BACKWARD_LAUNCHES = 0
        attn.TILE_COUNTS.clear()
        out, ms = {"rank": rank}, []
        for i in range(GLOO_STEPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            metrics = step(inputs)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            if i == 0:
                out["loss"] = float(metrics["loss"])
                out["mean_loss"] = parallel.mean_over_ranks(metrics)["loss"]
                if rank == 0:
                    out["grads"] = {k: p.grad.detach().cpu() for k, p in model.named_parameters()
                                    if p.grad is not None}
                    out["bn"] = {k: v.detach().cpu() for k, v in model.state_dict().items()
                                 if k.endswith(("running_mean", "running_var"))}
        parallel.check_same_on_every_rank(model)
        out.update(same_after_steps=True, ms=ms, launches=attn.LAUNCHES,
                   backward_launches=attn.BACKWARD_LAUNCHES, tiles=list(attn.tile_counts()))
        torch.save(out, os.path.join(workdir, f"gloo_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def gloo_phase(tmp, device):
    """[14](c): one global batch of GLOO_BATCH from the loader, through one
    rank (this process, no group) and through GLOO_RANKS ranks on the one
    card over gloo, each taking its share as the loader splits it.  The
    ranks' mean loss against the one rank's (STEP_LOSS_RTOL); the gradients
    after the all-reduce and the BN running statistics against the one
    rank's, by relative L2, over the model and each parameter within
    STEP_GRAD_REL_L2; the ranks' parameters and buffers bit-equal after
    GLOO_STEPS steps."""
    import numpy as np
    import torch

    from epipolar_transformers_tpu_torch.config import DatasetCatalog, load_config
    from epipolar_transformers_tpu_torch.data import pipeline
    from epipolar_transformers_tpu_torch.engine import trainer
    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(root, R152_DDP_RECIPE),
                      ["SOLVER.IMS_PER_BATCH", str(GLOO_BATCH), "BACKBONE.PRETRAINED_WEIGHTS",
                       os.path.join(tmp, R152_WEIGHTS)])
    saved, DatasetCatalog.DATA_DIR = DatasetCatalog.DATA_DIR, os.path.join(tmp, "datasets")
    try:
        ds = pipeline.build_dataset(cfg, cfg.DATASETS.TRAIN[0])
    finally:
        DatasetCatalog.DATA_DIR = saved
    whole = pipeline.TrainLoader(ds, GLOO_BATCH, cfg.SEED, 4)
    shares = [pipeline.TrainLoader(ds, GLOO_BATCH, cfg.SEED, local_rank=r,
                                   local_world=GLOO_RANKS).index_batches()[0]
              for r in range(GLOO_RANKS)]
    if not (np.concatenate(shares) == whole.index_batches()[0]).all():
        raise AssertionError("[14](c) the ranks' shares are not the batch")
    batch = next(iter(whole))
    pipeline.stop_workers()
    torch.save(batch, os.path.join(tmp, "gloo_batch.pt"))

    model = trainer.build_model(cfg, device)
    trainer.load_weights(cfg, model)
    attn.LAUNCHES = attn.BACKWARD_LAUNCHES = 0
    attn.TILE_COUNTS.clear()

    def loss_and_grads(inputs):
        model.zero_grad(set_to_none=True)
        loss = model(inputs)[0]["loss"]
        loss.backward()
        return float(loss), {k: p.grad.detach().cpu() for k, p in model.named_parameters()
                             if p.grad is not None}

    inputs = trainer.model_inputs(batch, device, None)
    loss, grads = loss_and_grads(inputs)
    torch.cuda.synchronize()
    one = dict(launches=attn.LAUNCHES, backward_launches=attn.BACKWARD_LAUNCHES,
               tiles=list(attn.tile_counts()))
    bn = {k: v.detach().cpu() for k, v in model.state_dict().items()
          if k.endswith(("running_mean", "running_var"))}
    del model, inputs
    torch.cuda.empty_cache()

    port = free_port()
    cmds = [[sys.executable, os.path.join(root, "chip_smoke.py"), "--gloo-rank", str(r),
             str(GLOO_RANKS), str(port), tmp] for r in range(GLOO_RANKS)]
    t0 = time.perf_counter()
    run_children("[14](c) gloo ranks", cmds, tmp, child_env())
    wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(tmp, f"gloo_rank{r}.pt"), weights_only=False)
             for r in range(GLOO_RANKS)]

    mean_loss = ranks[0]["mean_loss"]
    if abs(mean_loss - loss) > STEP_LOSS_RTOL * abs(loss) or not math.isfinite(mean_loss):
        raise AssertionError(f"[14](c) loss: {GLOO_RANKS} ranks' mean {mean_loss}, one rank {loss}")
    got = ranks[0]["grads"]
    if set(got) != set(grads):
        raise AssertionError("[14](c) the runs give gradients to different parameters")
    floor = STEP_NOISE_FLOOR * max(float(g.abs().max()) for g in grads.values())
    noise = {k for k in grads if k in ZERO_GRAD_PARAMS
             or max(float(got[k].abs().max()), float(grads[k].abs().max())) < floor}
    keys = [k for k in grads if k not in noise]
    whole_err = rel_l2(torch.cat([got[k].flatten() for k in keys]),
                    torch.cat([grads[k].flatten() for k in keys]))
    errs = {k: rel_l2(got[k], grads[k]) for k in keys}
    over = {k: e for k, e in errs.items() if e > STEP_GRAD_REL_L2}
    worst = max(errs, key=errs.get)
    bn_errs = {k: rel_l2(ranks[0]["bn"][k], v) for k, v in bn.items()}
    bn_worst = max(bn_errs, key=bn_errs.get)
    line = (f"gradients after the all-reduce: relative L2 {whole_err:.3g} over the model, "
            f"worst parameter {errs[worst]:.3g} ({worst}) over {len(errs)} parameters ({len(noise)} "
            f"with a true gradient of 0 left out); BN running statistics worst "
            f"{bn_errs[bn_worst]:.3g} ({bn_worst}) over {len(bn_errs)}")
    if whole_err > STEP_GRAD_REL_L2 or over or bn_errs[bn_worst] > STEP_GRAD_REL_L2:
        raise AssertionError(f"[14](c) {line}; over their limit: "
                             + ", ".join(f"{k} {e:.3g}" for k, e in sorted(over.items())[:10]))
    if not all(r["same_after_steps"] and r["launches"] > 0 and
               r["backward_launches"] == GLOO_STEPS for r in ranks):
        raise AssertionError(f"[14](c) ranks' launches "
                             f"{[(r['launches'], r['backward_launches']) for r in ranks]}")
    if not (one["launches"] > 0 and one["backward_launches"] == 1):
        raise AssertionError(f"[14](c) one rank's kernel launches {one}")
    log(f"  (c) {R152_DDP_RECIPE} at a batch of {GLOO_BATCH}: one rank x {GLOO_BATCH} here, "
        f"{GLOO_RANKS} ranks x {GLOO_BATCH // GLOO_RANKS} on the one card over gloo "
        f"(processes of their own, {wall:.1f} s, rc 0, no process left): loss {loss:.6g}, the "
        f"ranks' mean {mean_loss:.6g} ({', '.join(f'{r['loss']:.6g}' for r in ranks)} each); "
        f"{line}; parameters and buffers bit-equal across the ranks after {GLOO_STEPS} steps; "
        f"kernel launches one rank {one['launches']} / {one['backward_launches']}, each rank "
        f"{ranks[0]['launches']} / {ranks[0]['backward_launches']}; a rank's step "
        f"{', '.join(f'{v:.1f}' for v in ranks[0]['ms'])} ms (CUDA events; gloo collectives "
        f"through the host)")
    return {"loss_one_rank": loss, "loss_ranks_mean": mean_loss, "grad_rel_l2": whole_err,
            "grad_worst_rel_l2": errs[worst],
            "bn_worst_rel_l2": bn_errs[bn_worst], "rank_step_ms": ranks[0]["ms"],
            "seconds": wall,
            "launches": one["launches"] + sum(r["launches"] for r in ranks),
            "backward_launches": (one["backward_launches"]
                                  + sum(r["backward_launches"] for r in ranks)),
            "tiles": [one["tiles"][i] + sum(r["tiles"][i] for r in ranks) for i in range(2)]}


def r152_phase(device):
    """[14]: the ResNet-152 recipes as written, their command lines in
    processes of their own started in the fake tree's directory (the
    torchrun rank in one, the others one after another in another).  (a)
    R152_RECIPE, and the attention alone at its shape; (b) R152_DDP_RECIPE
    at DDP_BATCH under torchrun with --multihost (DDP and BatchNorm's
    all-reduces on one NCCL rank) beside the same without;
    (c) two ranks on the one card over gloo against one rank; (d)
    R152_320_RECIPE (80x80) and K85_RECIPE (K=85), a step and an eval group
    each, and the attention alone at their shapes.  Returns the main path's
    launches and tiles and the numbers for the kernels' line."""
    from epipolar_transformers_tpu_torch.config import load_config

    root = os.path.dirname(os.path.abspath(__file__))
    start = time.perf_counter()
    out, entries, runs = {}, [], []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_fake_h36m(os.path.join(tmp, "datasets"), R152_TRAIN_GROUPS, R152_VAL_GROUPS,
                        H36M_IMAGE_SIZE, distinct_groups=R152_DISTINCT)
        write_torchvision_resnet(os.path.join(tmp, R152_WEIGHTS), 152)
        log(f"  fake H36M tree: {R152_TRAIN_GROUPS} train and {R152_VAL_GROUPS} validation groups "
            f"of 4 views ({R152_DISTINCT[0]} and {R152_DISTINCT[1]} distinct), "
            f"{H36M_IMAGE_SIZE + 2}x{H36M_IMAGE_SIZE} JPEG frames, and a seeded random "
            f"torchvision-layout R-152 at {R152_WEIGHTS}, written in "
            f"{time.perf_counter() - t0:.1f} s")

        # (b) without --multihost, (a) and (d): one process for their command
        # lines, (b)'s first, so that it starts as the torchrun rank does
        # (a new process, cuDNN and the allocator cold)
        batch = ["SOLVER.IMS_PER_BATCH", str(DDP_BATCH)]
        d_specs = (("r152_320_fixed_8gpu", R152_320_RECIPE, "batch 32, 320 px, 80x80, K=64"),
                   ("r50_384_strong_fixed", K85_RECIPE, "R-50, batch 8, 384 px, 96x96, K=85"))
        single = recipe_jobs("[14]", [
            ("[14](b) without --multihost", R152_DDP_RECIPE, DDP_STEPS, R152_EVAL_GROUPS, batch),
            ("[14](a)", R152_RECIPE, R152_STEPS, R152_EVAL_GROUPS, ()),
            *((f"[14](d) {key}", recipe, 1, 1, ()) for key, recipe, _ in d_specs)], tmp)

        # (a) the 384 fixed recipe as written
        a = single["[14](a)"]
        runs.append(a)
        log(f"  (a) {R152_RECIPE} as written (batch 8, 384 px, 96x96, K=64, NUM_WORKERS 14) "
            f"through the command line in {a['wall']:.1f} s: {describe(a)}")
        out["r152_384_fixed"] = summary(a)
        entries.append(attention_at("(a)", load_config(os.path.join(root, R152_RECIPE)),
                                    a.pop("locs"), device))

        # (b) the _8gpu recipe under torchrun, and without --multihost
        b = recipe_jobs("[14](b) torchrun", [("[14](b) torchrun", R152_DDP_RECIPE, DDP_STEPS,
                                              R152_EVAL_GROUPS, batch)], tmp,
                        torchrun=True)["[14](b) torchrun"]
        plain = single["[14](b) without --multihost"]
        runs += [b, plain]
        for r in (b, plain):
            del r["locs"]
        if not (b["trained"] == ["DistributedDataParallel"] and b["all_reduces"] > 0
                and "DistributedDataParallel" not in plain["trained"]
                and plain["all_reduces"] == 0):
            raise AssertionError(f"[14](b) trained {b['trained']} with {b['all_reduces']} "
                                 f"all-reduces under torchrun, {plain['trained']} with "
                                 f"{plain['all_reduces']} without")
        gap = (statistics.mean(b["steps"]["device_ms"][1:])
               - statistics.mean(plain["steps"]["device_ms"][1:]))
        log(f"  (b) torchrun --nproc_per_node 1 ... --multihost {R152_DDP_RECIPE} (NCCL, world 1, "
            f"global batch {DDP_BATCH}, {DDP_STEPS} steps, each an epoch: rank 0's checkpoint "
            f"and eval between them) in {b['wall']:.1f} s, rc 0, no process left: the model "
            f"under {b['trained'][0]}, {b['all_reduces']} all-reduces outside DDP's (BatchNorm's "
            f"moments, the logged means); {describe(b)}")
        log(f"  (b) the same without --multihost in {plain['wall']:.1f} s ({plain['trained'][0]}, "
            f"no collective): {describe(plain)}")
        log(f"  (b) DDP and BatchNorm's collectives on one NCCL rank against none, each the "
            f"first command line of a new process: {gap:+.1f} ms a device step, "
            f"{b['steps']['peak_gib'][-1] - plain['steps']['peak_gib'][-1]:+.3f} GiB")
        out["r152_8gpu_torchrun"] = {**summary(b), "without_multihost": summary(plain)}

        # (c) two ranks on the one card over gloo
        out["r152_gloo_ranks"] = c = gloo_phase(tmp, device)

        # (d) 80x80 and K=85
        for key, recipe, what in d_specs:
            d = single[f"[14](d) {key}"]
            runs.append(d)
            log(f"  (d) {recipe} as written ({what}): one step and one eval group through "
                f"the command line in {d['wall']:.1f} s: {describe(d)}")
            out[key] = summary(d)
            entries.append(attention_at(f"(d) {key}", load_config(os.path.join(root, recipe)),
                                        d.pop("locs"), device))
    out["phase_seconds"] = time.perf_counter() - start
    log(f"  [14] took {out['phase_seconds']:.1f} s")
    return dict(launches=sum(r["launches"] for r in runs) + c["launches"],
                backward_launches=(sum(r["backward_launches"] for r in runs)
                                   + c["backward_launches"]),
                tiles=[sum(r["tiles"][i] for r in runs) + c["tiles"][i] for i in range(2)],
                numbers=out, forward_entries=[e[0] for e in entries],
                backward_entries=[e[1] for e in entries])


def a11d_job(tag, recipe, tmp, error, flags=()):
    """One of [15]'s recipes as written, as a job of `cli_jobs`: steps and
    eval groups as A11D_* say, TENSORBOARD.USE as written, the profile of
    its config after the run (where it trains); `error`, the error its
    command line raises in both packages, else None."""
    from epipolar_transformers_tpu_torch.config import load_config

    cfg = load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), recipe))
    steps = A11D_RHD_STEPS if "RHD_train" in cfg.DATASETS.TRAIN else A11D_STEPS
    early = recipe in A11D_ERRORS  # the error comes before the first step
    locs, out_dir, argv = cli_argv(tag, recipe, tmp, steps, A11D_EVAL_GROUPS, flags=flags,
                                   tensorboard=True)
    return dict(tag=tag, recipe=recipe, locs=locs, out_dir=out_dir, argv=argv, cfg=cfg,
                steps=steps, error=error, early=early,
                options={"expect_error": error, "profile": not early})


def cli_jobs(name, jobs, tmp, torchrun=False) -> dict:
    """The jobs' command lines one after another in one process of its own
    started in `tmp` (which holds their datasets/; this script's
    `--cli-jobs` mode), as a user runs them, or that process as the one
    rank of `torchrun --nproc_per_node 1`: a process start and its imports
    for all.  Returns {tag: (counts, output lines, wall seconds)}."""
    root = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(tmp, "jobs_" + re.sub(r"\W+", "_", name) + ".json")
    with open(path, "w") as f:
        json.dump([{k: j[k] for k in ("tag", "locs", "options", "argv")} for j in jobs], f)
    entry = [os.path.join(root, "chip_smoke.py"), "--cli-jobs", path]
    launcher = (["-m", "torch.distributed.run", "--nproc_per_node", "1", "--master_port",
                 str(free_port())] if torchrun else [])
    (out,) = run_children(name, [[sys.executable, *launcher, *entry]], tmp, child_env(),
                          timeout=JOBS_TIMEOUT)
    marks = [(i, float(line.split()[1]), line.split(" ", 2)[2])
             for i, line in enumerate(out.splitlines()) if line.startswith("CLI_JOB ")]
    lines = out.splitlines()
    got = {}
    for (i, t0, tag), (j, t1, _) in zip(marks, marks[1:]):
        section = lines[i + 1:j]
        counts = [json.loads(line.split(" ", 1)[1]) for line in section
                  if line.startswith("RANK_COUNTS ")]
        if len(counts) != 1:
            raise AssertionError(f"{tag}: {len(counts)} RANK_COUNTS lines\n"
                                 + "\n".join(section[-40:]))
        got[tag] = (counts[0], section, t1 - t0)
    if sorted(got) != sorted(j["tag"] for j in jobs):
        raise AssertionError(f"{name}: ran {sorted(got)}\n{out[-3000:]}")
    return got


def a11d_check(job, counts, lines, wall) -> dict:
    """A [15] job's run, checked: a recipe that fails in both packages must
    have raised its pinned error; every step's loss is finite, a
    multiview recipe launched the forward kernel and one backward a step,
    the others none; the others print RESULTS with finite metrics."""
    tag, recipe, error, steps, cfg = (job[k] for k in ("tag", "recipe", "error", "steps", "cfg"))
    run = dict(counts, wall=wall, lines=lines, out_dir=job["out_dir"], cfg=cfg, recipe=recipe)
    if error is not None:
        want = A11D_ERRORS[recipe if job["early"] else error]
        got = counts["error"]
        if not (got and got.startswith(error) and want in got):
            raise AssertionError(f"{tag}: error {got!r}, expected {error} with {want!r}")
    if job["early"]:
        run["steps"] = None
        return run
    run["steps"] = st = step_log(lines)
    multiview = cfg.DATASETS.TASK == "multiview_keypoint"
    if not (len(st["losses"]) == steps and all(math.isfinite(v) for v in st["losses"])
            and (counts["launches"] > 0) == multiview
            and counts["backward_launches"] == (steps if multiview else 0)):
        raise AssertionError(f"{tag}: losses {st['losses']}, forward kernel launches "
                             f"{counts['launches']}, backward {counts['backward_launches']}\n"
                             + "\n".join(lines[-40:]))
    if error is None:
        if sum(line.startswith("RESULTS:") for line in lines) != 1:
            raise AssertionError(f"{tag}: no RESULTS line\n" + "\n".join(lines[-40:]))
        if "lifting" in cfg.DATASETS.TASK:
            if "EPEmean_can" not in counts["results"] or not all(
                    math.isfinite(v) for v in counts["results"].values()):
                raise AssertionError(f"{tag}: RESULTS {counts['results']}")
        else:
            finite_metrics(tag, counts["results"])
    return run


def a11d_numbers(run) -> dict:
    """A [15] run's numbers: the device ms a step after the first (CUDA
    events), the peak, the loop's wall a step and the loader's share,
    the profile's FLOPs an item and the step's achieved TFLOP/s (three
    times the eval forward's FLOPs an item, the backward counted as twice
    the forward, times the batch, over the device ms), the kernels'
    launches and tiles, the metrics or the pinned error."""
    out = {"seconds": run["wall"], "launches": run["launches"],
           "backward_launches": run["backward_launches"],
           "tiles": {"tile_path": run["tiles"][0], "per_query_path": run["tiles"][1]},
           "error": run["error"], "results": run["results"]}
    st = run["steps"]
    if st is None:
        return out
    dev = st["device_ms"][1:]
    step_ms = statistics.mean(dev) if dev else None
    prof = run["profile"] or {}
    flops = prof.get("flops")
    batch = run["cfg"].SOLVER.IMS_PER_BATCH
    out.update(device_ms_per_step=step_ms, device_ms=st["device_ms"],
               peak_gib=st["peak_gib"][-1], loop_ms_per_step=1e3 * st["step_t"],
               loader_share=st["data_t"] / st["step_t"], losses=st["losses"],
               flops_per_item=flops, params=prof.get("params"),
               attention_flops_per_item=prof.get("attention_flops"),
               step_tflops_per_s=(3 * flops * batch / (step_ms * 1e-3) / 1e12
                                  if flops and step_ms else None))
    return out


def a11d_line(n) -> str:
    """One recipe's line of [15]."""
    parts = []
    if n.get("device_ms_per_step") is not None:
        parts.append(f"device {n['device_ms_per_step']:.1f} ms a step after the first (CUDA "
                     f"events: {', '.join(f'{v:.1f}' for v in n['device_ms'])}), peak "
                     f"{n['peak_gib']:.3f} GiB, loop wall {n['loop_ms_per_step']:.0f} ms a step, "
                     f"the loader's share {n['loader_share']:.2f}; losses (window medians) "
                     f"{', '.join(f'{v:.5g}' for v in n['losses'])}")
        if n["flops_per_item"]:
            parts.append(f"profile_model {n['flops_per_item'] / 1e9:.3f} GFLOP an item "
                         f"(attention {n['attention_flops_per_item'] / 1e9:.4f}), "
                         f"{n['params']} parameters; ~{n['step_tflops_per_s']:.2f} TFLOP/s in "
                         f"the step (3x the forward's FLOPs)")
    parts.append(f"forward kernel launches {n['launches']}, backward "
                 f"{n['backward_launches']}; tiles on the tile path / per-query path "
                 f"{n['tiles']['tile_path']} / {n['tiles']['per_query_path']}")
    if n["error"]:
        parts.append(f"raised, as in the JAX package: {n['error'][:160]}")
    else:
        parts.append("RESULTS " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(
            n["results"].items()) if not k.startswith(("PCK@", "MPJPE@")) or k in (
                "PCK@10",)))
    return "; ".join(parts)


def corr_pos_19mm(tmp, device) -> dict:
    """[15]: the 19 mm recipe's eval on one validation group, kernel route
    against plain route on the same weights (the recipe's model from its
    seed and the pose-ResNet file): corr_pos within CORR_POS_TOL as [8]
    holds it, and the 3D of its `epipolar` triangulation (CONF_THRES .85,
    RANSAC_THRES 35) per joint within EPIPOLAR_3D_MM.  These launches
    compare the kernel with its plain version and are not counted."""
    import numpy as np
    import torch

    from epipolar_transformers_tpu_torch.config import DatasetCatalog, load_config
    from epipolar_transformers_tpu_torch.data.pipeline import build_dataset
    from epipolar_transformers_tpu_torch.engine import tester, trainer
    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(root, A11D_19MM), [
        "BACKBONE.PRETRAINED_WEIGHTS", os.path.join(tmp, POSE_RESNET_WEIGHTS), "OUTPUT_DIR", ""])
    saved, DatasetCatalog.DATA_DIR = DatasetCatalog.DATA_DIR, os.path.join(tmp, "datasets")
    try:
        group = build_dataset(cfg, cfg.DATASETS.TEST[0])[0]
    finally:
        DatasetCatalog.DATA_DIR = saved
    model = trainer.build_model(cfg, device)
    trainer.load_weights(cfg, model)
    step = tester.make_eval_step(cfg, model, device)
    layer = model.reference.epipolar_sampler
    outs = []
    for plain in (False, True):
        if plain:
            layer.attention = attn.epipolar_attention_plain_batch
        out = step(group)
        outs.append({k: out[k].float().cpu().numpy() for k in ("batch_locs", "score_pred",
                                                               "corr_pos")})
    del layer.attention
    agree = agreement("[15] 19 mm recipe corr_pos", torch.from_numpy(outs[0]["corr_pos"]),
                      torch.from_numpy(outs[1]["corr_pos"]), CORR_POS_TOL)
    pred = [tester._triangulate(cfg, group, o["batch_locs"].astype(np.float64),
                                o["score_pred"].astype(np.float64), o) for o in outs]
    gap = np.linalg.norm(pred[0] - pred[1], axis=-1)
    if not (np.isfinite(pred[0]).all() and gap.max() <= EPIPOLAR_3D_MM):
        raise AssertionError(f"[15] 19 mm recipe 3D kernel route against plain route: "
                             f"{np.round(gap, 4).tolist()} mm")
    target = np.asarray(group["points-3d"], dtype=np.float64)[0]
    mpjpe = float(np.minimum(np.linalg.norm(pred[0] - target, axis=-1),
                             cfg.TEST.EPEMEAN_MAX_DIST).mean())
    del model
    torch.cuda.empty_cache()
    return {"corr_pos_agree": agree, "max_3d_gap_mm": float(gap.max()), "mpjpe_mm": mpjpe}


def a11d_phase(device):
    """[15]: the fifteen recipes as written, their command lines one after
    another in one process of their own started in the fake trees'
    directory, and the tooling on the card: (a) a recipe under --trace,
    (b) VIS.FLOPS, (c) DATALOADER.BENCHMARK, (d) the event files.  Returns
    the main path's launches and tiles and the numbers for the kernels'
    line."""
    import numpy as np
    import torch

    from epipolar_transformers_tpu_torch import main as cli
    from epipolar_transformers_tpu_torch.config import flagship_cfg
    from epipolar_transformers_tpu_torch.utils.metric_logger import read_scalars
    from epipolar_transformers_tpu_torch.utils.profiling import profile_model, trace_summary

    root = os.path.dirname(os.path.abspath(__file__))
    start = time.perf_counter()
    out, runs = {"recipes": {}}, []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = os.path.join(tmp, "datasets")
        write_fake_h36m(data, A11D_TRAIN_GROUPS, A11D_VAL_GROUPS, H36M_IMAGE_SIZE,
                        distinct_groups=R152_DISTINCT)
        write_fake_rhd(data, RHD_ITEMS)
        write_pose_resnet(os.path.join(tmp, POSE_RESNET_WEIGHTS), 152)
        log(f"  fake H36M tree ({A11D_TRAIN_GROUPS} train, {A11D_VAL_GROUPS} validation groups, "
            f"{R152_DISTINCT[0]} and {R152_DISTINCT[1]} distinct, {H36M_IMAGE_SIZE + 2}x"
            f"{H36M_IMAGE_SIZE} JPEGs), fake RHD tree ({RHD_ITEMS} + {RHD_ITEMS} samples) and a "
            f"seeded pose-ResNet-152 at {POSE_RESNET_WEIGHTS}, written in "
            f"{time.perf_counter() - t0:.1f} s")
        trace_dir = os.path.join(tmp, "trace")
        jobs = [a11d_job(f"[15] {recipe[len('configs/'):-len('.yaml')]}", recipe, tmp, error,
                         ("--trace", trace_dir) if recipe == A11D_TRACE_RECIPE else ())
                for recipe, error in A11D_RECIPES]
        # (c) DATALOADER.BENCHMARK with the recipe's 15 workers: the loader alone
        _, _, bench_argv = cli_argv("[15](c)", A11D_BENCHMARK_RECIPE, tmp,
                                    A11D_BENCHMARK_BATCHES, 0,
                                    ("DATALOADER.BENCHMARK", "True", "DOTEST", "False"))
        bench_job = dict(tag="[15](c) DATALOADER.BENCHMARK", locs="", options={},
                         argv=bench_argv)
        got = cli_jobs("[15]", jobs + [bench_job], tmp)
        for job in jobs:
            run = a11d_check(job, *got[job["tag"]])
            runs.append(run)
            name = job["tag"][len("[15] "):]
            out["recipes"][name] = n = a11d_numbers(run)
            traced = " under --trace" if job["recipe"] == A11D_TRACE_RECIPE else ""
            log(f"  {job['recipe']} as written{traced} ({run['wall']:.1f} s): {a11d_line(n)}")

        # both kernels against their plain versions on the whole first batch
        # of each (batch, heatmap size) that the recipes hand them
        by_recipe = {r["recipe"]: r for r in runs}
        entries = [attention_at(f"[15] {recipe[len('configs/'):-len('.yaml')]}",
                                by_recipe[recipe]["cfg"], torch.load(by_recipe[recipe]["locs"]),
                                device)
                   for recipe in A11D_ATTENTION_RECIPES]

        # the 19 mm recipe's corr_pos and 3D, kernel route against plain
        out["corr_pos_19mm"] = c = corr_pos_19mm(tmp, device)
        log(f"  {A11D_19MM} eval, one group, kernel route against plain route: corr_pos agree "
            f"{c['corr_pos_agree']:.4f} within {CORR_POS_TOL}; the epipolar triangulation's 3D "
            f"within {c['max_3d_gap_mm']:.3g} mm of each other; MPJPE {c['mpjpe_mm']:.2f} mm")

        # (a) the recipe under --trace
        summ = trace_summary(os.path.join(trace_dir, "trace.json"))
        named = {k: {"launches": 0, "ms": 0.0} for k in TRACE_KERNELS}
        for kname, v in summ["kernels"].items():
            for k in TRACE_KERNELS:
                if re.search(rf"\b{k}\b", kname):
                    named[k]["launches"] += v["launches"]
                    named[k]["ms"] += v["ms"]
        missing = [k for k, v in named.items() if not v["launches"]]
        if missing or not summ["device_events"] or summ["steps"] != A11D_STEPS:
            raise AssertionError(f"[15](a) the trace holds {summ['device_events']} device "
                                 f"events over {summ['steps']} steps, and no {missing}")
        out["trace"] = {k: v for k, v in summ.items() if k != "kernels"}
        out["trace"]["hand_kernels"] = named
        log(f"  (a) {A11D_TRACE_RECIPE} under --trace: {summ['device_events']} device events, "
            f"{len(summ['kernels'])} kernels by name; the device busy {summ['busy_ms']:.1f} of "
            f"{summ['window_ms']:.1f} ms over the {summ['steps']} traced train steps (share "
            f"{summ['busy_share']:.3f}); the hand kernels over the run: "
            + ", ".join(f"{k} {v['launches']} launches {v['ms']:.2f} ms" for k, v in named.items()))

        # (b) VIS.FLOPS on the flagship and the 384 fixed recipe
        flagship = profile_model(flagship_cfg(), device=device)
        on_host = profile_model(flagship_cfg(), device="cpu")
        if on_host["flops"] != flagship["flops"] or on_host["params"] != flagship["params"]:
            raise AssertionError(f"[15](b) the flagship's count on the card {flagship} and on "
                                 f"the host {on_host} differ")
        fixed = cli.main(["--cfg", os.path.join(root, R152_RECIPE), "VIS.FLOPS", "True"])
        h, w = flagship_cfg().KEYPOINT.HEATMAP_SIZE
        if not (fixed["flops"] > flagship["flops"] > flagship["attention_flops"]
                == 2 * h * w * flagship_cfg().EPIPOLAR.SAMPLESIZE * 2 * 256):
            raise AssertionError(f"[15](b) flagship {flagship}, {R152_RECIPE} {fixed}")
        out["vis_flops"] = {"flagship": flagship, "r152_384_fixed": fixed}
        log(f"  (b) VIS.FLOPS: the flagship {flagship['params']} parameters, "
            f"{flagship['flops'] / 1e9:.3f} GFLOP an item (attention "
            f"{flagship['attention_flops'] / 1e9:.4f}; the same count on the card and on the "
            f"host); {R152_RECIPE} {fixed['params']} parameters, {fixed['flops'] / 1e9:.3f} "
            f"GFLOP an item; bytes_accessed not counted (NaN)")

        # (c) DATALOADER.BENCHMARK with the recipe's 15 workers
        counts, lines, wall = got[bench_job["tag"]]
        runs.append(counts)
        bench = [line for line in lines if "DATALOADER.BENCHMARK:" in line]
        if len(bench) != 1:
            raise AssertionError("[15](c) no DATALOADER.BENCHMARK line")
        stages = {k: float(v) for k, v in re.findall(r"(\w+)=([\d.]+)ms", bench[0])}
        if set(stages) != set(A11D_STAGES) or not all(v > 0 for v in stages.values()):
            raise AssertionError(f"[15](c) stages {stages}")
        batches = re.search(r"(\d+) batches .* the first ([\d.]+) ms, the others ([\d.]+) "
                            r"ms/batch", bench[0])
        if not batches or int(batches[1]) != A11D_BENCHMARK_BATCHES:
            raise AssertionError(f"[15](c) {bench[0]}")
        out["dataloader_benchmark"] = {"line": bench[0].split("DATALOADER.BENCHMARK: ")[1],
                                       "stage_ms": stages, "first_batch_ms": float(batches[2]),
                                       "then_ms_per_batch": float(batches[3])}
        log(f"  (c) {A11D_BENCHMARK_RECIPE} with DATALOADER.BENCHMARK ({wall:.1f} s): "
            f"{bench[0].split('DATALOADER.BENCHMARK: ')[1]}")

        # (d) the event files of a recipe's run against its logged values
        fixed_run = next(r for r in runs if r["out_dir"].endswith("keypoint_h36m_zresidual_fixed"))
        scalars = read_scalars(fixed_run["out_dir"])
        logged = [re.findall(r"(\w+): (\S+) \((\S+)\)", line) for line in fixed_run["lines"]
                  if " step " in line and " loss: " in line]
        keys = {k for k, _, _ in logged[0]}
        if set(scalars) != {f"train/{k}" for k in keys}:
            raise AssertionError(f"[15](d) event tags {sorted(scalars)}, logged {sorted(keys)}")
        worst = 0.0
        for s_i, step_vals in enumerate(logged):
            for k, median, _ in step_vals:
                series = [v for _, v in scalars[f"train/{k}"][:s_i + 1]]
                worst = max(worst, abs(float(np.median(series)) - float(median)))
        if worst > 1e-4 or [s for s, _ in scalars["train/loss"]] != list(
                range(1, len(logged) + 1)):
            raise AssertionError(f"[15](d) event values off the logged medians by {worst}")
        out["event_files"] = {"tags": sorted(scalars), "max_gap_to_log": worst}
        log(f"  (d) the event files of {A11D_BENCHMARK_RECIPE}'s run, read back by the port's "
            f"reader: {len(scalars)} train/* tags at steps "
            f"{[s for s, _ in scalars['train/loss']]}, their window medians within {worst:.2g} "
            f"of the logged values (printed to 4 decimals)")
    out["phase_seconds"] = time.perf_counter() - start
    log(f"  [15] took {out['phase_seconds']:.1f} s")
    return dict(launches=sum(r["launches"] for r in runs),
                backward_launches=sum(r["backward_launches"] for r in runs),
                tiles=[sum(r["tiles"][i] for r in runs) for i in range(2)], numbers=out,
                forward_entries=[e[0] for e in entries],
                backward_entries=[e[1] for e in entries])


def vis_phase(cfg, device):
    """[16]: (a) the flagship's weights as a JAX .ckpt through cfg.WEIGHTS,
    (b) the command line's test with VIS.VIDEO, (c) the other VIS modes,
    (d) the batched triangulation on the card, (e) `graft_entry.entry`.
    Returns the forward launches and tiles, and the numbers of the JSON
    line."""
    import pickle

    import numpy as np
    import torch

    from epipolar_transformers_tpu_torch import main as cli
    from epipolar_transformers_tpu_torch.config import load_config
    from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
    from epipolar_transformers_tpu_torch.data.pipeline import (EvalLoader, collate,
                                                               make_eval_loaders)
    from epipolar_transformers_tpu_torch.engine import trainer
    from epipolar_transformers_tpu_torch.engine.tester import to_model_inputs
    from epipolar_transformers_tpu_torch.geometry import host
    from epipolar_transformers_tpu_torch.geometry import triangulate as tri
    from epipolar_transformers_tpu_torch.graft_entry import ARGS, entry
    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn
    from epipolar_transformers_tpu_torch.utils.flax_msgpack import write_checkpoint
    from epipolar_transformers_tpu_torch.vis.visualization import read_avi, read_frame

    t_phase = time.perf_counter()
    launches, tiles, numbers = 0, [0, 0], {}

    def counted(fn):
        nonlocal launches
        attn.LAUNCHES = 0
        attn.TILE_COUNTS.clear()
        out = fn()
        torch.cuda.synchronize(device)
        launches += attn.LAUNCHES
        t = attn.tile_counts()
        tiles[0] += t[0]
        tiles[1] += t[1]
        return out, attn.LAUNCHES

    try:
        import matplotlib  # noqa: F401
        have_mpl = True
    except ImportError:
        have_mpl = False
    log(f"  matplotlib importable: {'yes' if have_mpl else 'no'} (only the score panel "
        f"below needs it; nothing that launches a kernel does)")

    with tempfile.TemporaryDirectory() as tmp, cudnn_deterministic():
        # (a) the flagship's port weights packed as flax lays them out, read
        # back through cfg.WEIGHTS into a model drawn from another seed
        # the seeded initial weights, with every BN's statistics and the
        # zero-init fusion BN's scale moved by seeded noise, so that no
        # tensor of the check is a constant (the initial heatmaps stay small,
        # so pymvg keeps two views above -1 in (b), C15)
        model = trainer.build_model(cfg, device).eval()
        gen = torch.Generator().manual_seed(SEED + 16)
        with torch.no_grad():
            for name, t in [*model.named_buffers(), *model.named_parameters()]:
                noise = torch.randn(t.shape, generator=gen).to(device)
                if name.endswith("running_mean") or name.endswith("epipolar_sampler.bn.weight"):
                    t.add_(0.1 * noise)
                elif name.endswith("running_var"):
                    t.mul_(1 + 0.1 * noise.abs())
        ckpt = os.path.join(tmp, "flagship.ckpt")
        t0 = time.perf_counter()
        write_checkpoint(ckpt, model, epoch=0)
        write_s = time.perf_counter() - t0
        fresh = trainer.build_model(cfg.replace(SEED=SEED + 1), device)
        t0 = time.perf_counter()
        extra = trainer.load_weights(cfg.replace(WEIGHTS=ckpt, OUTPUT_DIR=""), fresh)
        load_s = time.perf_counter() - t0
        fresh.eval()
        if extra != {"epoch": 0}:
            raise AssertionError(f"(a) the .ckpt's extra came back as {extra}")
        want, got = model.state_dict(), fresh.state_dict()
        keys = [k for k in want if not k.endswith("num_batches_tracked")]
        differ = [k for k in keys if not torch.equal(want[k], got[k])]
        if differ:
            raise AssertionError(f"(a) {len(differ)} tensors differ after the .ckpt, e.g. "
                                 f"{differ[:3]}")
        n_bn = sum(1 for k in keys if k.endswith(("running_mean", "running_var")))
        np.random.seed(SEED)
        ds = SyntheticMultiview(cfg, is_train=True, n_samples=BENCH_BATCH, seed=SEED)
        batch = to_model_inputs(collate([ds[i] for i in range(BENCH_BATCH)]), device)
        with torch.inference_mode():
            (a_out, b_out), n = counted(lambda: (model(batch), fresh(batch)))
        if n != 2 or not torch.equal(a_out["heatmap_pred"], b_out["heatmap_pred"]):
            raise AssertionError(f"(a) heatmaps of the .ckpt model: {n} launches, bit-equal "
                                 f"{torch.equal(a_out['heatmap_pred'], b_out['heatmap_pred'])}")
        size = os.path.getsize(ckpt) / 2 ** 20
        log(f"  (a) flagship weights as a JAX .ckpt: {size:.1f} MiB written in {write_s:.2f} s, "
            f"loaded through cfg.WEIGHTS in {load_s:.2f} s; all {len(keys)} tensors bit-equal "
            f"({n_bn} BN statistics); heatmaps at batch {BENCH_BATCH} bit-equal through the "
            f"forward kernel, launches {n}")
        numbers["ckpt"] = {"mib": size, "write_s": write_s, "load_s": load_s,
                           "tensors": len(keys)}
        del model, fresh, a_out, b_out

        # (b) the command line's test on the flagship recipe with the .ckpt's
        # weights (bf16 convolutions, as the flagship), VIDEO and SAVE_PRED on
        out = os.path.join(tmp, "vis")
        opts = ["DOTRAIN", "False", "DTYPE", "bfloat16", "WEIGHTS", ckpt]

        def command_line(groups, *more):
            return cli.main(["--cfg", FLAGSHIP_RECIPE, "--max-eval-batches", str(groups),
                             *opts, *more])

        t0 = time.perf_counter()
        results, n = counted(lambda: command_line(
            VIS_GROUPS, "VIS.DOVIS", "True", "VIS.VIDEO", "True", "VIS.SAVE_PRED", "True",
            "VIS.SAVE_PRED_FREQ", "1", "OUTPUT_DIR", out))
        wall = time.perf_counter() - t0
        finite_metrics("(b) test with VIS.VIDEO", results)
        if n != VIS_GROUPS:
            raise AssertionError(f"(b) {VIS_GROUPS} groups launched the forward kernel {n} times")
        views = sorted(os.listdir(os.path.join(out, "video", "ds0")))
        avi = os.path.join(out, "video", "ds0.avi")
        frames = read_avi(avi)
        if len(frames) != VIS_GROUPS or len(views) != 4:
            raise AssertionError(f"(b) {len(frames)} AVI frames, {len(views)} view dirs")
        for i, frame in enumerate(frames):
            for v, view in enumerate(views):
                png = read_frame(os.path.join(out, "video", "ds0", view, f"{i:08d}.png"))
                r, c = divmod(v, 2)
                h, w = png.shape[:2]
                if not np.array_equal(frame[r * h:(r + 1) * h, c * w:(c + 1) * w], png):
                    raise AssertionError(f"(b) AVI frame {i} view {v} differs from its PNG")
        avi_mib = os.path.getsize(avi) / 2 ** 20
        log(f"  (b) {FLAGSHIP_RECIPE} through the command line, test on {VIS_GROUPS} groups "
            f"(DTYPE bfloat16, the .ckpt's weights) with VIS.VIDEO: MPJPE "
            f"{results['EPEmean_global']:.3f} mm, JDR {results['JDR']:.3f}; forward kernel "
            f"launches {n}; {VIS_GROUPS} x 4 PNG frames and ds0.avi ({frames[0].shape[1]}x"
            f"{frames[0].shape[0]}, {avi_mib:.2f} MiB), read back bit-equal to the frames; "
            f"{wall:.1f} s")
        numbers["video"] = {"groups": VIS_GROUPS, "wall_s": wall, "avi_mib": avi_mib,
                            "launches": n, "mpjpe": results["EPEmean_global"]}

        # (c) VIDEO_GT (no forward), EPIPOLAR_LINE (17 heatmap channels: the
        # plain route), AUC and POINTCLOUD on (b)'s files
        gt = os.path.join(tmp, "gt")
        _, n_gt = counted(lambda: command_line(VIS_GT_GROUPS, "VIS.VIDEO", "True",
                                               "VIS.VIDEO_GT", "True", "OUTPUT_DIR", gt))
        command_line(0, "DOTEST", "False", "VIS.VIDEO", "True",
                     "OUTPUT_DIR", os.path.join(gt, "video_gt"))
        gt_frames = read_avi(os.path.join(gt, "video_gt", "video", "ds0.avi"))
        _, n_line = counted(lambda: command_line(0, "DOTEST", "False", "VIS.EPIPOLAR_LINE",
                                                 "True", "EPIPOLAR.ZRESIDUAL", "False",
                                                 "OUTPUT_DIR", out))
        command_line(0, "DOTEST", "False", "VIS.AUC", "True", "VIS.POINTCLOUD", "True",
                     "OUTPUT_DIR", out)
        with open(os.path.join(out, "epipolar_introspection.pkl"), "rb") as f:
            dump = pickle.load(f)
        with open(os.path.join(out, "auc.pkl"), "rb") as f:
            auc = pickle.load(f)
        clouds = sorted(os.listdir(os.path.join(out, "pointclouds")))
        K = cfg.EPIPOLAR.SAMPLESIZE
        h, w = cfg.KEYPOINT.HEATMAP_SIZE
        want_shapes = {"sample_locs": (1, K, h, w, 2), "corr_pos": (1, h, w, 2),
                       "attention": (1, K, h, w), "fused": (1, h, w, 256)}
        shapes = {k: tuple(v.shape) for k, v in dump.items()}
        if (n_gt or len(gt_frames) != VIS_GT_GROUPS or shapes != want_shapes or n_line
                or not 0 <= auc["auc"] <= 1 or len(clouds) != VIS_GROUPS):
            raise AssertionError(f"(c) VIDEO_GT launches {n_gt}, {len(gt_frames)} frames; "
                                 f"EPIPOLAR_LINE {shapes} launches {n_line}; AUC {auc['auc']}; "
                                 f"{len(clouds)} pointclouds")
        line = "matplotlib missing: no score panel"
        if have_mpl:
            from epipolar_transformers_tpu_torch.vis.score_curves import draw_score_panel

            H, W = cfg.DATASETS.IMAGE_SIZE
            panel = draw_score_panel(dump, W / 2, H / 2, os.path.join(out, "panel.png"))
            line = f"score panel {os.path.getsize(panel)} bytes"
        log(f"  (c) VIDEO_GT: {VIS_GT_GROUPS} groups of ground-truth frames, forward launches "
            f"{n_gt}, their AVI {len(gt_frames)} frames; EPIPOLAR_LINE on the card: "
            f"{shapes} ({cfg.KEYPOINT.NUM_PTS} channels: the plain route, launches {n_line}); AUC "
            f"{auc['auc']:.4f}; {len(clouds)} pointclouds; {line}")

        # (d) the batched triangulation on the card against the host copies,
        # on (b)'s saved predictions and the same groups' cameras
        with open(os.path.join(out, "predictions.pkl"), "rb") as f:
            preds = pickle.load(f)
        rcfg = load_config(FLAGSHIP_RECIPE)
        groups = []
        for ib, b in enumerate(EvalLoader(make_eval_loaders(rcfg)[0].dataset)):
            if ib >= VIS_GROUPS:
                break
            groups.append({k: v[0] for k, v in b.items()})

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=device)

        worst_pymvg, worst_gt, card_ms, host_ms = 0.0, {}, 0.0, 0.0
        # one call first: the solver's handle and workspace are made once
        tri.triangulate_pymvg(dev(preds[0]["batch_locs"]), dev(groups[0]["K"]),
                              dev(groups[0]["RT"]), dev(preds[0]["score_pred"]))
        for g, p in zip(groups, preds):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            card = tri.triangulate_pymvg(dev(p["batch_locs"]), dev(g["K"]), dev(g["RT"]),
                                         dev(p["score_pred"])).cpu().numpy()
            card_ms += (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            hostp = host.triangulate_pymvg_np(p["batch_locs"], g["K"], g["RT"], p["score_pred"])
            host_ms += (time.perf_counter() - t0) * 1e3
            if not np.allclose(card, p["pred3d"], rtol=0, atol=TRIANGULATION_MM, equal_nan=True):
                raise AssertionError(f"(d) pymvg on the card vs the host: "
                                     f"{np.nanmax(np.abs(card - p['pred3d']))} mm")
            worst_pymvg = max(worst_pymvg, float(np.nanmax(np.abs(card - hostp))))
            pts2d, pts3d = dev(g["points-2d"]), np.asarray(g["points-3d"], np.float64)
            ones = torch.ones(pts2d.shape[:2], dtype=torch.float64, device=device)
            gen = torch.Generator(device=device).manual_seed(SEED)
            for name, fn in (("naive", lambda: tri.triangulate_ransac(
                    pts2d, dev(g["KRT"]), ones, gen)),
                             ("refine", lambda: tri.triangulate_refine(
                                 pts2d, dev(g["KRT"]), ones, gen)),
                             ("pymvg", lambda: tri.triangulate_pymvg(
                                 pts2d, dev(g["K"]), dev(g["RT"]), ones))):
                err = float(np.linalg.norm(fn().cpu().numpy() - pts3d, axis=-1).max())
                worst_gt[name] = max(worst_gt.get(name, 0.0), err)
        if not max(worst_gt.values()) < GT_TRIANGULATION_MM:
            raise AssertionError(f"(d) ground truth on the card: {worst_gt} mm")
        log(f"  (d) batched triangulation on the card (f64): pymvg on (b)'s {VIS_GROUPS} groups "
            f"within {worst_pymvg:.3g} mm of the host copy (limit {TRIANGULATION_MM}), "
            f"{card_ms / len(groups):.2f} ms a group on the card, {host_ms / len(groups):.2f} ms "
            f"on the host; ground-truth 2D points, worst joint (mm, limit "
            f"{GT_TRIANGULATION_MM}): " + ", ".join(f"{k} {v:.3g}" for k, v in worst_gt.items()))
        numbers["triangulation"] = {"pymvg_vs_host_mm": worst_pymvg, "gt_mm": worst_gt,
                                    "card_ms": card_ms / len(groups),
                                    "host_ms": host_ms / len(groups)}

        # (e) entry() against the builder at the same weights
        np.random.seed(SEED)
        fn, args = entry()
        builder = trainer.build_model(cfg, device).eval()
        with torch.inference_mode():
            (got_e, want_e), n = counted(lambda: (fn(*args), builder(dict(zip(ARGS, args)))))
        same = all(torch.equal(a, want_e[k]) for a, k in zip(
            got_e, ("heatmap_pred", "batch_locs", "score_pred")))
        if n != 2 or not same:
            raise AssertionError(f"(e) entry(): {n} launches, outputs bit-equal {same}")
        log(f"  (e) graft_entry.entry() on cuda:0: heatmaps {tuple(got_e[0].shape)}, locations "
            f"and scores bit-equal to the builder's at the same weights, launches {n}")
    seconds = time.perf_counter() - t_phase
    check_main_path_tiles("[16]", tiles, sum(tiles))
    log(f"  [16] forward kernel launches {launches}, forward tiles on the tile path / "
        f"per-query path {tiles[0]} / {tiles[1]}; {seconds:.1f} s")
    numbers["seconds"] = seconds
    return {"launches": launches, "backward_launches": 0, "tiles": tuple(tiles),
            "numbers": numbers}


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
    log(f"[13] the flagship recipe on H36M-layout data: {H36M_RECIPE} as written through the "
        f"command line on a fake tree of JPEG frames, {card}")
    h36m = h36m_phase(device)
    log(f"[14] the ResNet-152 recipes as written on a fake H36M tree: {R152_RECIPE} through "
        f"the command line, {R152_DDP_RECIPE} under torchrun --multihost and over two gloo "
        f"ranks on the card, {R152_320_RECIPE} (80x80) and {K85_RECIPE} (K=85), {card}")
    r152 = r152_phase(device)
    log(f"[15] the fifteen recipes no card had run, as written, on a fake H36M tree, a fake "
        f"RHD tree and a seeded pose-ResNet file, and the profiling and loader tooling, {card}")
    a11d = a11d_phase(device)
    log(f"[16] the last modules: the flagship's weights as a JAX .ckpt, the command line's "
        f"VIS modes on {FLAGSHIP_RECIPE}, the batched triangulation on the card, "
        f"graft_entry.entry(), {card}")
    vis = vis_phase(cfg, device)
    extra = [prior, fusion, lifting["multiview_img_lifting_rot"], h36m, r152, a11d, vis]

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
        "hourglass_shape": hg["entry"], "r152_shapes": r152["forward_entries"],
        "a11d_shapes": a11d["forward_entries"],
    }, {
        "name": "epipolar_attention_backward", "route": "cuda",
        "source": "epipolar_transformers_tpu_torch/csrc/epipolar_attention.cu",
        "replaces": BACKWARD_REPLACES,
        "launches": (backward_launches + hg["backward_launches"] + recipe_backward
                     + sum(e["backward_launches"] for e in extra)),
        "max_abs_err": bwd_err, "ms": kbw_ms, "plain_ms": pbw_ms, "bound_ms": bwd_bound[0],
        "bound_by": bwd_bound[1], "library_ms": None,
        "hourglass_shape": hg["backward_entry"], "r152_shapes": r152["backward_entries"],
        "a11d_shapes": a11d["backward_entries"],
        "prior_gradient": {**prior["prior_grad"], "bound_ms": prior_bound[0],
                           "bound_by": prior_bound[1]},
    }], "param_recipe": param, "lifting_tasks": {
        k: {kk: vv for kk, vv in v.items() if kk not in ("launches", "backward_launches", "tiles")}
        if k == "multiview_img_lifting_rot" else v for k, v in lifting.items()},
        "h36m_path": {k: v for k, v in h36m.items()
                      if k not in ("launches", "backward_launches", "tiles")},
        "r152_recipes": r152["numbers"], "a11d_recipes": a11d["numbers"],
        "last_modules": vis["numbers"]}))
    jax_side = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "flax", "epipolar_transformers_tpu"))
    if jax_side:
        raise AssertionError(f"the port imported {jax_side[:5]}")
    killed = stop_children()
    if killed:
        raise AssertionError(f"child processes {killed} were still running after the loader's "
                             f"were stopped")
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cli-jobs"]:  # [14], [15]: command lines in a process of their own
        sys.exit(cli_jobs_main(sys.argv[2]))
    if sys.argv[1:2] == ["--gloo-rank"]:  # [14](c): a rank that [14] starts
        sys.exit(gloo_rank_main(*map(int, sys.argv[2:5]), sys.argv[5]))
    try:
        code = main()
    finally:
        stop_children()
    sys.exit(code)
