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
     serial one, in turns, and the device's idle share of a profiled run.

The line before the card line is a JSON object with both kernels'
launches, errors and times, and each kernel's bound: the larger of its
operations over the f32 rate outside the tensor cores and its bytes (each
input read once, each output written once) over the memory rate, counted
from this run's inputs (the operations per distinct live (query, key row)
pair).  The forward's entry also holds `main_path_tiles`, its tiles on
each path over the forwards of phases 3, 6 and 7(a).  No single PyTorch call
computes either kernel's function, so `library_ms` is null.  Before the
last line the script checks that nothing of the JAX package was imported;
the last line is {"ok": true, "device": {...}}.  Any failed check raises.
"""

from __future__ import annotations

import contextlib
import json
import logging
import re
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
# feeds the zero-init BN, which runs on batch statistics in training and
# removes any constant shift: its true gradient is 0 on both paths
ZERO_GRAD_PARAMS = ("reference.epipolar_sampler.z.bias",)
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
    """(batch, K, 64, 64, 2) locations of the synthetic rig's view pairs
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
        sampler = model.reference.epipolar_sampler
        sampler.bn.weight.copy_(torch.randn(sampler.bn.weight.shape, generator=gen) * 0.5)
        sampler.bn.bias.copy_(torch.randn(sampler.bn.bias.shape, generator=gen) * 0.1)
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
    """Run `model`'s epipolar layer through the plain version (plain) or
    the kernels, on the same weights."""
    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn

    sampler = model.reference.epipolar_sampler
    sampler.attention = (attn.epipolar_attention_plain_batch if plain
                         else attn.epipolar_attention_batch)
    try:
        yield
    finally:
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
    """Collects the formatted messages of one logger."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def train_phase(cfg, device):
    """The training main path through `engine.trainer.train`, its
    checkpoint resume, and one step on each attention path.  Returns the
    launch counts and what timing needs."""
    import numpy as np
    import torch

    from epipolar_transformers_tpu_torch.config import update_from_dict
    from epipolar_transformers_tpu_torch.engine import trainer
    from epipolar_transformers_tpu_torch.engine.solver import make_optimizer
    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn
    from epipolar_transformers_tpu_torch.utils.checkpoint import Checkpointer

    messages = _Messages()
    train_log = logging.getLogger(trainer.__name__)
    train_log.addHandler(messages)
    train_log.setLevel(logging.INFO)
    with tempfile.TemporaryDirectory() as out_dir:
        tcfg = update_from_dict(cfg, {"OUTPUT_DIR": out_dir, "LOG_FREQ": 1,
                                      "TENSORBOARD": {"USE": False}})
        attn.LAUNCHES = attn.BACKWARD_LAUNCHES = 0
        attn.TILE_COUNTS.clear()
        t0 = time.perf_counter()
        model, optimizer = trainer.train(tcfg, max_steps=TRAIN_STEPS, device=device)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        launches, backward_launches = attn.LAUNCHES, attn.BACKWARD_LAUNCHES
        tiles = attn.tile_counts()
        losses = [float(m) for msg in messages.messages for m in re.findall(r"\bloss (\S+)", msg)]
        if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
            raise AssertionError(f"train losses {losses}")
        if not launches == backward_launches == optimizer.count == TRAIN_STEPS:
            raise AssertionError(f"{optimizer.count} steps launched the forward kernel "
                                 f"{launches} and the backward kernel {backward_launches} times")
        if next(model.parameters()).device != device:
            raise AssertionError("the trainer did not run on the card")
        h, w = cfg.KEYPOINT.HEATMAP_SIZE
        check_main_path_tiles("train", tiles, launches * tcfg.SOLVER.IMS_PER_BATCH
                              * -(-h * w // attn.TILE_QUERIES))
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
    train_log.removeHandler(messages)
    del model, optimizer, resumed, resumed_opt

    model, batch = step_parity(cfg, device, per_param=False)
    step_parity(cfg.replace(DTYPE="float32"), device, per_param=True)

    optimizer = make_optimizer(cfg, model)
    step = trainer.make_train_step(cfg, model, optimizer)

    def train_step(plain: bool):
        with attention_path(model, plain):
            step(batch)

    return launches, backward_launches, tiles, train_step


def step_parity(cfg, device, per_param: bool):
    """One train step's loss and gradients on the kernel path (twice, which
    gives the noise floor of cuDNN's algorithm choices; the attention
    backward is bit-equal) and on the plain path, from the same randomized
    weights.

    Under bf16 convolutions the loss and the whole model's gradient are
    held, the gradient against the kernel path's own spread; f32
    convolutions (per_param) hold every parameter's gradient, where bf16
    rounding downstream of the attention would otherwise amplify f32-level
    differences through the deep trunk.
    Returns the model and the batch."""
    import numpy as np
    import torch

    from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
    from epipolar_transformers_tpu_torch.data.pipeline import collate
    from epipolar_transformers_tpu_torch.engine import trainer
    from epipolar_transformers_tpu_torch.engine.tester import TRAIN_KEYS, to_model_inputs

    model = trainer.build_model(cfg, device)
    np.random.seed(SEED)
    ds = SyntheticMultiview(cfg, is_train=True, n_samples=BENCH_BATCH, seed=SEED)
    batch = to_model_inputs(collate([ds[i] for i in range(BENCH_BATCH)]), device, TRAIN_KEYS)
    randomize(model, torch.cat([batch["img"], batch["other_img"]]), SEED)
    model.train()

    def loss_and_grads(plain: bool):
        model.zero_grad(set_to_none=True)
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
    dtype = "bf16" if cfg.DTYPE == "bfloat16" else "f32"
    if abs(loss_k - loss_p) > STEP_LOSS_RTOL * abs(loss_p) or not np.isfinite(loss_k):
        raise AssertionError(f"{dtype} train step loss: kernel path {loss_k}, plain {loss_p}")
    if set(grads_k) != set(grads_p):
        raise AssertionError("the two paths give gradients to different parameters")
    whole = rel(torch.cat([g.flatten() for g in grads_k.values()]),
                torch.cat([g.flatten() for g in grads_p.values()]))
    whole_self = rel(torch.cat([g.flatten() for g in grads_k2.values()]),
                     torch.cat([g.flatten() for g in grads_k.values()]))
    limit = STEP_GRAD_REL_L2 if per_param else max(STEP_GRAD_REL_L2,
                                                   STEP_BF16_NOISE_FACTOR * whole_self)
    if not whole <= limit:
        raise AssertionError(f"{dtype} whole-model gradient relative L2 error {whole:.3g} "
                             f"above {limit:.3g} (kernel path against itself {whole_self:.3g})")
    errs = {k: rel(grads_k[k], g) for k, g in grads_p.items()}
    worst = max(errs, key=errs.get)
    if per_param and not errs[worst] <= STEP_GRAD_REL_L2:
        raise AssertionError(f"{dtype} {worst}: gradient relative L2 error {errs[worst]:.3g}")
    log(f"  one {dtype} step, kernel vs plain path: loss {loss_k:.6g} vs {loss_p:.6g}; "
        f"gradient relative L2 error {whole:.3g} over the model (kernel path against itself "
        f"{whole_self:.3g}), worst parameter {errs[worst]:.3g} ({worst}; kernel path against "
        f"itself {rel(grads_k2[worst], grads_k[worst]):.3g}) over {len(errs)} parameters")
    return model, batch


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


def bound(feats, locs, backward: bool, distinct: bool = True):
    """(ms, "operations" or "bytes"): the least time the card could take for
    the attention forward (queries, keys, values) or backward (queries and
    keys = values one tensor, all gradients) on these f32 inputs.  The
    operations count 2C flops per distinct live (query, key row) pair at
    these locations (the least work any implementation must do; with
    distinct=False per live corner hit, as PR 1-3 counted) for each time
    the function reads that row: the forward twice (similarity, output), the
    backward five times (similarity, g, dfeat1, and the key and value
    gradients).  The bytes read each input once and write each output once."""
    B, K, H, W, _ = locs.shape
    C = feats[0].shape[-1]
    flops = live_pairs(locs, distinct) * 2 * C * (5 if backward else 2)
    feature = B * H * W * C * 4
    # inputs (features, locations; the backward's dout) and outputs (out and
    # depth; the backward's dfeat1 and keys' = values' gradient)
    nbytes = len(feats) * feature + locs.numel() * 4 + (
        3 * feature if backward else feature + B * K * H * W * 4)
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

    fwd_bound = bound(f32, rig, backward=False)
    bwd_bound = bound(f32[:2], rig, backward=True)
    fwd_hits, bwd_hits = (bound(f, rig, b, distinct=False)[0]
                          for f, b in ((f32, False), (f32[:2], True)))
    log(f"    bounds at these inputs: forward {fwd_bound[0]:.4f} ms, backward "
        f"{bwd_bound[0]:.4f} ms (set by {fwd_bound[1]}, {bwd_bound[1]}; "
        f"{live_pairs(rig)} distinct live (query, key row) pairs; counted per live "
        f"corner hit, {live_pairs(rig, False)} of them, as before: {fwd_hits:.4f} and "
        f"{bwd_hits:.4f} ms)")
    log(json.dumps({"kernels": [{
        "name": "epipolar_attention", "route": "cuda",
        "source": "epipolar_transformers_tpu_torch/csrc/epipolar_attention.cu",
        "replaces": REPLACES, "launches": launches + train_launches, "max_abs_err": err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
        "library_ms": None, "main_path_tiles": {
            "tile_path": slice_tiles[0] + train_tiles[0] + eval_tiles[0],
            "per_query_path": slice_tiles[1] + train_tiles[1] + eval_tiles[1]},
    }, {
        "name": "epipolar_attention_backward", "route": "cuda",
        "source": "epipolar_transformers_tpu_torch/csrc/epipolar_attention.cu",
        "replaces": BACKWARD_REPLACES, "launches": backward_launches, "max_abs_err": bwd_err,
        "ms": kbw_ms, "plain_ms": pbw_ms, "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
        "library_ms": None,
    }]}))
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
