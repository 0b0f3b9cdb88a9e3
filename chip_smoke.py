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
     then priors, priormul, prior similarity and softmax off at a smaller
     shape;
  3. the inference slice: the flagship ModelBuilder (epipolarposeR-50,
     256 px, K=64, 17 joints, bf16 convolutions) built on the card from a
     seed, 8 synthetic eval view groups through `engine.tester.predict` (the
     launch counter must grow by one per forward), then the bench shape
     (batch 8) through the kernel path and the plain-attention path on the
     same weights;
  4. times with CUDA events after warm-up, in turns, kernel path against
     plain path, before any training: the attention forward alone and the
     slice forward at batch 8;
  5. the CUDA backward kernel (through the autograd Function) against
     autograd of the plain version, at the flagship attention shape: f32
     with gradients to queries, keys and values, detached keys and values,
     bf16, edge-crossing locations, all out of range (exactly zero), then
     priors, priormul and softmax off at the smaller shape;
  6. the training slice: `engine.trainer.train` on the flagship config for
     TRAIN_STEPS steps of batch 8 (finite loss every step, one forward and
     one backward kernel launch per step), a checkpoint and its resume, then
     one step on the kernel path and one on the plain path from the same
     weights: under bf16 convolutions the loss and the whole-model gradient
     are compared, under f32 convolutions every parameter's gradient;
  4. (continued) times as above: the attention backward alone (with and
     without the key/value scatter) and the train step at batch 8, and the
     peak memory of a train step on each path.

The line before the card line is a JSON object with both kernels'
launches, errors and times; the last line is {"ok": true, "device": {...}}.
Any failed check raises.
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
# summation order (and the scatter's atomics add in a run-dependent order);
# bf16 as the forward, the plain version rounding G and n to bf16.  The atol
# is relative to each gradient's max.
GRAD_F32_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_BF16_TOL = dict(rtol=5e-2, atol=5e-2)
# one train step, kernel path against plain path from the same weights:
# the loss, and under f32 convolutions each parameter gradient's relative L2
# error.  Under bf16 convolutions any f32-level difference (the backward's
# atomics add in a run-dependent order) is amplified through the trunk:
# either path against itself differs by ~0.013-0.015 over the whole model
# and up to ~0.03 on single parameters, so bf16 holds the whole-model error
# within STEP_BF16_NOISE_FACTOR times the kernel path's own spread in the
# same run, and never below STEP_GRAD_REL_L2
STEP_LOSS_RTOL = 2e-2
STEP_GRAD_REL_L2 = 2e-2
STEP_BF16_NOISE_FACTOR = 1.5
# feeds the zero-init BN, which runs on batch statistics in training and
# removes any constant shift: its true gradient is 0 on both paths
ZERO_GRAD_PARAMS = ("reference.epipolar_sampler.z.bias",)
REPLACES = "epipolar_transformers_tpu/ops/epipolar_attention_pallas.py:66"
BACKWARD_REPLACES = ("jax.grad of epipolar_transformers_tpu/ops/"
                     "epipolar_attention_matmul.py:158 (no TPU backward kernel)")


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
    err = check("f32 rig locs (flagship shape)", f32, rig, flagship)
    check("f32 edge-crossing locs", f32, rand_locs, flagship)
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
    return err, (f32, rig, flagship)


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
    from epipolar_transformers_tpu_torch.data.pipeline import collate, eval_batches
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
    outputs = predict(cfg, model, eval_batches(eval_ds), max_batches=EVAL_GROUPS)
    torch.cuda.synchronize(device)
    launches = attn.LAUNCHES
    if len(outputs) != EVAL_GROUPS or launches != EVAL_GROUPS:
        raise AssertionError(f"{len(outputs)} forwards launched the kernel {launches} times")
    V, J = eval_ds.n_views, cfg.KEYPOINT.NUM_PTS
    h, w = cfg.KEYPOINT.HEATMAP_SIZE
    K = cfg.EPIPOLAR.SAMPLESIZE
    shapes = {"heatmap_pred": (V, J, h, w), "batch_locs": (V, J, 2), "score_pred": (V, J),
              "corr_pos": (V, h, w, 2), "depth": (V, K, h, w)}
    for out in outputs:
        for k, shape in shapes.items():
            if tuple(out[k].shape) != shape or not torch.isfinite(out[k]).all():
                raise AssertionError(f"{k}: shape {tuple(out[k].shape)} (want {shape}) or non-finite")
    log(f"  predict: {EVAL_GROUPS} view groups of {V} views, all outputs finite with "
        f"the expected shapes; kernel launches {launches} (one per forward)")

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
    return launches, forward


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

    flagship = AttentionParams(softmax_scale=cfg.EPIPOLAR.SOFTMAXSCALE)
    rig = rig_sample_locs(cfg, B, device)
    rand_locs = torch.rand(B, K, H, W, 2, device=device, generator=gen) * 2.6 - 1.3
    f32 = feats(B, H, W, C, torch.float32)
    err = check("f32 rig locs, OTHER_GRAD (flagship shape)", f32, rig, flagship)
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
        t0 = time.perf_counter()
        model, optimizer = trainer.train(tcfg, max_steps=TRAIN_STEPS)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        launches, backward_launches = attn.LAUNCHES, attn.BACKWARD_LAUNCHES
        losses = [float(m) for msg in messages.messages for m in re.findall(r"\bloss (\S+)", msg)]
        if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
            raise AssertionError(f"train losses {losses}")
        if not launches == backward_launches == optimizer.count == TRAIN_STEPS:
            raise AssertionError(f"{optimizer.count} steps launched the forward kernel "
                                 f"{launches} and the backward kernel {backward_launches} times")
        if next(model.parameters()).device != device:
            raise AssertionError("the trainer did not run on the card")
        log(f"  train: {TRAIN_STEPS} steps of batch {tcfg.SOLVER.IMS_PER_BATCH} in {wall:.1f} s "
            f"(first steps include cuDNN autotuning and the loader's start), loss "
            f"{losses[0]:.5g} -> {losses[-1]:.5g}, all finite; forward kernel launches "
            f"{launches}, backward kernel launches {backward_launches} (one each per step)")

        Checkpointer(out_dir).save("model_000", model, optimizer, epoch=1)
        resumed, resumed_opt = trainer.train(
            tcfg.replace(SOLVER=tcfg.SOLVER.replace(MAX_EPOCHS=1)))
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

    return launches, backward_launches, train_step


def step_parity(cfg, device, per_param: bool):
    """One train step's loss and gradients on the kernel path (twice: the
    backward's atomics add in a run-dependent order, which gives the noise
    floor) and on the plain path, from the same randomized weights.

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
    err, (f32, rig, params) = attention_phase(cfg, device)

    log("[3] slice: flagship multiview inference")
    launches, forward = slice_phase(cfg, device)

    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn

    log(f"[4] times (CUDA events, mean of 2x20 calls in turns), {card}")
    k_ms, p_ms = in_turns(lambda: attn.epipolar_attention_batch(*f32, rig, params),
                          lambda: attn.epipolar_attention_plain_batch(*f32, rig, params))
    log(f"    attention alone, B=8 64x64 K=64 C=256 f32: kernel {k_ms:.4f} ms, "
        f"plain {p_ms:.4f} ms" + ("  (kernel SLOWER)" if k_ms > p_ms else ""))
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
    train_launches, backward_launches, train_step = train_phase(cfg, device)

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
    # the same without the key/value scatter: what the atomics cost
    kq_ms, pq_ms = in_turns(backward_only(attn.epipolar_attention_batch, need_kv=False),
                            backward_only(attn.epipolar_attention_plain_batch, need_kv=False))
    log(f"    attention backward, query gradient only (keys and values detached, no "
        f"scatter): kernel {kq_ms:.4f} ms, plain autograd {pq_ms:.4f} ms")
    tk_ms, tp_ms = in_turns(lambda: train_step(False), lambda: train_step(True), iters=10)
    log(f"    train step (forward, backward, adam), batch {BENCH_BATCH}: kernel path "
        f"{tk_ms:.3f} ms, plain path {tp_ms:.3f} ms")
    mem_k, mem_p = peak_step_memory(train_step, False), peak_step_memory(train_step, True)
    log(f"    train step peak memory (max_memory_allocated): kernel path {mem_k:.3f} GiB, "
        f"plain path {mem_p:.3f} GiB")

    log(json.dumps({"kernels": [{
        "name": "epipolar_attention", "route": "cuda",
        "source": "epipolar_transformers_tpu_torch/csrc/epipolar_attention.cu",
        "replaces": REPLACES, "launches": launches + train_launches, "max_abs_err": err,
        "ms": k_ms, "plain_ms": p_ms,
    }, {
        "name": "epipolar_attention_backward", "route": "cuda",
        "source": "epipolar_transformers_tpu_torch/csrc/epipolar_attention.cu",
        "replaces": BACKWARD_REPLACES, "launches": backward_launches, "max_abs_err": bwd_err,
        "ms": kbw_ms, "plain_ms": pbw_ms,
    }]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
