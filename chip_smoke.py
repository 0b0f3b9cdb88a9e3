#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Needs one CUDA device and `nvcc`; exits non-zero without them, and in a
directory that does not hold the repository.  Phases, each printed on its
own lines:

  1. the card (nvidia-smi name and power limit) and the kernel build time;
  2. the CUDA epipolar-attention kernel against its plain PyTorch version at
     the flagship attention shape (B=8, 64x64, K=64, C=256): f32 features on
     sample locations of the synthetic rig, bf16 features, random locations
     that cross the image edges, all samples out of range; then priors,
     priormul, prior similarity and softmax off at a smaller shape;
  3. the slice: the flagship ModelBuilder (epipolarposeR-50, 256 px, K=64,
     17 joints, bf16 convolutions) built on the card from a seed, 8 synthetic
     eval view groups through `engine.tester.predict` (the launch counter
     must grow by one per forward), then the bench shape (batch 8) through
     the kernel path and the plain-attention path on the same weights;
  4. times with CUDA events after warm-up: the attention alone and the slice
     forward at batch 8, kernel path against plain path, in turns.

The line before the card line is a JSON object with the kernel's launches,
error and times; the last line is {"ok": true, "device": {...}}.  Any failed
check raises.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

SEED = 0
FLAGSHIP_ATTENTION = dict(B=8, H=64, W=64, K=64, C=256)
BENCH_BATCH = 8
EVAL_GROUPS = 8
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
REPLACES = "epipolar_transformers_tpu/ops/epipolar_attention_pallas.py:66"


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

    sampler = model.reference.epipolar_sampler

    def forward(plain: bool):
        sampler.attention = (attn.epipolar_attention_plain_batch if plain
                             else attn.epipolar_attention_batch)
        try:
            with torch.inference_mode():
                return model(bench)
        finally:
            del sampler.attention

    got, want = forward(False), forward(True)
    e_hm = close("slice heatmap_pred", got["heatmap_pred"], want["heatmap_pred"],
                 **SLICE_HEATMAP_TOL)
    ok_locs = agreement("slice batch_locs", got["batch_locs"], want["batch_locs"], 1.0)
    close("slice depth", got["depth"], want["depth"], **F32_TOL)
    log(f"  bench batch {BENCH_BATCH}: kernel vs plain path heatmap_pred max abs err "
        f"{e_hm:.3g}, batch_locs within 1 px {ok_locs:.4f}, depth within f32 tol")
    return launches, forward


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

    log(json.dumps({"kernels": [{
        "name": "epipolar_attention", "route": "cuda",
        "source": "epipolar_transformers_tpu_torch/csrc/epipolar_attention.cu",
        "replaces": REPLACES, "launches": launches, "max_abs_err": err,
        "ms": k_ms, "plain_ms": p_ms,
    }]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
