"""Fused epipolar attention: the hand-written Hopper kernels and their plain twin.

Counterpart of epipolar_transformers_tpu/ops/epipolar_attention_pallas.py
(`_make_kernel`, launched by `_pallas_attention`, wrapper
`epipolar_attention_pallas_batch`).  The CUDA forward in
csrc/epipolar_attention.cu computes what the TPU kernel and the two XLA
matmuls around it compute together: from the query, key and value features
and the sample locations straight to `out` and `depth`, without the
(HW, HW) Gram matrix or weight matrix ever reaching memory.  The CUDA
backward in the same file has no TPU counterpart (the JAX package trains by
`jax.grad` of its XLA matmul path) and is held to autograd of the plain
twin.  The source note says what bounds each and what the design does
about that.

`epipolar_attention_batch` is the wrapper the model calls: on CPU tensors
it runs the plain PyTorch version, differentiated by autograd; on CUDA
tensors it runs `EpipolarAttentionFn`, whose forward launches the forward
kernel (counted in `LAUNCHES`) and whose backward launches the backward
kernel (counted in `BACKWARD_LAUNCHES`), or raises.
`epipolar_attention_plain_batch` is the plain version on any device: the
Gram + corner-gather form with `torch.matmul`, mirroring the JAX math; the
CPU tests hold it to the JAX kernel and to `jax.grad` of the matmul path,
and the chip check holds both kernels to it.

Coverage is the TPU kernel's (`supports_pallas_attention`): avg attention
over dot or prior similarity, softmax on or off, an additive prior or
`priormul`, no sample pooling.  A prior that needs a gradient (the learned
prior table) is ROADMAP A10 and raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..geometry.camera import denormalize_pixel
from .epipolar_attention import NEG_INF, AttentionParams
from .quad_gather import axis_slot_weights

# kernel launches made by `epipolar_attention_batch` in this process:
# forward kernels, and backward kernels run by autograd
LAUNCHES = 0
BACKWARD_LAUNCHES = 0

KERNEL_CHANNELS = (32, 64, 128, 256)


def supports_fused_attention(params: AttentionParams) -> bool:
    """Configs the fused kernel covers: avg attention over dot or prior
    similarity, without sample pooling (cos/max and POOLING are ROADMAP A10)."""
    return (
        params.attention == "avg"
        and params.similarity in ("dot", "prior")
        and not params.pooling
    )


def _check_params(params: AttentionParams) -> None:
    if not supports_fused_attention(params):
        raise ValueError(
            f"fused epipolar attention covers avg attention with dot or prior "
            f"similarity and no pooling, not {params}; the other configs are "
            "ROADMAP A10")


def _compute_dtype(f1: torch.Tensor, f2k: torch.Tensor) -> torch.dtype:
    return torch.bfloat16 if torch.bfloat16 in (f1.dtype, f2k.dtype) else torch.float32


def _flat(feat1, other1, other2, sample_locs, prior):
    """NHWC features -> (B, HW, C) in the compute dtype, locations ->
    (B, K, HW, 2) f32, prior -> (B, K, HW) f32."""
    B, H, W, _ = feat1.shape
    K = sample_locs.shape[1]
    cd = _compute_dtype(feat1, other1)
    f1 = feat1.reshape(B, H * W, -1).to(cd)
    f2k = other1.reshape(B, H * W, -1).to(cd)
    # one tensor for keys and values stays one object, so that the backward
    # can sum both gradients into one buffer
    f2v = f2k if other2 is other1 else other2.reshape(B, H * W, -1).to(cd)
    locs = sample_locs.reshape(B, K, H * W, 2).to(torch.float32)
    prior = None if prior is None else prior.reshape(B, K, H * W).to(torch.float32)
    return f1, f2k, f2v, locs, prior


def _finish(out, depth, sample_locs, other2, params):
    """(B, HW, Cv) f32 out and (B, K, HW) f32 weights -> the JAX wrapper's
    contract: out (B, H, W, Cv) in other2's dtype, corr_pos (B, H, W, 2) at
    each pixel's highest-weight sample, depth (B, K, H, W)."""
    B, K, H, W, _ = sample_locs.shape
    HW = H * W
    out = out.reshape(B, H, W, -1).to(other2.dtype)
    best = torch.argmax(depth, dim=1)  # (B, HW), first maximum on ties
    locs = sample_locs.reshape(B, K, HW, 2)
    pos = torch.gather(locs, 1, best[:, None, :, None].expand(B, 1, HW, 2))[:, 0]
    corr_pos = denormalize_pixel(pos.reshape(B, H, W, 2), H, W,
                                 correct=params.correct_normalize)
    return out, corr_pos, depth.reshape(B, K, H, W)


def _plain_core(f1, f2k, f2v, locs, prior, H, W, params):
    """Gram + corner-gather form: G = f1 f2k^T, the four corner columns of
    G weighted into the similarity, then a scatter of the attention weights
    into n (B, HW, HW) and out = n f2v.  Returns out (B, HW, Cv) f32 and
    depth (B, K, HW) f32."""
    B, K, HW, _ = locs.shape
    x = (locs[..., 0] + 1.0) / 2.0 * (W - 1)
    y = (locs[..., 1] + 1.0) / 2.0 * (H - 1)
    xb, wx0, wx1 = axis_slot_weights(x, W)
    yb, wy0, wy1 = axis_slot_weights(y, H)
    base = yb * W + xb
    # corner flat indices (B, K, HW, 4); a zero-weight corner may fall off
    # the image and is clamped to a harmless in-range index
    idx = torch.stack([base, base + 1, base + W, base + W + 1], dim=-1).clamp(0, HW - 1)
    wc = torch.stack([wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1], dim=-1)
    idx = idx.permute(0, 2, 1, 3).reshape(B, HW, K * 4)
    wc = wc.permute(0, 2, 1, 3)  # (B, HW, K, 4)
    prior_q = None if prior is None else prior.permute(0, 2, 1)  # (B, HW, K)

    if params.similarity == "prior":
        w = prior_q
    else:
        G = torch.matmul(f1, f2k.transpose(1, 2))  # (B, HW, HW) compute dtype
        sim = (torch.gather(G, 2, idx).float().reshape(B, HW, K, 4) * wc).sum(-1)
        masked = torch.where(sim == 0.0, torch.full_like(sim, NEG_INF), sim)
        if prior_q is not None and not params.priormul:
            masked = masked + prior_q
        if params.softmax_enabled:
            w = torch.softmax(masked * params.softmax_scale, dim=-1)
            if prior_q is not None and params.priormul:
                w = w * prior_q
        else:
            w = masked / K

    n = torch.zeros(B, HW, HW, dtype=torch.float32, device=f1.device)
    n.scatter_add_(2, idx, (w[..., None] * wc).reshape(B, HW, K * 4))
    out = torch.matmul(n.to(f2v.dtype), f2v).float()
    return out, w.permute(0, 2, 1).contiguous()


def _transposed_backward_core(f1, f2k, f2v, locs, prior, dout, H, W, params):
    """The backward kernels' three passes in plain PyTorch, f32: per query
    the weights w, the logit gradients ds and dfeat1 (pass A); the entries
    (row, q, ds w_c, w w_c) of every corner with w_c != 0, in (q, k, c)
    order, stably sorted by key row (pass B); their sums per row (pass C).
    Returns dfeat1, dother1, dother2 (B, HW, C) f32."""
    B, K, HW, _ = locs.shape
    f1, f2k, f2v, dout = (t.float() for t in (f1, f2k, f2v, dout))
    x = (locs[..., 0] + 1.0) / 2.0 * (W - 1)
    y = (locs[..., 1] + 1.0) / 2.0 * (H - 1)
    xb, wx0, wx1 = axis_slot_weights(x, W)
    yb, wy0, wy1 = axis_slot_weights(y, H)
    base = yb * W + xb
    rows = torch.stack([base, base + 1, base + W, base + W + 1], -1).permute(0, 2, 1, 3)
    wc = torch.stack([wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1], -1).permute(0, 2, 1, 3)
    rows = torch.where(wc != 0, rows, torch.zeros_like(rows))  # (B, HW, K, 4)
    items = torch.arange(B, device=f1.device)[:, None, None, None]

    def corners(feat):  # (B, HW, K, 4, C) corner rows
        return feat[items, rows]

    def corner_dot(feat, vec):  # sum_c w_c <vec[q], feat[corner_c]>
        return (wc * (corners(feat) * vec[:, :, None, None, :]).sum(-1)).sum(-1)

    prior_q = None if prior is None else prior.float().permute(0, 2, 1)  # (B, HW, K)
    g = corner_dot(f2v, dout)
    if params.similarity == "prior":
        w, ds = prior_q, torch.zeros_like(g)
    else:
        sim = corner_dot(f2k, f1)
        masked = torch.where(sim == 0.0, torch.full_like(sim, NEG_INF), sim)
        if prior_q is not None and not params.priormul:
            masked = masked + prior_q
        if params.softmax_enabled:
            p = torch.softmax(masked * params.softmax_scale, dim=-1)
            mul = prior_q is not None and params.priormul
            w = p * prior_q if mul else p
            gp = g * prior_q if mul else g
            ds = params.softmax_scale * p * (gp - (p * gp).sum(-1, keepdim=True))
        else:
            w, ds = masked / K, g / K
        ds = torch.where(sim == 0.0, torch.zeros_like(ds), ds)
    dfeat1 = ((ds[..., None] * wc)[..., None] * corners(f2k)).sum((2, 3))

    b, q, k, c = torch.nonzero(wc, as_tuple=True)  # (q, k, c) order per item
    key_row = b * HW + rows[b, q, k, c]
    order = torch.argsort(key_row, stable=True)
    key_row, b, q, k, c = (t[order] for t in (key_row, b, q, k, c))
    weight = wc[b, q, k, c]

    def row_sums(coef, feat):
        out = torch.zeros(B * HW, f1.shape[-1], dtype=torch.float32, device=f1.device)
        out.index_add_(0, key_row, (coef[b, q, k] * weight)[:, None] * feat[b, q])
        return out.reshape(B, HW, -1)

    return dfeat1, row_sums(ds, f1), row_sums(w, dout)


def epipolar_attention_backward_plain(feat1, other1, other2, sample_locs,
                                      params: AttentionParams, dout, prior=None):
    """The gradients of sum(out * dout) with respect to feat1, other1 and
    other2 (each (B, H, W, C) f32), computed as the CUDA backward computes
    them: the key/value gradients as per-row sums of transposed entries
    rather than a scatter.  The tests hold it to autograd of the plain
    version and to jax.grad of the JAX matmul path."""
    _check_params(params)
    B, H, W, _ = feat1.shape
    f1, f2k, f2v, locs, prior_flat = _flat(feat1, other1, other2, sample_locs.detach(), prior)
    grads = _transposed_backward_core(f1, f2k, f2v, locs, prior_flat,
                                      dout.reshape(B, H * W, -1), H, W, params)
    return tuple(t.reshape(B, H, W, -1) for t in grads)


def _kernel_args(f1, f2k, f2v, locs, prior, params):
    """Check the inputs against what the kernels take; returns the library
    and the (pointers, sizes, flags) the C entry points share."""
    from ._build import load_library

    B, K, HW, _ = locs.shape
    C = f1.shape[-1]
    if f2k.shape[-1] != C or f2v.shape[-1] != C or C not in KERNEL_CHANNELS:
        raise ValueError(
            f"the CUDA kernel takes equal query, key and value widths in "
            f"{KERNEL_CHANNELS}, got {f1.shape[-1]}, {f2k.shape[-1]}, {f2v.shape[-1]}")
    lib = load_library("epipolar_attention")
    if not 1 <= K <= lib.epipolar_attention_max_samples():
        raise ValueError(f"the CUDA kernel takes at most "
                         f"{lib.epipolar_attention_max_samples()} samples, got {K}")
    for t in [f1, f2k, f2v, locs] + ([] if prior is None else [prior]):
        if t.device != f1.device:
            raise ValueError("all attention inputs must lie on one CUDA device")
        if t.data_ptr() % 16:
            raise ValueError("the CUDA kernel needs 16-byte aligned inputs")
    pointers = [f1.data_ptr(), f2k.data_ptr(), f2v.data_ptr(), locs.data_ptr(),
                None if prior is None else prior.data_ptr()]
    flags = [float(params.softmax_scale), int(params.similarity != "prior"),
             int(params.softmax_enabled), int(params.priormul)]
    return lib, pointers, flags


def _kernel_core(f1, f2k, f2v, locs, prior, H, W, params):
    """Launch the forward kernel of csrc/epipolar_attention.cu on the
    current stream."""
    global LAUNCHES
    lib, pointers, flags = _kernel_args(f1, f2k, f2v, locs, prior, params)
    B, K, HW, _ = locs.shape
    C = f1.shape[-1]
    out = torch.empty(B, HW, C, dtype=torch.float32, device=f1.device)
    depth = torch.empty(B, K, HW, dtype=torch.float32, device=f1.device)
    fn = lib.epipolar_attention_forward
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*pointers, out.data_ptr(), depth.data_ptr(),
             B, H, W, K, C, int(f1.dtype == torch.bfloat16), *flags,
             torch.cuda.current_stream(f1.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"epipolar_attention_forward failed: CUDA error {err}")
    LAUNCHES += 1
    return out, depth


def _kernel_backward(f1, f2k, f2v, locs, prior, dout, H, W, params,
                     need_keys: bool, need_values: bool, same_kv: bool):
    """Launch the backward kernels of csrc/epipolar_attention.cu on the
    current stream.  Returns f32 (dfeat1, dother1 or None, dother2 or None);
    when the keys and values are one tensor (same_kv) and both gradients are
    wanted, dother1 is their sum and dother2 None.  Every row of each
    gradient is written by the kernels; their scratch comes from here."""
    global BACKWARD_LAUNCHES
    lib, pointers, flags = _kernel_args(f1, f2k, f2v, locs, prior, params)
    B, K, HW, _ = locs.shape
    C = f1.shape[-1]
    if need_keys or need_values:
        # one shared-memory cursor per key row; int32 entry offsets; the
        # query index in an entry's upper 23 bits
        rows = lib.epipolar_attention_max_key_rows()
        if HW > rows or B * HW * K * 4 >= 2 ** 31 or B * HW >= 2 ** 23:
            raise ValueError(f"the CUDA backward of the key/value gradients takes H*W <= "
                             f"{rows}, B*H*W*K*4 < 2**31 and B*H*W < 2**23, got B={B}, "
                             f"H*W={HW}, K={K}")
    dout = dout.to(torch.float32).contiguous()
    dfeat1 = torch.empty(B, HW, C, dtype=torch.float32, device=f1.device)
    fused = same_kv and need_keys and need_values
    dother1 = torch.empty_like(dfeat1) if need_keys else None
    dother2 = None if fused else torch.empty_like(dfeat1) if need_values else None
    partials = 0 if dother1 is None and dother2 is None else \
        2 if dother1 is not None and dother2 is not None else 1
    size = lib.epipolar_attention_backward_scratch_bytes
    size.argtypes = [ctypes.c_int] * 6
    size.restype = ctypes.c_longlong
    nbytes = size(B, H, W, K, C, partials)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=f1.device) if nbytes else None
    fn = lib.epipolar_attention_backward
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptr = [None if t is None else t.data_ptr() for t in (dother1, dother2, scratch)]
    if fused:
        ptr[1] = ptr[0]
    err = fn(*pointers, dout.data_ptr(), dfeat1.data_ptr(), *ptr,
             B, H, W, K, C, int(f1.dtype == torch.bfloat16), *flags,
             torch.cuda.current_stream(f1.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"epipolar_attention_backward failed: CUDA error {err}")
    BACKWARD_LAUNCHES += 1
    return dfeat1, dother1, dother2


class EpipolarAttentionFn(torch.autograd.Function):
    """The CUDA kernels under autograd: (f1, f2k, f2v) (B, HW, C), locs
    (B, K, HW, 2) and prior (B, K, HW) or None -> out (B, HW, C) f32 and
    depth (B, K, HW) f32.

    The backward keeps only the inputs: it recomputes the slot data and the
    similarities rather than storing any (B, HW, K) intermediate.  Gradients
    flow to the three features; the key and value gradients are computed
    only when autograd asks for them.  Under OTHER_GRAD the keys and the
    values are one tensor: the kernels then return the sum of both
    gradients once, as the keys' gradient.  `depth` and the locations carry
    none.
    """

    @staticmethod
    def forward(ctx, f1, f2k, f2v, locs, prior, H, W, params):
        if prior is not None and prior.requires_grad:
            raise NotImplementedError(
                "a prior that needs a gradient (the learned EPIPOLAR.PRIOR table) is "
                "ROADMAP A10; the kernel backward treats the prior as a constant")
        out, depth = _kernel_core(f1, f2k, f2v, locs, prior, H, W, params)
        ctx.save_for_backward(f1, f2k, f2v, locs, prior)
        ctx.geometry = (H, W, params)
        ctx.same_kv = f2k is f2v
        ctx.mark_non_differentiable(depth)
        return out, depth

    @staticmethod
    def backward(ctx, dout, _ddepth):
        f1, f2k, f2v, locs, prior = ctx.saved_tensors
        H, W, params = ctx.geometry
        dfeat1, dother1, dother2 = _kernel_backward(
            f1, f2k, f2v, locs, prior, dout, H, W, params,
            need_keys=ctx.needs_input_grad[1], need_values=ctx.needs_input_grad[2],
            same_kv=ctx.same_kv)

        def cast(g, like):
            return None if g is None else g.to(like.dtype)

        return (cast(dfeat1, f1), cast(dother1, f2k), cast(dother2, f2v),
                None, None, None, None, None)


def _run(core, feat1, other1, other2, sample_locs, params, prior):
    _check_params(params)
    if params.similarity == "prior" and prior is None:
        raise ValueError("similarity 'prior' needs a prior")
    B, H, W, _ = feat1.shape
    sample_locs = sample_locs.detach()
    f1, f2k, f2v, locs, prior_flat = _flat(feat1, other1, other2, sample_locs, prior)
    out, depth = core(f1, f2k, f2v, locs, prior_flat, H, W, params)
    return _finish(out, depth, sample_locs, other2, params)


def epipolar_attention_plain_batch(feat1, other1, other2, sample_locs,
                                   params: AttentionParams, prior=None):
    """The plain PyTorch version, on any device (same contract as
    `epipolar_attention_batch`)."""
    return _run(_plain_core, feat1, other1, other2, sample_locs, params, prior)


def epipolar_attention_batch(feat1, other1, other2, sample_locs,
                             params: AttentionParams, prior=None):
    """Fused epipolar attention, the counterpart of
    `epipolar_attention_pallas_batch`.

    Args:
        feat1/other1/other2: (B, H, W, C) query, key and value features.
        sample_locs: (B, K, H, W, 2) normalized (-1, 1) locations.
        prior: optional (B, K, H, W) per-pair prior.
    Returns:
        out (B, H, W, Cv) in other2's dtype, corr_pos (B, H, W, 2),
        depth (B, K, H, W) f32.

    CPU tensors take the plain version (differentiated by autograd); CUDA
    tensors launch the forward kernel, and autograd the backward kernel.
    """
    if feat1.device.type == "cpu":
        core = _plain_core
    elif feat1.device.type == "cuda":
        core = EpipolarAttentionFn.apply
        # the kernel reads (B, H, W, C) rows in place: a channels_last
        # (B, C, H, W) activation permuted to NHWC is contiguous; anything
        # else would be copied on every call, so refuse it
        for name, t in (("feat1", feat1), ("other1", other1), ("other2", other2),
                        ("sample_locs", sample_locs), ("prior", prior)):
            if t is not None and not t.is_contiguous():
                raise ValueError(f"the CUDA kernel needs a contiguous {name} (NHWC, i.e. "
                                 f"channels_last activations), got strides {t.stride()}")
    else:
        raise ValueError(f"no epipolar attention for device {feat1.device}")
    return _run(core, feat1, other1, other2, sample_locs, params, prior)
