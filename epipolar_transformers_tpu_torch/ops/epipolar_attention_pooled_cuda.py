"""Pooled epipolar attention: the hand-written Hopper kernels and their plain twin.

The POOLING configs of the paper's fully parameterized model (avg
attention, dot similarity, softmax, no prior) on the card.  The CUDA
forward and backward in csrc/epipolar_attention_pooled.cu compute what
ops/epipolar_attention.py computes with `pooling` on, without writing the
(N, K, H*W, C) sample stack to device memory; no TPU kernel exists for the
function (the JAX package runs its plain gathers and einsums).  The source
note says what bounds the kernels and what their design does about it.

`epipolar_attention_pooled_kernel` is the wrapper the layer calls: on CPU
tensors it runs the plain chain (`ops.epipolar_attention.
epipolar_attention`), differentiated by autograd; on CUDA tensors it runs
`PooledAttentionFn`, whose forward launches the forward kernel (counted
once a call in `LAUNCHES`) and whose backward launches the backward
kernels (counted in `BACKWARD_LAUNCHES`), or raises.  The kernels take the
param model's width, 128 channels, in f32 or bf16.

Each backward adds the (sample, chunk) entries its scatter walks to
`SCATTER_HITS`, on the device, from the per-item totals its bucketing
leaves in the scratch: utils/tracing.py zeroes it when tracing turns on and
reports its sum as the counter `attn.pooled_scatter_hits` (over
`attn.pooled_samples`, the lists' expansion, which sets the scatter's
gathers); a CUDA graph's replay adds into the tensor its capture added
into.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..geometry.camera import denormalize_pixel
from ..utils import tracing
from .epipolar_attention import AttentionParams, epipolar_attention

# kernel launches made by `epipolar_attention_pooled_kernel` in this
# process: forward kernels, and backward kernels run by autograd
LAUNCHES = 0
BACKWARD_LAUNCHES = 0

POOLED_KERNEL_WIDTH = 128
MAX_SAMPLES = 64

# the scatter's entries, summed on each device into an int64 (1,) tensor
# keyed by the device
SCATTER_HITS: dict = {}
tracing.register_device_counts(SCATTER_HITS, ("attn.pooled_scatter_hits",))


def supports_pooled_kernel(params: AttentionParams) -> bool:
    """The POOLING configs the kernels cover: avg attention over dot
    similarity with the softmax on (and no prior: the caller's to check)."""
    return (params.pooling and params.attention == "avg" and params.similarity == "dot"
            and params.softmax_enabled)


def kernel_shape(samples: int, widths) -> bool:
    """Whether the kernels take K `samples` (pooled in pairs) and the
    queries', keys' and values' `widths`."""
    return (2 <= samples <= MAX_SAMPLES and samples % 2 == 0
            and set(widths) == {POOLED_KERNEL_WIDTH})


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernels' library (ops/_build.py), with the C signatures of its
    launch and scratch-size entry points declared once."""
    from ._build import load_library

    lib = load_library("epipolar_attention_pooled")
    lib.pooled_backward_scratch_bytes.argtypes = [ctypes.c_int] * 4
    lib.pooled_backward_scratch_bytes.restype = ctypes.c_longlong
    lib.pooled_scatter_hits_offset.argtypes = [ctypes.c_int] * 4
    lib.pooled_scatter_hits_offset.restype = ctypes.c_longlong
    lib.pooled_scatter_hits_stride.argtypes = [ctypes.c_int] * 3
    lib.pooled_scatter_hits_stride.restype = ctypes.c_longlong
    lib.pooled_forward.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.pooled_backward.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.pooled_forward.restype = ctypes.c_int
    lib.pooled_backward.restype = ctypes.c_int
    return lib


def _check(q, k, v, locs) -> None:
    """Raise unless the kernels take these (B, HW, C) features and
    (B, K, HW, 2) locations."""
    B, HW, C = q.shape
    K = locs.shape[1]
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"the pooled kernels take f32 or bf16 features of one type, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not kernel_shape(K, (C, k.shape[-1], v.shape[-1])):
        raise ValueError(f"the pooled kernels take an even K <= {MAX_SAMPLES} and query, key "
                         f"and value widths of {POOLED_KERNEL_WIDTH}, got K={K}, "
                         f"{C}, {k.shape[-1]}, {v.shape[-1]}")
    if HW > _library().pooled_max_rows():
        raise ValueError(f"the pooled kernels take at most {_library().pooled_max_rows()} "
                         f"rows an item, got {HW}")
    if locs.dtype != torch.float32:
        raise ValueError(f"the pooled kernels take f32 sample locations, got {locs.dtype}")
    for t in (q, k, v, locs):
        if t.device != q.device:
            raise ValueError("all attention inputs must lie on one CUDA device")
        if t.data_ptr() % 16:
            raise ValueError("the pooled kernels need 16-byte aligned inputs")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _forward(q, k, v, locs, H, W, scale):
    """Launch the forward kernel on the current stream.  Returns out
    (B, HW, C) in the features' type, weights (B, K/2, HW) f32 and rank
    (B, HW) f32."""
    global LAUNCHES
    _check(q, k, v, locs)
    lib = _library()
    B, HW, C = q.shape
    K = locs.shape[1]
    out = torch.empty_like(q)
    weights = torch.empty(B, K // 2, HW, dtype=torch.float32, device=q.device)
    rank = torch.empty(B, HW, dtype=torch.float32, device=q.device)
    err = lib.pooled_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(), locs.data_ptr(),
                             out.data_ptr(), weights.data_ptr(), rank.data_ptr(), B, H, W, K,
                             C, int(q.dtype == torch.bfloat16), scale, _stream(q.device))
    if err != 0:
        raise RuntimeError(f"pooled_forward failed: CUDA error {err}")
    LAUNCHES += 1
    return out, weights, rank


def _backward(q, k, v, locs, weights, dout, H, W, scale):
    """Launch the backward kernels on the current stream: the per-query
    kernel, then the key/value scatter.  Returns dq, dk, dv in the features' type; with v None (keys
    and values one tensor) dk is the sum of both gradients and dv None."""
    global BACKWARD_LAUNCHES
    lib = _library()
    B, HW, C = q.shape
    K = locs.shape[1]
    dout = dout.to(q.dtype).contiguous()
    if dout.data_ptr() % 16:  # the scatter copies its rows 16 bytes at a time
        dout = dout.clone()
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = None if v is None else torch.empty_like(v)
    scratch = torch.empty(lib.pooled_backward_scratch_bytes(B, H, W, K), dtype=torch.uint8,
                          device=q.device)
    err = lib.pooled_backward(q.data_ptr(), k.data_ptr(), (k if v is None else v).data_ptr(),
                              locs.data_ptr(), weights.data_ptr(), dout.data_ptr(),
                              scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                              None if dv is None else dv.data_ptr(), B, H, W, K, C,
                              int(q.dtype == torch.bfloat16), scale, _stream(q.device))
    if err != 0:
        raise RuntimeError(f"pooled_backward failed: CUDA error {err}")
    BACKWARD_LAUNCHES += 1
    _count_hits(lib, scratch, B, H, W, K)
    return dq, dk, dv


def _count_hits(lib, scratch, B, H, W, K) -> None:
    """Add a backward's scatter entries, the per-item totals its bucketing
    left in `scratch`, to `SCATTER_HITS[device]`, on the device."""
    at = lib.pooled_scatter_hits_offset(B, H, W, K) // 4
    stride = lib.pooled_scatter_hits_stride(H, W, K)
    totals = scratch.view(torch.int32).as_strided((B,), (stride,), at)
    total = SCATTER_HITS.get(scratch.device)
    if total is None:
        # a normal tensor even under inference_mode, so that later calls
        # with autograd may add to it
        with torch.inference_mode(False):
            total = SCATTER_HITS[scratch.device] = torch.zeros(1, dtype=torch.int64,
                                                               device=scratch.device)
    total += totals.sum()


class PooledAttentionFn(torch.autograd.Function):
    """The CUDA kernels under autograd: q, k, v (B, HW, C) and locs
    (B, K, HW, 2) -> out (B, HW, C), weights (B, K/2, HW) f32 and rank
    (B, HW) f32.  The backward keeps the inputs and the weights.  When the keys and the values are one tensor the
    backward returns the sum of both gradients once, as the keys'."""

    @staticmethod
    def forward(ctx, q, k, v, locs, H, W, scale):
        out, weights, rank = _forward(q, k, v, locs, H, W, scale)
        ctx.same_kv = k is v
        ctx.save_for_backward(q, k, None if ctx.same_kv else v, locs, weights)
        ctx.geometry = (H, W, scale)
        ctx.mark_non_differentiable(weights, rank)
        return out, weights, rank

    @staticmethod
    def backward(ctx, dout, _dweights, _drank):
        q, k, v, locs, weights = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, locs, weights, dout, *ctx.geometry)
        return dq, dk, dv, None, None, None, None


def epipolar_attention_pooled_kernel(feat1, other1, other2, sample_locs,
                                     params: AttentionParams, shared_kv: bool = False,
                                     depth: str = "weights"):
    """Pooled attention; arguments and returns as
    `ops.epipolar_attention.epipolar_attention` with `pooling` on (no
    prior).  CPU tensors take the plain chain, differentiated by autograd;
    CUDA tensors launch the kernels, and autograd the backward kernels."""
    if not supports_pooled_kernel(params):
        raise ValueError(f"the pooled kernels take POOLING with avg attention, dot "
                         f"similarity and the softmax on, not {params}")
    if feat1.device.type == "cpu":
        return epipolar_attention(feat1, other1, other2, sample_locs, params,
                                  shared_kv=shared_kv, depth=depth)
    if feat1.device.type != "cuda":
        raise ValueError(f"no pooled attention for device {feat1.device}")
    # the kernels read (B, H, W, C) rows in place: a channels_last activation
    # permuted to NHWC is contiguous; anything else would be copied on every
    # call, so refuse it
    for name, t in (("feat1", feat1), ("other1", other1), ("other2", other2),
                    ("sample_locs", sample_locs)):
        if not t.is_contiguous():
            raise ValueError(f"the pooled kernels need a contiguous {name} (NHWC, i.e. "
                             f"channels_last activations), got strides {t.stride()}")
    B, H, W, C = feat1.shape
    K = sample_locs.shape[1]
    HW = H * W
    locs = sample_locs.detach().reshape(B, K, HW, 2)
    q, k = feat1.reshape(B, HW, C), other1.reshape(B, HW, -1)
    v = k if shared_kv or other2 is other1 else other2.reshape(B, HW, -1)
    out, weights, rank = PooledAttentionFn.apply(q, k, v, locs, H, W,
                                                 float(params.softmax_scale))
    # the best slot's first member, as the plain path takes it (first
    # maximum of the weights)
    best = weights.argmax(1)
    pos = torch.gather(locs[:, :K // 2], 1, best[:, None, :, None].expand(B, 1, HW, 2))[:, 0]
    corr_pos = denormalize_pixel(pos.reshape(B, H, W, 2), H, W,
                                 correct=params.correct_normalize).detach()
    stack = rank.reshape(B, 1, H, W) if depth == "rank" else weights.reshape(B, -1, H, W)
    return out.reshape(B, H, W, -1), corr_pos, stack
