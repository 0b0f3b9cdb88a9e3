"""The pooled attention's CUDA kernels (ops/epipolar_attention_pooled_cuda.py,
csrc/epipolar_attention_pooled.cu) == their plain twin, and the route that
takes them.

On the CPU: the layer gives the kernels the param recipe's config under
ATTENTION_IMPL 'auto' and leaves the POOLING configs they do not cover
(cos, max, a prior, softmax off, K above 64, a width other than 128, a
forced impl) on the plain chain; the wrapper on CPU tensors is the plain
chain bit for bit and launches nothing; the wrapper calls only entry
points the source defines, each with as many arguments as the source
gives it; the backward's scratch at the param cell's shape is no larger
than before the scatter's redesign; the scatter-hit counter reads 0 on the
CPU route (no scatter runs there), and the plain model of the bucketing
that the card's test holds the counter to counts a sample's chunks.

Marked `cuda` (on the card, which has no JAX:
python -m pytest --noconftest tests/test_torch_pooled_kernel.py), at the
param cell's shape (B=16, 64x64, K=64 pooled to 32, C=128, bf16): the
kernels against the plain chain on the synthetic rig's lines at the
recipe's uncorrected normalization, on random locations that cross the
image's edges, with lines wholly outside the image, with exact ties
between the members of a pair, and with keys equal to values; out,
weights, rank, corr_pos and the three gradients; lines through one point
inside the image, which crowd a few rows with most of their chunks' terms;
the backward captured in a CUDA graph and replayed, bit-equal to the eager
call; the scatter-hit counter against the plain model of the bucketing; the
scratch's size.  Tolerances, and why:
the kernels form every pooled vector with the plain path's products and
sums in its order, so the pair max, its winners and the zero sentinel
agree bit for bit; the dot products, the softmax and the sums over slots
and rows run in f32 in another order (relative differences ~1e-6).  So
the f32 weights and ranks agree to rtol 1e-4 / atol 1e-6; out and the
gradients, rounded to bf16 at the end by both, to one bf16 step (rtol
2**-7) plus 1e-4 of the tensor's largest value for sums that cancel; and
corr_pos wherever the plain weights' best slot leads the next by more
than 1e-4 (a nearer tie may fall either way).  Two runs give the same
bits.
"""

import re
from pathlib import Path

import pytest
import torch

from epipolar_transformers_tpu_torch.config import flagship_cfg, update_from_dict
from epipolar_transformers_tpu_torch.models.epipolar import Epipolar
from epipolar_transformers_tpu_torch.ops import epipolar_attention_pooled_cuda as pk
from epipolar_transformers_tpu_torch.ops.epipolar_attention import (AttentionParams,
                                                                    epipolar_attention)
from epipolar_transformers_tpu_torch.utils import tracing

PARAM = {"EPIPOLAR": {"PARAMETERIZED": ("z", "theta", "phi", "g"), "POOLING": True,
                      "BOTTLENECK": 2, "ZRESIDUAL": False, "USE_CORRECT_NORMALIZE": False}}
PARAMS = AttentionParams(softmax_scale=0.125, pooling=True, correct_normalize=False)
SOURCE = (Path(pk.__file__).resolve().parents[1] / "csrc" /
          "epipolar_attention_pooled.cu").read_text()
# pooled_backward_scratch_bytes(16, 64, 64, 64), the param cell's shape, before
# the scatter kept its sums in registers (read on an H100)
SCRATCH_BEFORE = 234_881_280


def _param_cfg(tiny=False, **epipolar):
    cfg = update_from_dict(flagship_cfg(tiny=tiny), PARAM)
    return update_from_dict(cfg, {"EPIPOLAR": epipolar, "DATASETS": {"CAMERAS": (0, 1, 2, 3)}})


# ---- on the CPU ----------------------------------------------------------------

@pytest.mark.parametrize("tiny", [True, False])
def test_the_param_config_takes_the_kernels(tiny):
    layer = Epipolar(_param_cfg(tiny))
    assert layer.route == "streaming" and layer.pooled_kernel


@pytest.mark.parametrize("epipolar,route", [
    (dict(SIMILARITY="cos"), "streaming"),
    (dict(ATTENTION="max"), "streaming"),
    (dict(PRIOR=True), "streaming"),
    (dict(SOFTMAX_ENABLED=False), "streaming"),
    (dict(SAMPLESIZE=128), "streaming"),
    (dict(BOTTLENECK=1), "streaming"),
    (dict(ATTENTION_IMPL="pooled"), "pooled"),
    (dict(ATTENTION_IMPL="streaming"), "streaming"),
    (dict(ATTENTION_IMPL="reference"), "plain"),
], ids=["cos", "max", "prior", "nosoftmax", "k128", "c256", "impl_pooled", "impl_streaming",
        "impl_reference"])
def test_configs_the_kernels_do_not_cover_keep_their_route(epipolar, route):
    layer = Epipolar(_param_cfg(True, **epipolar))
    assert layer.route == route and not layer.pooled_kernel


def _cpu_inputs(seed, C=128, K=8, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    feats = [torch.randn(2, 6, 5, C, generator=g).to(dtype).requires_grad_() for _ in range(3)]
    locs = torch.rand(2, K, 6, 5, 2, generator=g) * 2.6 - 1.3
    return feats, locs


@pytest.fixture
def deterministic():
    """The plain chain's index_put backward sums in a fixed order (on the
    CPU it otherwise splits rows over threads)."""
    saved = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(saved)


@pytest.mark.parametrize("depth", ["rank", "weights"])
@pytest.mark.parametrize("shared", [False, True])
def test_the_cpu_wrapper_is_the_plain_chain(deterministic, depth, shared):
    runs = []
    before = (pk.LAUNCHES, pk.BACKWARD_LAUNCHES)
    for fn in (pk.epipolar_attention_pooled_kernel, epipolar_attention):
        feats, locs = _cpu_inputs(0)
        q, k, v = feats
        out, corr_pos, stack = fn(q, k, k if shared else v, locs, PARAMS, shared_kv=shared,
                                  depth=depth)
        (out * torch.linspace(-1, 1, out.numel()).reshape(out.shape)).sum().backward()
        runs.append([out, corr_pos, stack, q.grad, k.grad] + ([] if shared else [v.grad]))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert (pk.LAUNCHES, pk.BACKWARD_LAUNCHES) == before


@pytest.mark.parametrize("params", [PARAMS._replace(similarity="cos"),
                                    PARAMS._replace(attention="max"),
                                    PARAMS._replace(softmax_enabled=False),
                                    PARAMS._replace(pooling=False)],
                         ids=["cos", "max", "nosoftmax", "nopooling"])
def test_the_wrapper_refuses_what_the_kernels_do_not_cover(params):
    feats, locs = _cpu_inputs(1)
    with pytest.raises(ValueError, match="pooled kernels"):
        pk.epipolar_attention_pooled_kernel(*feats, locs, params)


def test_the_wrapper_calls_only_entry_points_the_source_defines():
    """The wrapper's ctypes calls name functions of the library's C
    interface (the library builds on the card only)."""
    import inspect
    import re
    from pathlib import Path

    source = (Path(pk.__file__).resolve().parents[1] / "csrc" /
              "epipolar_attention_pooled.cu").read_text()
    defined = set(re.findall(r"^(?:int|long long) (pooled_\w+)\(", source.split('extern "C"')[1],
                             re.M))
    called = set(re.findall(r"lib\(?\)?\.(pooled_\w+)", inspect.getsource(pk)))
    called |= set(re.findall(r"_library\(\)\.(pooled_\w+)", inspect.getsource(pk)))
    assert called and called <= defined, called - defined


def test_the_wrapper_declares_each_entry_points_arguments(monkeypatch):
    """Every argtypes list the wrapper declares has as many entries as the
    C function has parameters (ctypes would pass a wrong count silently)."""
    from types import SimpleNamespace

    from epipolar_transformers_tpu_torch.ops import _build

    class Lib:
        def __getattr__(self, name):
            fn = SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "load_library", lambda name: Lib())
    lib = pk._library.__wrapped__()
    params = {name: len([p for p in args.split(",") if p.strip()])
              for name, args in re.findall(r"^(?:int|long long) (pooled_\w+)\(([^)]*)\)",
                                           SOURCE.split('extern "C"')[1], re.M)}
    declared = {name: len(fn.argtypes) for name, fn in vars(lib).items()
                if hasattr(fn, "argtypes")}
    assert declared and declared == {name: params[name] for name in declared}


def _constant(name):
    return int(re.search(rf"\b{name} = (\d+)[;,]", SOURCE).group(1))


def _scratch_bytes(B, H, W, K):
    """pooled_backward_scratch_bytes as the source's carve_backward lays the
    scratch out: ds, the two winner-bit sets, the samples' rows, the
    bucketing's table (a count a chunk of kChunkH x kChunkW pixels and
    segment of kSegment samples) and the lists, each piece 256-byte
    aligned."""
    HW, segment = H * W, _constant("kSegment")
    chunks = -(-H // _constant("kChunkH")) * -(-W // _constant("kChunkW"))
    slots, samples = B * HW * (K // 2), B * HW * K
    table = B * (chunks * -(-HW * K // segment) + 1)
    pieces = (slots * 4, slots * 32, slots * 32, samples * 4, table * 4, samples * 4 * 4)
    return sum(-(-n // 256) * 256 for n in pieces)


def test_the_scratch_is_no_larger_than_before():
    assert _scratch_bytes(16, 64, 64, 64) <= SCRATCH_BEFORE


def scatter_hits(locs, shape=(2, 4)):
    """The (sample, chunk) entries of the backward's bucketing, in plain
    torch: for each sample of (B, K, H, W, 2) locations, the distinct chunks
    of `shape` pixels (rows by columns) among its live corners' pixels (the
    kernels' bilinear weights, align_corners, a zero weight dead)."""
    _, _, H, W, _ = locs.shape
    locs = locs.float()

    def axis(coord, size):
        c0 = torch.floor(coord)
        frac = coord - c0
        hi = float(size - 1)
        base = c0.clamp(0, hi).long()
        valid0 = (c0 >= 0) & (c0 <= hi)
        valid1 = (c0 + 1 >= 0) & (c0 + 1 <= hi)
        zero = torch.zeros_like(frac)
        w0 = torch.where(c0 < 0, torch.where(valid1, frac, zero),
                         torch.where(valid0, 1 - frac, zero))
        w1 = torch.where(c0 < 0, zero, torch.where(valid1, frac, zero))
        return base, w0, w1

    xb, x0, x1 = axis((locs[..., 0] + 1.0) / 2.0 * (W - 1), W)
    yb, y0, y1 = axis((locs[..., 1] + 1.0) / 2.0 * (H - 1), H)
    across = -(-W // shape[1])
    chunk = torch.stack([(yb + dy) // shape[0] * across + (xb + dx) // shape[1]
                         for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1))])
    live = torch.stack([y0 * x0, y0 * x1, y1 * x0, y1 * x1]) != 0
    entries = 0
    for j in range(4):
        new = live[j]
        for i in range(j):
            new = new & ~(live[i] & (chunk[i] == chunk[j]))
        entries += int(new.sum())
    return entries


def test_the_bucketing_model_counts_each_samples_chunks():
    """17 x 17 keys in chunks of 2 x 4 pixels: a sample on a pixel has one
    live corner; one between pixels 4, in 1 chunk where the 2 x 2 block lies
    inside one, 2 where it crosses a chunk's rows, 4 where it crosses its
    rows and columns; on the last image row 2 corners in 1 chunk; off the
    image none (x, y in pixels, normalized by 16 = W - 1)."""
    pixels = torch.tensor([[4.0, 3.0], [5.5, 2.5], [4.5, 3.5], [7.5, 3.5], [4.5, 16.0],
                           [-9.0, -9.0]])
    locs = (pixels / 8.0 - 1.0).reshape(1, 6, 1, 1, 2).expand(1, 6, 17, 17, 2)
    each = [scatter_hits(locs[:, i:i + 1]) // (17 * 17) for i in range(6)]
    assert each == [1, 1, 2, 4, 1, 0]
    assert scatter_hits(locs) == 9 * 17 * 17


def test_the_scatter_hits_counter_reads_0_on_the_cpu_route():
    """On CPU tensors the wrapper runs the plain chain, which has no
    scatter: tracing drains no `attn.pooled_scatter_hits`."""
    tracing.disable()
    tracing.drain()
    feats, locs = _cpu_inputs(2)
    tracing.enable()
    try:
        out = pk.epipolar_attention_pooled_kernel(*feats, locs, PARAMS)[0]
        out.square().sum().backward()
    finally:
        tracing.disable()
    counters = tracing.drain()[1]
    assert counters.get((-1, "attn.pooled_scatter_hits"), 0) == 0
    assert all(t.device.type != "cpu" for t in pk.SCATTER_HITS.values())


# ---- on the card ---------------------------------------------------------------

B, H, W, K, C = 16, 64, 64, 64, 128


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = saved


def _rig_locs(device, batch=B):
    """(batch, K, 64, 64, 2) locations of the synthetic rig's view pairs
    (each view with its nearest neighbour, cycled) at the param recipe's
    uncorrected normalization."""
    from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
    from epipolar_transformers_tpu_torch.ops.epipolar_sampling import epipolar_sample_locs

    cfg = _param_cfg()
    ds = SyntheticMultiview(cfg, is_train=False, n_samples=1)
    views = [v % ds.n_views for v in range(batch)]
    P1 = torch.as_tensor(ds.rig["KRT"][views], dtype=torch.float32, device=device)
    P2 = torch.as_tensor(ds.rig["KRT"][[ds.nearest[v] for v in views]],
                         dtype=torch.float32, device=device)
    return epipolar_sample_locs(P1, P2, Epipolar(cfg).geometry).contiguous()


def _case(name, device):
    """(q, k, v, locs) of one case, bf16 features at the cell's shape."""
    g = torch.Generator(device=device).manual_seed(sum(map(ord, name)))

    def feats():
        return torch.randn(B, H, W, C, device=device, generator=g).to(torch.bfloat16)

    locs = _rig_locs(device)
    q, k, v = feats(), feats(), feats()
    if name == "edges":  # random locations: lines cross the image's edges
        locs = torch.rand(B, K, H, W, 2, device=device, generator=g) * 2.6 - 1.3
    elif name == "outside":  # a quarter of the queries' lines miss the image
        locs = locs.clone()
        locs[:, :, :H // 4] = -9.0
    elif name == "ties":
        # small integers, and pairs whose members coincide on every other
        # column: their channels tie exactly between the two members
        def ints():
            return torch.randint(-2, 3, (B, H, W, C), device=device,
                                 generator=g).to(torch.bfloat16)
        q, k, v = ints(), ints(), ints()
        locs = locs.clone()
        locs[:, K // 2:, :, ::2] = locs[:, :K // 2, :, ::2]
    elif name == "shared":
        v = k
    elif name == "crowded":
        # every query's line runs through one point inside the image (an
        # epipole in view), its samples closest there: the few rows around
        # it take most of their chunks' terms
        ys, xs = torch.meshgrid(torch.linspace(-1, 1, H, device=device),
                                torch.linspace(-1, 1, W, device=device), indexing="ij")
        pixel = torch.stack([xs, ys], -1)
        epipole = torch.tensor([0.13, -0.21], device=device)
        t = torch.linspace(-1, 1, K, device=device).sign() * torch.linspace(
            -1, 1, K, device=device).square()
        locs = (epipole + t[:, None, None, None] * (pixel - epipole)).expand(B, K, H, W, 2)
        locs = locs.contiguous()
    return q, k, v, locs


def _run(fn, q, k, v, locs, depth):
    leaves = [t.clone().requires_grad_() for t in ((q, k) if v is k else (q, k, v))]
    kv = leaves[1]
    out, corr_pos, stack = fn(leaves[0], kv, kv if v is k else leaves[2], locs, PARAMS,
                              shared_kv=v is k, depth=depth)
    r = torch.randn(out.shape, device=out.device,
                    generator=torch.Generator(device=out.device).manual_seed(5))
    (out.float() * r).sum().backward()
    return [out.detach(), corr_pos, stack.detach()] + [t.grad for t in leaves]


def _close(name, got, want):
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=2 ** -7, atol=1e-4 * scale, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rig", "edges", "outside", "ties", "shared", "crowded"])
def test_kernels_match_the_plain_chain(device, name):
    q, k, v, locs = _case(name, device)
    before = (pk.LAUNCHES, pk.BACKWARD_LAUNCHES)
    got = _run(pk.epipolar_attention_pooled_kernel, q, k, v, locs, "weights")
    assert (pk.LAUNCHES, pk.BACKWARD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    want = _run(epipolar_attention, q, k, v, locs, "weights")
    torch.cuda.synchronize()
    _close("out", got[0], want[0])
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=1e-6, msg="weights")
    top2 = want[2].topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-4
    assert torch.equal(got[1][clear], want[1][clear]), "corr_pos"
    for label, a, b in zip(("dq", "dk", "dv"), got[3:], want[3:]):
        _close(label, a, b)
    rank = pk.epipolar_attention_pooled_kernel(q, k, v, locs, PARAMS, shared_kv=v is k,
                                               depth="rank")[2]
    want_rank = epipolar_attention(q, k, v, locs, PARAMS, shared_kv=v is k, depth="rank")[2]
    torch.testing.assert_close(rank, want_rank, rtol=1e-4, atol=1e-6, msg="rank")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("samples", [64, 8, 2])
def test_other_widths_and_sample_counts(device, dtype, samples):
    """Both feature types and other sample counts on a small edge-crossing
    shape: f32 to rtol 1e-4 / atol 1e-5 x max (summation order alone)."""
    channels = pk.POOLED_KERNEL_WIDTH
    g = torch.Generator(device=device).manual_seed(channels + samples)
    q, k, v = (torch.randn(3, 12, 10, channels, device=device, generator=g).to(dtype)
               for _ in range(3))
    locs = torch.rand(3, samples, 12, 10, 2, device=device, generator=g) * 2.6 - 1.3
    got = _run(pk.epipolar_attention_pooled_kernel, q, k, v, locs, "weights")
    want = _run(epipolar_attention, q, k, v, locs, "weights")
    for label, a, b in zip(("out", "corr_pos", "weights", "dq", "dk", "dv"), got, want):
        if label == "corr_pos":
            continue
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()),
                                       msg=label)
        else:
            _close(label, a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rig", "edges", "crowded"])
def test_two_runs_are_bit_equal(device, name):
    q, k, v, locs = _case(name, device)
    first = _run(pk.epipolar_attention_pooled_kernel, q, k, v, locs, "rank")
    second = _run(pk.epipolar_attention_pooled_kernel, q, k, v, locs, "rank")
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_the_wrapper_refuses_what_the_kernels_do_not_take(device):
    assert pk._library().pooled_max_samples() == pk.MAX_SAMPLES
    assert pk._library().pooled_channels() == pk.POOLED_KERNEL_WIDTH
    q, k, v, locs = _case("rig", device)
    with pytest.raises(ValueError, match="contiguous"):
        pk.epipolar_attention_pooled_kernel(q.transpose(1, 2), k, v, locs, PARAMS)
    with pytest.raises(ValueError, match="one type"):
        pk.epipolar_attention_pooled_kernel(q.float(), k, v, locs, PARAMS)
    with pytest.raises(ValueError, match="even K"):
        pk.epipolar_attention_pooled_kernel(q, k, v, locs[:, :3].contiguous(), PARAMS)
    with pytest.raises(ValueError, match="widths of 128"):
        wide = torch.cat([v, v], -1)
        pk.epipolar_attention_pooled_kernel(q, k, wide, locs, PARAMS)


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [False, True], ids=["apart", "shared"])
def test_a_captured_backward_replays_bit_equal_to_the_eager_call(device, shared):
    """The forward runs eagerly on a side stream, so that autograd runs the
    backward there: eagerly, then captured and replayed."""
    q, k, v, locs = _case("shared" if shared else "rig", device)
    leaves = [t.clone().requires_grad_() for t in ((q, k) if shared else (q, k, v))]
    r = torch.randn(B, H, W, C, device=device,
                    generator=torch.Generator(device=device).manual_seed(5)).to(q.dtype)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = pk.epipolar_attention_pooled_kernel(leaves[0], leaves[1], leaves[-1], locs, PARAMS,
                                                  shared_kv=shared)[0]

        def backward():
            return torch.autograd.grad(out, leaves, r, retain_graph=True)

        eager = [t.clone() for t in backward()]
        backward()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = backward()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(captured, eager):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rig", "edges", "crowded"])
def test_the_scatter_hits_counter_is_the_bucketings_count(device, name):
    q, k, v, locs = _case(name, device)
    pk.SCATTER_HITS.clear()
    _run(pk.epipolar_attention_pooled_kernel, q, k, v, locs, "weights")
    assert int(pk.SCATTER_HITS[device].item()) == scatter_hits(locs.cpu())
    pk.SCATTER_HITS.clear()


@pytest.mark.cuda
def test_the_scratch_size_is_the_layouts(device):
    for shape in ((16, 64, 64, 64), (3, 12, 10, 8), (1, 1, 1, 2)):
        assert pk._library().pooled_backward_scratch_bytes(*shape) == _scratch_bytes(*shape)
    assert pk._library().pooled_backward_scratch_bytes(16, 64, 64, 64) <= SCRATCH_BEFORE
