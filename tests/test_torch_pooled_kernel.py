"""The pooled attention's CUDA kernels (ops/epipolar_attention_pooled_cuda.py,
csrc/epipolar_attention_pooled.cu) == their plain twin, and the route that
takes them.

On the CPU: the layer gives the kernels the param recipe's config under
ATTENTION_IMPL 'auto' and leaves the POOLING configs they do not cover
(cos, max, a prior, softmax off, K above 64, a width other than 128, a
forced impl) on the plain chain; the wrapper on CPU tensors is the plain
chain bit for bit and launches nothing; the wrapper calls only entry
points the source defines.

Marked `cuda` (on the card, which has no JAX:
python -m pytest --noconftest tests/test_torch_pooled_kernel.py), at the
param cell's shape (B=16, 64x64, K=64 pooled to 32, C=128, bf16): the
kernels against the plain chain on the synthetic rig's lines at the
recipe's uncorrected normalization, on random locations that cross the
image's edges, with lines wholly outside the image, with exact ties
between the members of a pair, and with keys equal to values; out,
weights, rank, corr_pos and the three gradients.  Tolerances, and why:
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

import pytest
import torch

from epipolar_transformers_tpu_torch.config import flagship_cfg, update_from_dict
from epipolar_transformers_tpu_torch.models.epipolar import Epipolar
from epipolar_transformers_tpu_torch.ops import epipolar_attention_pooled_cuda as pk
from epipolar_transformers_tpu_torch.ops.epipolar_attention import (AttentionParams,
                                                                    epipolar_attention)

PARAM = {"EPIPOLAR": {"PARAMETERIZED": ("z", "theta", "phi", "g"), "POOLING": True,
                      "BOTTLENECK": 2, "ZRESIDUAL": False, "USE_CORRECT_NORMALIZE": False}}
PARAMS = AttentionParams(softmax_scale=0.125, pooling=True, correct_normalize=False)


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
@pytest.mark.parametrize("name", ["rig", "edges", "outside", "ties", "shared"])
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
@pytest.mark.parametrize("name", ["rig", "edges"])
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
