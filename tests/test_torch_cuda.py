"""The CUDA epipolar-attention kernels == their plain PyTorch version, on the card.

Marked `cuda`: each test skips where torch sees no GPU.  On the card (which
has no JAX, so the suite's conftest is skipped):

    python -m pytest --noconftest tests/test_torch_cuda.py

Covers what chip_smoke.py does not: every channel width the kernels take,
sample counts that are not a multiple of the warp (1, 17, 33, 128), and the
wrapper's checks.  The forward: f32 rtol 1e-4 / atol 1e-5 (summation order
only, TF32 off); bf16 rtol = atol = 5e-2 (the plain version rounds the Gram
and weight matrices to bf16).  The backward kernel against autograd of the
plain version: f32 rtol 1e-4 / atol 1e-5 x the gradient's max (summation
order); bf16 rtol 5e-2 / atol 5e-2 x max; the learned prior's gradient in
each of its five modes the same way.  Both kernels sum in a fixed
order, so two runs on the same inputs are bit-equal.  Most locations are
random in (-1.3, 1.3), so lines cross the image edges and both kernels run
their per-query paths; the synthetic rig's epipolar lines (64x64) drive the
tile paths, with the tiles on each path read by `tile_counts()` and
`backward_tile_counts()`; a lowered backward union cap puts both of the
backward's paths in one launch.
"""

import pytest
import torch

from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn
from epipolar_transformers_tpu_torch.ops.epipolar_attention import AttentionParams

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(device, B, H, W, K, C, dtype, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    feats = [torch.randn(B, H, W, C, device=device, generator=g).to(dtype) for _ in range(3)]
    locs = torch.rand(B, K, H, W, 2, device=device, generator=g) * 2.6 - 1.3
    prior = torch.rand(B, K, H, W, device=device, generator=g) * 0.1
    return feats, locs, prior


CASES = [
    ("dot", dict(), False),
    ("nosoftmax", dict(softmax_enabled=False), False),
    ("prior_add", dict(), True),
    ("prior_mul", dict(priormul=True), True),
    ("prior_sim", dict(similarity="prior"), True),
]
# bf16 with softmax off is left out: a sim that rounds to exactly 0 in one
# version only is masked to -1e10/K there (the zero-sentinel semantics), so
# the two legitimately differ at such samples
CASES = [(dt, *c) for dt in ("f32", "bf16") for c in CASES
         if not (dt == "bf16" and c[0] == "nosoftmax")]


@pytest.mark.parametrize("C", [32, 64, 128, 256])
@pytest.mark.parametrize("K", [1, 33, 128])
@pytest.mark.parametrize("dt,name,kw,use_prior", CASES, ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_kernel_matches_plain(device, C, K, dt, name, kw, use_prior):
    dtype = torch.float32 if dt == "f32" else torch.bfloat16
    feats, locs, prior = _inputs(device, 2, 12, 10, K, C, dtype)
    params = AttentionParams(softmax_scale=K ** -0.5, **kw)
    prior = prior if use_prior else None
    before = attn.LAUNCHES
    got = attn.epipolar_attention_batch(*feats, locs, params, prior)
    assert attn.LAUNCHES == before + 1
    want = attn.epipolar_attention_plain_batch(*feats, locs, params, prior)
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else dict(rtol=5e-2, atol=5e-2)
    torch.testing.assert_close(got[0].float(), want[0].float(), **tol)
    torch.testing.assert_close(got[2], want[2], **tol)


def _rig_locs(device, B, K):
    """(B, K, 64, 64, 2) sample locations of the synthetic rig's view pairs
    (each view with its nearest neighbour, cycled), with K samples a line:
    queries on one epipolar line share their samples, so the forward's
    tiles take the tile path."""
    from epipolar_transformers_tpu_torch.config import flagship_cfg
    from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
    from epipolar_transformers_tpu_torch.models.epipolar import Epipolar
    from epipolar_transformers_tpu_torch.ops.epipolar_sampling import epipolar_sample_locs

    cfg = flagship_cfg()
    ds = SyntheticMultiview(cfg, is_train=False, n_samples=1)
    views = [v % ds.n_views for v in range(B)]
    P1 = torch.as_tensor(ds.rig["KRT"][views], dtype=torch.float32, device=device)
    P2 = torch.as_tensor(ds.rig["KRT"][[ds.nearest[v] for v in views]],
                         dtype=torch.float32, device=device)
    return epipolar_sample_locs(P1, P2, Epipolar(cfg).geometry._replace(sample_size=K))


def _counted(*args):
    """The wrapper's forward, and the tiles it put on each path."""
    attn.TILE_COUNTS.clear()
    got = attn.epipolar_attention_batch(*args)
    return got, attn.tile_counts()


@pytest.mark.parametrize("C", [32, 64, 128, 256])
@pytest.mark.parametrize("K", [1, 33, 128])
@pytest.mark.parametrize("dt,name,kw,use_prior", CASES, ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_forward_tile_path_matches_plain(device, C, K, dt, name, kw, use_prior):
    """The rig's 64x64 lines: the tile path, held to the plain version."""
    dtype = torch.float32 if dt == "f32" else torch.bfloat16
    feats, _, _ = _inputs(device, 2, 64, 64, 1, C, dtype)
    locs = _rig_locs(device, 2, K)
    prior = torch.rand(locs.shape[:-1], device=device,
                       generator=torch.Generator(device).manual_seed(3)) * 0.1
    params = AttentionParams(softmax_scale=K ** -0.5, **kw)
    prior = prior if use_prior else None
    got, (tile, per_query) = _counted(*feats, locs, params, prior)
    assert tile + per_query == 2 * 64 * 64 // attn.TILE_QUERIES
    if K > 1:  # K = 1 has no line to group by
        assert tile > per_query
    want = attn.epipolar_attention_plain_batch(*feats, locs, params, prior)
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else dict(rtol=5e-2, atol=5e-2)
    torch.testing.assert_close(got[0].float(), want[0].float(), **tol)
    torch.testing.assert_close(got[2], want[2], **tol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_forward_random_locs_take_the_per_query_path(device, dt):
    """Random locations have no line structure (their samples do not lie on
    lines, and a tile's union would be far above the limit), so every tile
    goes to the per-query kernel, in query order."""
    dtype = torch.float32 if dt == "f32" else torch.bfloat16
    feats, locs, _ = _inputs(device, 2, 64, 64, 64, 256, dtype)
    params = AttentionParams(softmax_scale=0.125)
    got, counts = _counted(*feats, locs, params)
    assert counts == (0, 2 * 64 * 64 // attn.TILE_QUERIES)
    want = attn.epipolar_attention_plain_batch(*feats, locs, params)
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else dict(rtol=5e-2, atol=5e-2)
    torch.testing.assert_close(got[0].float(), want[0].float(), **tol)
    torch.testing.assert_close(got[2], want[2], **tol)


def test_forward_counts_match_the_plain_plan(device):
    """The kernel's tiles on each path at the rig, against the plain twin's
    grouping and unions (a bin may move by an atan2 ulp, so within 2)."""
    feats, _, _ = _inputs(device, 8, 64, 64, 1, 64, torch.float32)
    locs = _rig_locs(device, 8, 64)
    _, (tile, per_query) = _counted(*feats, locs, AttentionParams(softmax_scale=0.125))
    flat = locs.reshape(8, 64, 64 * 64, 2)
    assert attn._items_on_lines(flat, 64, 64).all()
    _, union = attn._tile_plan(flat, 64, 64)
    want = int((union.sum(-1) <= attn.MAX_UNION).sum())
    assert abs(tile - want) <= 2 and tile + per_query == union.shape[0] * union.shape[1]
    assert tile == 8 * 64 * 64 // attn.TILE_QUERIES


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_forward_two_runs_bit_equal(device, dt):
    dtype = torch.float32 if dt == "f32" else torch.bfloat16
    feats, _, _ = _inputs(device, 8, 64, 64, 1, 256, dtype)
    locs = _rig_locs(device, 8, 64)
    params = AttentionParams(softmax_scale=0.125)
    first = attn.epipolar_attention_batch(*feats, locs, params)
    second = attn.epipolar_attention_batch(*feats, locs, params)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_forward_keys_values_distinct_storage(device):
    """Keys and values in separate tensors: the tile kernel stages each."""
    feats, _, _ = _inputs(device, 2, 64, 64, 1, 128, torch.float32)
    locs = _rig_locs(device, 2, 64)
    params = AttentionParams(softmax_scale=0.125)
    assert feats[1].data_ptr() != feats[2].data_ptr()
    got, (tile, _) = _counted(*feats, locs, params)
    assert tile > 0
    want = attn.epipolar_attention_plain_batch(*feats, locs, params)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=1e-5)
    same = attn.epipolar_attention_batch(feats[0], feats[1], feats[1], locs, params)
    want = attn.epipolar_attention_plain_batch(feats[0], feats[1], feats[1], locs, params)
    torch.testing.assert_close(same[0], want[0], rtol=1e-4, atol=1e-5)


def test_forward_tile_constants_match_the_plain_twin(device):
    from epipolar_transformers_tpu_torch.ops._build import load_library

    lib = load_library("epipolar_attention")
    assert lib.epipolar_attention_tile_queries() == attn.TILE_QUERIES
    assert lib.epipolar_attention_max_union() == attn.MAX_UNION


def test_all_out_of_range_is_exactly_zero(device):
    feats, locs, _ = _inputs(device, 2, 8, 8, 16, 64, torch.float32)
    out, _, depth = attn.epipolar_attention_batch(
        *feats, torch.full_like(locs, -9.0), AttentionParams(softmax_scale=0.25))
    assert out.abs().max().item() == 0.0
    torch.testing.assert_close(depth, torch.full_like(depth, 1 / 16))


def test_wrapper_checks(device):
    feats, locs, _ = _inputs(device, 1, 8, 8, 4, 48, torch.float32)
    params = AttentionParams(softmax_scale=0.5)
    with pytest.raises(ValueError, match="widths"):
        attn.epipolar_attention_batch(*feats, locs, params)
    feats, locs, _ = _inputs(device, 1, 8, 8, 4, 64, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        attn.epipolar_attention_batch(feats[0].transpose(1, 2), *feats[1:], locs, params)
    _, locs, _ = _inputs(device, 1, 8, 8, 129, 64, torch.float32)
    with pytest.raises(ValueError, match="samples"):
        attn.epipolar_attention_batch(*feats, locs, params)


def _grads(fn, feats, locs, params, prior, need_kv=True, seed=1):
    """Gradients of sum(out * r) for a fixed random r with respect to the
    query features and (need_kv) the key and value features."""
    leaves = [t.detach().clone().requires_grad_(i == 0 or need_kv)
              for i, t in enumerate(feats)]
    out, _, _ = fn(*leaves, locs, params, prior)
    g = torch.Generator(device=out.device).manual_seed(seed)
    r = torch.randn(out.shape, device=out.device, generator=g)
    (out.float() * r).sum().backward()
    return [t.grad for t in leaves]


def _assert_grads_close(got, want, dtype):
    scale = 1e-5 if dtype == torch.float32 else 5e-2
    rtol = 1e-4 if dtype == torch.float32 else 5e-2
    for name, a, b in zip(("dfeat1", "dother1", "dother2"), got, want):
        if b is None:
            # the plain version never reads the queries under similarity
            # 'prior', so autograd gives None where the kernel gives zeros
            assert a is None or a.abs().max().item() == 0.0, name
            continue
        atol = scale * max(float(b.float().abs().max()), 1e-30)
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=atol, msg=name)


@pytest.mark.parametrize("C", [32, 64, 128, 256])
@pytest.mark.parametrize("K", [1, 17, 128])
@pytest.mark.parametrize("dt,name,kw,use_prior", CASES, ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_backward_matches_plain_autograd(device, C, K, dt, name, kw, use_prior):
    dtype = torch.float32 if dt == "f32" else torch.bfloat16
    feats, locs, prior = _inputs(device, 2, 12, 10, K, C, dtype)
    params = AttentionParams(softmax_scale=K ** -0.5, **kw)
    prior = prior if use_prior else None
    before = attn.BACKWARD_LAUNCHES
    got = _grads(attn.epipolar_attention_batch, feats, locs, params, prior)
    assert attn.BACKWARD_LAUNCHES == before + 1
    want = _grads(attn.epipolar_attention_plain_batch, feats, locs, params, prior)
    _assert_grads_close(got, want, dtype)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_backward_detached_keys_values(device, dt):
    """OTHER_GRAD=(): only the query gradient is asked for and computed."""
    dtype = torch.float32 if dt == "f32" else torch.bfloat16
    feats, locs, _ = _inputs(device, 2, 16, 16, 64, 256, dtype)
    params = AttentionParams(softmax_scale=0.125)
    got = _grads(attn.epipolar_attention_batch, feats, locs, params, None, need_kv=False)
    want = _grads(attn.epipolar_attention_plain_batch, feats, locs, params, None, need_kv=False)
    assert got[1] is None and got[2] is None
    _assert_grads_close(got, want, dtype)


def test_backward_all_out_of_range_is_exactly_zero(device):
    feats, locs, _ = _inputs(device, 2, 8, 8, 16, 64, torch.float32)
    grads = _grads(attn.epipolar_attention_batch, feats, torch.full_like(locs, -9.0),
                   AttentionParams(softmax_scale=0.25), None)
    for g in grads:
        assert g.abs().max().item() == 0.0


PRIOR_MODES = [
    ("additive", dict()),
    ("additive_softmax_off", dict(softmax_enabled=False)),
    ("priormul", dict(priormul=True)),
    ("priormul_softmax_off", dict(priormul=True, softmax_enabled=False)),
    ("prior_similarity", dict(similarity="prior")),
]
PRIOR_CASES = [(dt, *m) for dt in ("f32", "bf16") for m in PRIOR_MODES
               if not (dt == "bf16" and "softmax_off" in m[0])]


@pytest.mark.parametrize("dt,name,kw", PRIOR_CASES, ids=[f"{c[0]}-{c[1]}" for c in PRIOR_CASES])
def test_backward_prior_gradient(device, dt, name, kw):
    """The learned prior's gradient from the kernel backward == autograd of
    the plain version in each mode; a query with every sample out of range
    gets exactly 0 (the masked softmax's constant row; g = 0 elsewhere);
    two runs are bit-equal."""
    dtype = torch.float32 if dt == "f32" else torch.bfloat16
    feats, locs, prior = _inputs(device, 2, 12, 10, 33, 64, dtype)
    locs[0, :, 0, 3] = -9.0
    params = AttentionParams(softmax_scale=33 ** -0.5, **kw)

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_() for t in (*feats, prior)]
        out = fn(*leaves[:3], locs, params, leaves[3])[0]
        r = torch.randn(out.shape, device=device,
                        generator=torch.Generator(device=device).manual_seed(1))
        (out.float() * r).sum().backward()
        return [t.grad for t in leaves]

    before = attn.BACKWARD_LAUNCHES
    got = grads(attn.epipolar_attention_batch)
    assert attn.BACKWARD_LAUNCHES == before + 1
    want = grads(attn.epipolar_attention_plain_batch)
    _assert_grads_close(got[:3], want[:3], dtype)
    # priormul without the softmax never reads the prior: autograd gives
    # None where the kernel gives zeros
    want_prior = torch.zeros_like(got[3]) if want[3] is None else want[3]
    scale, rtol = (1e-5, 1e-4) if dtype == torch.float32 else (5e-2, 5e-2)
    atol = scale * max(float(want_prior.abs().max()), 1e-30)
    torch.testing.assert_close(got[3], want_prior, rtol=rtol, atol=atol, msg="dprior")
    assert got[3][0, :, 0, 3].abs().max().item() == 0.0
    assert all(torch.equal(a, b) for a, b in zip(got, grads(attn.epipolar_attention_batch))
               if a is not None)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_backward_keys_values_one_tensor(device, dt):
    """OTHER_GRAD as the model runs it: keys and values one tensor, whose
    gradient the kernels return summed once; two runs are bit-equal."""
    dtype = torch.float32 if dt == "f32" else torch.bfloat16
    feats, locs, _ = _inputs(device, 2, 16, 16, 64, 256, dtype)
    params = AttentionParams(softmax_scale=0.125)

    def grads(fn):
        f1 = feats[0].clone().requires_grad_()
        f2 = feats[1].clone().requires_grad_()
        out = fn(f1, f2, f2, locs, params)[0]
        r = torch.randn(out.shape, device=device, generator=torch.Generator(device).manual_seed(1))
        return torch.autograd.grad((out.float() * r).sum(), (f1, f2))

    got = grads(attn.epipolar_attention_batch)
    again = grads(attn.epipolar_attention_batch)
    want = grads(attn.epipolar_attention_plain_batch)
    _assert_grads_close(got, want, dtype)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("which", ["keys", "values"])
def test_backward_one_of_keys_values(device, which):
    """Only the keys or only the values need a gradient."""
    feats, locs, _ = _inputs(device, 2, 12, 10, 33, 128, torch.float32)
    params = AttentionParams(softmax_scale=33 ** -0.5)

    def grads(fn):
        leaves = [t.clone().requires_grad_(i == 0 or (i == 1) == (which == "keys"))
                  for i, t in enumerate(feats)]
        out = fn(*leaves, locs, params)[0]
        r = torch.randn(out.shape, device=device, generator=torch.Generator(device).manual_seed(1))
        (out * r).sum().backward()
        return [t.grad for t in leaves]

    got, want = grads(attn.epipolar_attention_batch), grads(attn.epipolar_attention_plain_batch)
    assert (got[1] is None) == (which == "values") and (got[2] is None) == (which == "keys")
    _assert_grads_close(got, want, torch.float32)


def _hourglass_inputs(device, dtype, B=16):
    """The epipolarHG1 recipe's attention (configs/epipolar/synthetic_hg.yaml:
    16x16 maps, K=16, C=128): channels_last (B, C, H, W) activations viewed
    as NHWC, as the hourglass hands them over, at the rig's locations."""
    from epipolar_transformers_tpu_torch.config import load_config
    from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
    from epipolar_transformers_tpu_torch.models.epipolar import Epipolar
    from epipolar_transformers_tpu_torch.ops.epipolar_sampling import epipolar_sample_locs

    cfg = load_config("configs/epipolar/synthetic_hg.yaml")
    g = torch.Generator(device=device).manual_seed(4)
    feats = [torch.randn(B, 128, 16, 16, device=device, generator=g).to(dtype)
             .contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
             for _ in range(2)]
    ds = SyntheticMultiview(cfg, is_train=False, n_samples=1)
    views = [v % ds.n_views for v in range(B)]
    P1 = torch.as_tensor(ds.rig["KRT"][views], dtype=torch.float32, device=device)
    P2 = torch.as_tensor(ds.rig["KRT"][[ds.nearest[v] for v in views]],
                         dtype=torch.float32, device=device)
    locs = epipolar_sample_locs(P1, P2, Epipolar(cfg).geometry)
    return feats, locs, AttentionParams(softmax_scale=cfg.EPIPOLAR.SOFTMAXSCALE)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_hourglass_shape_forward_matches_plain(device, dt):
    """B=16, 16x16, K=16, C=128: every tile counted once on one of the two
    paths, the output held to the plain version, two runs bit-equal."""
    dtype = torch.float32 if dt == "f32" else torch.bfloat16
    (f1, f2), locs, params = _hourglass_inputs(device, dtype)
    assert f1.is_contiguous() and f1.data_ptr() % 16 == 0
    got, (tile, per_query) = _counted(f1, f2, f2, locs, params)
    assert tile + per_query == 16 * -(-16 * 16 // attn.TILE_QUERIES)
    want = attn.epipolar_attention_plain_batch(f1, f2, f2, locs, params)
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else dict(rtol=5e-2, atol=5e-2)
    torch.testing.assert_close(got[0].float(), want[0].float(), **tol)
    torch.testing.assert_close(got[2], want[2], **tol)
    again = attn.epipolar_attention_batch(f1, f2, f2, locs, params)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_hourglass_shape_backward_matches_plain(device, dt):
    """The backward at the hourglass's shape (a 256-row key set), keys =
    values one tensor as the model has them; two runs bit-equal."""
    dtype = torch.float32 if dt == "f32" else torch.bfloat16
    (f1, f2), locs, params = _hourglass_inputs(device, dtype)

    def grads(fn):
        q = f1.detach().clone().requires_grad_()
        kv = f2.detach().clone().requires_grad_()
        out = fn(q, kv, kv, locs, params)[0]
        r = torch.randn(out.shape, device=device, generator=torch.Generator(device).manual_seed(1))
        return torch.autograd.grad((out.float() * r).sum(), (q, kv))

    before = attn.BACKWARD_LAUNCHES
    got = grads(attn.epipolar_attention_batch)
    assert attn.BACKWARD_LAUNCHES == before + 1
    again = grads(attn.epipolar_attention_batch)
    _assert_grads_close(got, grads(attn.epipolar_attention_plain_batch), dtype)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _backward_counted(fn, *args, **kw):
    """`fn`'s result and the backward tiles it put on each path."""
    attn.BACKWARD_TILE_COUNTS.clear()
    got = fn(*args, **kw)
    return got, attn.backward_tile_counts()


@pytest.mark.parametrize("C", [32, 64, 128, 256])
@pytest.mark.parametrize("K", [1, 33, 128])
@pytest.mark.parametrize("dt,name,kw,use_prior", CASES, ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_backward_tile_path_matches_plain(device, C, K, dt, name, kw, use_prior):
    """The rig's 64x64 lines: the backward's tile path, keys and values
    apart, held to autograd of the plain version."""
    dtype = torch.float32 if dt == "f32" else torch.bfloat16
    feats, _, _ = _inputs(device, 2, 64, 64, 1, C, dtype)
    locs = _rig_locs(device, 2, K)
    prior = torch.rand(locs.shape[:-1], device=device,
                       generator=torch.Generator(device).manual_seed(3)) * 0.1
    params = AttentionParams(softmax_scale=K ** -0.5, **kw)
    prior = prior if use_prior else None
    got, (tile, per_query) = _backward_counted(_grads, attn.epipolar_attention_batch, feats,
                                               locs, params, prior)
    assert tile + per_query == 2 * 64 * 64 // attn.TILE_QUERIES
    if K > 1:
        assert tile > per_query
    want = _grads(attn.epipolar_attention_plain_batch, feats, locs, params, prior)
    _assert_grads_close(got, want, dtype)


def _flat_inputs(device, dtype, B=8, C=256, K=64, seed=5):
    """(B, HW, C) queries and keys = values one tensor, the rig's (B, K, HW,
    2) locations and a cotangent, as `_kernel_backward` takes them."""
    feats, _, _ = _inputs(device, B, 64, 64, 1, C, dtype, seed=seed)
    locs = _rig_locs(device, B, K).reshape(B, K, 64 * 64, 2)
    f1, f2 = (f.reshape(B, 64 * 64, C) for f in feats[:2])
    dout = torch.randn(B, 64 * 64, C, device=device,
                       generator=torch.Generator(device).manual_seed(seed + 1))
    return f1, f2, locs, dout


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_backward_small_cap_runs_both_paths(device, dt):
    """A union cap at the rig's median puts about half of the tiles on each
    of the backward's paths in one launch; every gradient stays held to
    the plain version's, and to the launch with the full cap."""
    dtype = torch.float32 if dt == "f32" else torch.bfloat16
    f1, f2, locs, dout = _flat_inputs(device, dtype, B=4)
    params = AttentionParams(softmax_scale=0.125)
    _, union = attn._tile_plan(locs, 64, 64)
    cap = int(union.sum(-1).median())
    args = (f1, f2, f2, locs, None, dout, 64, 64, params)
    kv = dict(need_keys=True, need_values=True, same_kv=True)
    small, (tile, per_query) = _backward_counted(attn._kernel_backward, *args, **kv,
                                                 max_union=cap)
    assert tile > 0 and per_query > 0 and tile + per_query == 4 * 64
    full, (tile, per_query) = _backward_counted(attn._kernel_backward, *args, **kv)
    assert per_query == 0
    B, HW, C = f1.shape
    want = attn.epipolar_attention_backward_plain(
        *(t.reshape(B, 64, 64, C) for t in (f1, f2, f2)), locs.reshape(B, -1, 64, 64, 2),
        params, dout.reshape(B, 64, 64, C))
    want = [want[0].reshape(B, HW, C), (want[1] + want[2]).reshape(B, HW, C), None]
    _assert_grads_close(small[:3], want, dtype)
    _assert_grads_close(full[:3], want, dtype)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_backward_tile_path_two_runs_bit_equal(device, dt):
    """The flagship shape at the rig: every tile on the tile path, two
    runs bit-equal, also with a cap that splits the paths."""
    dtype = torch.float32 if dt == "f32" else torch.bfloat16
    f1, f2, locs, dout = _flat_inputs(device, dtype)
    args = (f1, f2, f2, locs, None, dout, 64, 64, AttentionParams(softmax_scale=0.125))
    kv = dict(need_keys=True, need_values=True, same_kv=True)
    first, counts = _backward_counted(attn._kernel_backward, *args, **kv)
    assert counts == (8 * 64, 0)
    second = attn._kernel_backward(*args, **kv)
    assert all(torch.equal(a, b) for a, b in zip(first[:2], second[:2]))
    first = attn._kernel_backward(*args, **kv, max_union=190)
    second = attn._kernel_backward(*args, **kv, max_union=190)
    assert all(torch.equal(a, b) for a, b in zip(first[:2], second[:2]))


def test_backward_counts_match_the_plain_plan(device):
    """The backward's tiles on each path at the rig, against the plain
    twin's grouping and unions (a bin may move by an atan2 ulp, so within
    2), with the full and a lowered cap."""
    f1, f2, locs, dout = _flat_inputs(device, torch.float32, C=64)
    args = (f1, f2, f2, locs, None, dout, 64, 64, AttentionParams(softmax_scale=0.125))
    _, union = attn._tile_plan(locs, 64, 64)
    sizes = union.sum(-1)
    for cap in (attn.BACKWARD_MAX_UNION, int(sizes.median())):
        _, (tile, per_query) = _backward_counted(
            attn._kernel_backward, *args, need_keys=False, need_values=False, same_kv=True,
            max_union=cap)
        assert abs(tile - int((sizes <= cap).sum())) <= 2 and tile + per_query == sizes.numel()


def test_backward_tile_constants_match_the_plain_twin(device):
    from epipolar_transformers_tpu_torch.ops._build import load_library

    lib = load_library("epipolar_attention")
    assert lib.epipolar_attention_backward_max_union() == attn.BACKWARD_MAX_UNION
    assert lib.epipolar_attention_tile_shape(8, 64, 64) == 1
