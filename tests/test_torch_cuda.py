"""The CUDA epipolar-attention kernel == its plain PyTorch version, on the card.

Marked `cuda`: each test skips where torch sees no GPU.  On the card (which
has no JAX, so the suite's conftest is skipped):

    python -m pytest --noconftest tests/test_torch_cuda.py

Covers what chip_smoke.py does not: every channel width the kernel takes,
sample counts that are not a multiple of the warp (1, 33, 128), and the
wrapper's checks.  Tolerance f32 rtol 1e-4 / atol 1e-5 (summation order
only, TF32 off); bf16 rtol = atol = 5e-2 (the plain version rounds the Gram
and weight matrices to bf16).
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
