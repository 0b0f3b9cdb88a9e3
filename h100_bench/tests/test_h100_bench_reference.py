"""The benchmark's plain reference against the port's plain path on the
CPU, on shared weights: the forward, the loss, the gradient and adam's
step at the port's tiny flagship (R-18, 32 px, 8x8 heatmaps, 5 joints,
K=4, float32), and the sample locations, the decode and pymvg alone.
The test imports the port; the reference does not."""

import numpy as np
import pytest
import torch

from epipolar_transformers_tpu_torch.config import flagship_cfg
from epipolar_transformers_tpu_torch.engine.solver import make_optimizer
from epipolar_transformers_tpu_torch.engine.trainer import make_train_step
from epipolar_transformers_tpu_torch.geometry.host import triangulate_pymvg_np
from epipolar_transformers_tpu_torch.models import ModelBuilder
from epipolar_transformers_tpu_torch.ops.epipolar_sampling import (EpipolarGeometry,
                                                                   epipolar_sample_locs)
from epipolar_transformers_tpu_torch.ops.soft_argmax import find_tensor_peak_batch
import h100_bench.tests.bench_tiny  # noqa: F401  (two torch threads)
from h100_bench.harness import compare, inputs, spec, weights
from h100_bench.reference import geometry as refgeo
from h100_bench.reference import model as refmodel

RIG = {"geometry_seed": 5, "rig": {"views": 4, "radius_mm": 4000.0, "target_mm": [0.0, 0.0, 1000.0],
               "focal_px": 128.0, "height_mm": 1200.0, "height_step_mm": 100.0, "angle0": 0.3},
       "skeleton": {"centre_mm": [0.0, 0.0, 1000.0], "jitter_mm": [80.0, 80.0, 80.0],
                    "extent_mm": [200.0, 200.0, 200.0]}}
RECIPE = {"DATASETS": {"IMAGE_SIZE": [32, 32]}, "BACKBONE": {"DOWNSAMPLE": 4},
          "KEYPOINT": {"HEATMAP_SIZE": [8, 8], "SIGMA": 2.0, "NUM_PTS": 5}}


@pytest.fixture
def shared():
    cfg = flagship_cfg(tiny=True)
    state = weights.make_state(refmodel.state_shapes(18, 5), 3, "cpu")
    with torch.device("cpu"):
        port = ModelBuilder(cfg)
    missing, unexpected = port.load_state_dict({"reference." + k: v.clone()
                                                for k, v in state.items()}, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    rig = inputs.Rig(RIG, RECIPE, 5, "cpu")
    batches = inputs.train_batches(rig, 4, 3)
    return cfg, state, port, batches


def test_train_steps_match_the_port(shared):
    cfg, state, port, batches = shared
    port.train()
    optimizer = make_optimizer(cfg, port, 1000)
    step = make_train_step(cfg, port, optimizer)
    program = compare.TrainReading()
    names = {id(p): n[len("reference."):] for n, p in port.named_parameters()}
    heads = []
    hook = port.reference.final_layer.register_forward_hook(
        lambda module, args, output: heads.append(output.detach()))
    for i in range(3):
        program.losses.append(float(step(batches[i])["loss"]))
        if i == 0:
            hook.remove()
            program.heatmaps1 = heads[0]
            program.grad_norms = {names[id(p)]: float(s["exp_avg"].norm()) / 0.1
                                  for p, s in optimizer.inner.state.items()}
    now = port.state_dict()
    program.change_norms = {n: float((now["reference." + n] - v).norm())
                            for n, v in state.items()}
    ref = compare.reference_steps(_cell(), state, batches, "cpu", "float32", 1e-3)
    gaps = compare.train_numbers(program, ref)
    # float32 on both sides.  The first loss agrees to rounding; a few of
    # the port's float32 sample locations sit across a clipping edge from
    # the reference's float64 ones, which moves the gradient of the leaves
    # behind the attention by a few 1e-3; adam then turns near-zero
    # gradients into steps of +-lr, whose signs rounding decides, so the
    # later losses and the change move by a few %
    assert abs(program.losses[0] - ref.losses[0]) / ref.losses[0] < 1e-5
    assert gaps["heatmap1_gap"] < 1e-4, gaps
    assert gaps["grad_gap"] < 1e-2, gaps
    assert gaps["loss_gap"] < 5e-2 and gaps["change_gap"] < 0.1, gaps


def test_eval_heatmaps_match_the_port(shared):
    cfg, state, port, batches = shared
    port.eval()
    b = batches[0]
    ref = refmodel.build(18, 5, "float32", state, "cpu").eval()
    with torch.no_grad():
        got = port({k: b[k] for k in ("img", "other_img", "KRT", "other_KRT")})["heatmap_pred"]
        locs = refgeo.sample_locations(b["KRT"], b["other_KRT"], (8, 8), 4, 4)
        want = ref(b["img"], b["other_img"], locs)
    assert float((got - want).norm() / want.norm()) < 1e-5


def test_sample_locations_match_the_port(shared):
    _, _, _, batches = shared
    b = batches[1]
    geom = EpipolarGeometry(feat_h=8, feat_w=8, sample_size=4, downsample=4, resize=1.0,
                            correct_normalize=True)
    got = epipolar_sample_locs(b["KRT"], b["other_KRT"], geom)
    want = refgeo.sample_locations(b["KRT"], b["other_KRT"], (8, 8), 4, 4)
    # the port works in float32, the reference in float64
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_decode_matches_the_port():
    g = torch.Generator().manual_seed(1)
    hm = torch.rand(3, 5, 16, 16, generator=g, dtype=torch.float64)
    hm[0, 0] = 0.0
    hm[1, 2, 0, 15] = 5.0  # a peak on the border
    got_xy, got_s = find_tensor_peak_batch(hm, 2.0, 4)
    want_xy, want_s = refgeo.decode_peaks(hm.numpy(), 2.0, 4)
    np.testing.assert_allclose(got_xy.numpy(), want_xy, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(got_s.numpy(), want_s)


def test_pymvg_matches_the_port():
    rng = np.random.default_rng(2)
    rig = inputs.make_camera_ring(4, 4000.0, [0.0, 0.0, 1000.0], 1024.0, (256, 256), 1200.0,
                                  100.0, 0.3)
    pts = rng.uniform(0, 256, (4, 17, 2))
    scores = rng.uniform(-1.5, 1.0, (4, 17))
    scores[:, 3] = -2.0  # no view passes: determined by no threshold
    got = triangulate_pymvg_np(pts, rig["K"], rig["RT"], scores)
    want = refgeo.triangulate_pymvg(pts, rig["K"], rig["RT"], scores)
    determined = np.isfinite(want).all(-1)
    assert not determined[3] and determined.sum() >= 15
    # eigh of the normal matrix against the SVD: the squared conditioning of
    # inconsistent rays costs a few digits
    np.testing.assert_allclose(got[determined], want[determined], rtol=1e-7, atol=1e-4)


def _cell():
    """A stand-in cell of the tiny flagship's sizes."""

    class Tiny:
        sizes = spec.Sizes(depth=18, joints=5, samples=4, image_hw=(32, 32), heatmap_hw=(8, 8),
                           stride=4, channels=256, sigma=2.0)

    return Tiny()


def test_the_attention_item_by_item_is_the_same(monkeypatch):
    """A batch whose samples pass SAMPLE_ELEMENTS attends item by item (each
    recomputed in the backward): the same output and gradients."""
    fusion = refmodel.EpipolarFusion(8, "float32")
    g = torch.Generator().manual_seed(0)
    feat = torch.randn(5, 8, 6, 6, generator=g, requires_grad=True)
    other = torch.randn(5, 8, 6, 6, generator=g, requires_grad=True)
    locs = torch.rand(5, 4, 6, 6, 2, generator=g) * 2.2 - 1.1
    seen = []
    for elements in (refmodel.SAMPLE_ELEMENTS, 8 * 4 * 36):  # whole; item by item
        monkeypatch.setattr(refmodel, "SAMPLE_ELEMENTS", elements)
        out = fusion.attend(feat, other, locs)
        grads = torch.autograd.grad((out * out).sum(), (feat, other))
        seen.append((out.detach(), *grads))
    for a, b in zip(*seen):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_the_train_batchnorm_gradient_is_autograds():
    """The reference's training BN (its own backward, which saves the input
    alone) against autograd of the same expression, in float64."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4, 3, 5, 5, generator=g, dtype=torch.float64, requires_grad=True)
    w = torch.randn(3, generator=g, dtype=torch.float64, requires_grad=True)
    b = torch.randn(3, generator=g, dtype=torch.float64, requires_grad=True)
    up = torch.randn(4, 3, 5, 5, generator=g, dtype=torch.float64)
    y, mean, var = refmodel._TrainBN.apply(x, w, b, 1e-5)
    got = torch.autograd.grad((y * up).sum(), (x, w, b))
    v, m = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    plain = (x - m[:, None, None]) * (torch.rsqrt(v + 1e-5) * w)[:, None, None] + b[:, None, None]
    want = torch.autograd.grad((plain * up).sum(), (x, w, b))
    torch.testing.assert_close(y, plain, rtol=0, atol=0)
    torch.testing.assert_close((mean, var), (m, v), rtol=0, atol=0)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=1e-10, atol=1e-12)
