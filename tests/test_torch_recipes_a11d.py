"""The fifteen recipes that no card run had used until chip_smoke.py's [15],
each through the port's command line on the CPU, cut to a smoke run: a
64 px image (16x16 heatmaps), batch 2, no loader workers, one step and one
eval group; everything else as the YAML writes it (the backbone, K, TOPK,
MAPPING, DATA_FORMAT, the triangulation, the optimizer).  The H36M recipes
read a fake tree that chip_smoke.write_fake_h36m writes, the RHD ones a
fake RHD tree, and the three that name
`datasets/pose_resnet_4.5_pixels_human36m.pth` a seeded pose-ResNet file in
the reference layout (chip_smoke.write_pose_resnet, at depth 152, the
recipes' own).  Eight run to their end with finite metrics.

Seven cannot run to their end in either package, and are pinned here as
they fail.  configs/lifting/img_lifting_rot_h36m.yaml: the H36M items carry
no `can-points-3d` or `rotation`, the targets of its task; the port raises
KeyError at its first step, the JAX package's loss a TypeError on the
missing target (ROADMAP C17).  configs/lifting/lifting_direct_h36m.yaml:
its H36M items carry no image (a lifting task reads none), and both train
loops take a batch without `img` for a DATALOADER.DEVICE_RENDER one and
look for the coordinates to render from: KeyError 'other_points-2d'
(ROADMAP C19).  The five recipes on the 20-joint union
(DATASETS.H36M.MAPPING, the default) train, then their eval triangulates
the 20 union joints against the 17 joints of `points-3d`: NumPy's
broadcast ValueError in the MPJPE under naive and pymvg, an IndexError in
RPSM's unary term, which samples 20 heatmaps through the 17-joint body's
grids; the JAX tester computes the same and fails the same (ROADMAP C18).
"""

import math
import os
import re
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_configs import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

H36M_RECIPES = (
    "configs/epipolar/keypoint_h36m_resnet152_384_pretrained_8gpu.yaml",
    "configs/epipolar/keypoint_h36m_resnet152_384_aug.yaml",
    "configs/epipolar/keypoint_h36m_zresidual_aug.yaml",
    "configs/epipolar/keypoint_h36m_zresidual_fixed.yaml",
    "configs/benchmark/keypoint_h36m_resnet152_384.yaml",
)
RHD_RECIPES = ("configs/lifting/lifting.yaml", "configs/lifting/lifting_sgd.yaml",
               "configs/lifting/lifting_rot_sgd.yaml")
# the union-joint recipes and the error their eval raises in both packages
UNION_RECIPES = {
    "configs/epipolar/keypoint_h36m_resnet152_384_strong.yaml": IndexError,
    "configs/epipolar/keypoint_h36m_resnet152_384.yaml": ValueError,
    "configs/epipolar/keypoint_h36m_resnet152_320.yaml": ValueError,
    "configs/epipolar/keypoint_h36m.yaml": ValueError,
    "configs/benchmark/keypoint_h36m.yaml": ValueError,
}
CUT = ["--device", "cpu", "--max-steps", "1", "--max-eval-batches", "1",
       "SOLVER.IMS_PER_BATCH", "2", "DATALOADER.NUM_WORKERS", "0", "LOG_FREQ", "1"]
H36M_CUT = ["DATASETS.IMAGE_SIZE", "(64, 64)", "KEYPOINT.HEATMAP_SIZE", "(16, 16)"]
RHD_CUT = ["TEST.IMS_PER_BATCH", "2", "LIFTING.CROP_SIZE", "64"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A fake H36M tree of 64 px frames (10 train groups: TRAIN_SAMPLE 5
    keeps 2, a batch; 1 validation group), a fake RHD tree and the seeded
    pose-ResNet-152 file, under <tmp>/datasets (the recipes' relative
    paths)."""
    from chip_smoke import write_fake_h36m, write_fake_rhd, write_pose_resnet

    root = tmp_path_factory.mktemp("a11d")
    write_fake_h36m(str(root / "datasets"), train_groups=10, val_groups=1, image_size=64)
    write_fake_rhd(str(root / "datasets"), n_items=4, size=64)
    write_pose_resnet(str(root / "datasets/pose_resnet_4.5_pixels_human36m.pth"), 152)
    return root


def _run(recipe, tree, monkeypatch, extra=()):
    from epipolar_transformers_tpu_torch.main import main

    monkeypatch.chdir(tree)
    out = str(tree / ("out_" + os.path.basename(recipe)))
    return main(["--cfg", os.path.join(REPO, recipe), *CUT, *extra, "OUTPUT_DIR", out])


def _ids(recipes):
    return [r[len("configs/"):-len(".yaml")].replace("/", "-") for r in recipes]


@pytest.mark.parametrize("recipe", H36M_RECIPES + RHD_RECIPES, ids=_ids(H36M_RECIPES + RHD_RECIPES))
def test_recipe_trains_and_tests(recipe, tree, monkeypatch):
    results = _run(recipe, tree, monkeypatch, H36M_CUT if recipe in H36M_RECIPES else RHD_CUT)
    if "lifting" in recipe:
        assert {"EPEmean_can", "loss"} <= set(results)
    else:
        assert {"EPEmean_global", "JDR"} <= set(results)
    assert all(math.isfinite(v) for v in results.values()), results


def test_pretrained_file_lands_in_the_trunk_and_head(tree):
    """The pose-ResNet file's trunk and deconv head (not its final layer)
    are imported into the 19 mm recipe's model, bit-equal."""
    import torch

    from epipolar_transformers_tpu_torch.config import load_config
    from epipolar_transformers_tpu_torch.engine.trainer import build_model, load_weights

    path = str(tree / "datasets/pose_resnet_4.5_pixels_human36m.pth")
    cfg = load_config(os.path.join(REPO, H36M_RECIPES[0]),
                      ["BACKBONE.PRETRAINED_WEIGHTS", path, "OUTPUT_DIR", ""])
    model = build_model(cfg, torch.device("cpu"))
    final = model.reference.final_layer.weight.detach().clone()
    load_weights(cfg, model)
    sd = torch.load(path)
    ref = model.reference
    assert torch.equal(ref.conv1.weight, sd["module.conv1.weight"])
    assert torch.equal(ref.layer4[2].bn3.weight, sd["module.layer4.2.bn3.weight"])
    assert float(sd["module.layer4.2.bn3.weight"].abs().max()) < 0.1  # starts near 0
    assert torch.equal(ref.deconv_layers[0].weight, sd["module.deconv_layers.0.weight"])
    assert torch.equal(ref.final_layer.weight, final)  # the file's final layer is left out


def test_img_lifting_rot_h36m_fails_in_both_packages(tree, monkeypatch):
    """C17: the H36M items carry no `can-points-3d` (nor `rotation`), so the
    img_lifting_rot task's loss has no target: the port raises KeyError at
    its first train step, the JAX package's loss TypeError on None."""
    import jax.numpy as jnp

    from epipolar_transformers_tpu.config import DatasetCatalog as JaxCatalog
    from epipolar_transformers_tpu.config import load_config as jax_load_config
    from epipolar_transformers_tpu.data.pipeline import build_dataset as jax_build_dataset
    from epipolar_transformers_tpu.models import ModelBuilder as JaxModelBuilder
    from epipolar_transformers_tpu_torch.config import load_config
    from epipolar_transformers_tpu_torch.data.pipeline import build_dataset

    recipe = os.path.join(REPO, "configs/lifting/img_lifting_rot_h36m.yaml")
    with pytest.raises(KeyError, match="can-points-3d"):
        _run(recipe, tree, monkeypatch, H36M_CUT)
    cut = ["DATASETS.IMAGE_SIZE", "(64, 64)", "DATASETS.H36M.TRAIN_SAMPLE", "0"]
    item = build_dataset(load_config(recipe, cut), "h36m_train")[0]
    assert "can-points-3d" not in item and "rotation" not in item

    import jax

    jcfg = jax_load_config(recipe, cut + ["BACKBONE.BODY", "R-18"])
    monkeypatch.setattr(JaxCatalog, "DATA_DIR", str(tree / "datasets"))
    jitem = jax_build_dataset(jcfg, "h36m_train")[0]
    assert "can-points-3d" not in jitem and "rotation" not in jitem
    inputs = {k: jnp.asarray(np.asarray(jitem[k])[None]) for k in ("img", "visibility")}
    model = JaxModelBuilder(jcfg)
    with pytest.raises(TypeError):
        model.init(jax.random.PRNGKey(0), inputs, is_train=True)


@pytest.mark.parametrize("recipe", list(UNION_RECIPES), ids=_ids(UNION_RECIPES))
def test_union_recipe_trains_then_its_eval_fails(recipe, tree, monkeypatch, caplog):
    """C18 in the port: one finite train step, then the eval's error."""
    with caplog.at_level("INFO", logger="epipolar_transformers_tpu_torch.engine.trainer"):
        with pytest.raises(UNION_RECIPES[recipe]) as err:
            _run(recipe, tree, monkeypatch, H36M_CUT)
    if UNION_RECIPES[recipe] is ValueError:
        assert "(20,3) (17,3)" in str(err.value)
    losses = [float(v) for v in re.findall(r"\bloss: (\S+)", caplog.text)]
    assert len(losses) == 1 and math.isfinite(losses[0]), caplog.text[-2000:]


def test_union_joints_triangulate_to_20_rows_in_both_packages(tree, monkeypatch):
    """C18 in both packages: a MAPPING validation group holds 20 union
    joints in 2D and 17 in `points-3d`; each tester's triangulation of the
    group's own 2D points gives 20 rows, which the MPJPE cannot subtract
    from 17; RPSM raises IndexError on 20 heatmaps with the 17-joint body."""
    import jax.numpy as jnp

    from epipolar_transformers_tpu.config import DatasetCatalog as JaxCatalog
    from epipolar_transformers_tpu.config import load_config as jax_load_config
    from epipolar_transformers_tpu.data.pipeline import build_dataset as jax_build_dataset
    from epipolar_transformers_tpu.engine import tester as jax_tester
    from epipolar_transformers_tpu.geometry import pictorial as jax_pictorial
    from epipolar_transformers_tpu.geometry.body import HumanBody as JaxBody
    from epipolar_transformers_tpu.geometry.body import compute_limb_length as jax_limbs
    from epipolar_transformers_tpu_torch.config import load_config
    from epipolar_transformers_tpu_torch.data.pipeline import build_dataset
    from epipolar_transformers_tpu_torch.engine import tester
    from epipolar_transformers_tpu_torch.geometry import pictorial
    from epipolar_transformers_tpu_torch.geometry.body import HumanBody, compute_limb_length

    recipe = os.path.join(REPO, "configs/epipolar/keypoint_h36m_resnet152_384.yaml")
    monkeypatch.chdir(tree)
    monkeypatch.setattr(JaxCatalog, "DATA_DIR", str(tree / "datasets"))
    for load, build, triangulate in ((load_config, build_dataset, tester._triangulate),
                                     (jax_load_config, jax_build_dataset,
                                      jax_tester._triangulate)):
        cfg = load(recipe, H36M_CUT)
        group = build(cfg, "multiview_h36m_val")[0]
        assert group["points-2d"].shape[1] == 20 and group["points-3d"].shape[-2] == 17
        pred3d = triangulate(cfg, group, group["points-2d"].astype(np.float64),
                             np.ones(group["points-2d"].shape[:2]), {})
        assert pred3d.shape == (20, 3)
        with pytest.raises(ValueError, match=r"\(20,3\) \(17,3\)"):
            np.linalg.norm(pred3d - group["points-3d"][0], axis=-1)

    rng = np.random.RandomState(0)
    gt = rng.randn(17, 3) * 300 + np.array([0.0, 0.0, 4000.0])
    cams = np.stack([np.concatenate([np.diag([100.0, 100.0, 1.0]),
                                     np.array([[32.0], [32.0], [1.0]])], 1)] * 2)
    heatmaps = rng.rand(2, 20, 16, 16).astype(np.float32)
    boxes = [{"center": np.array([32.0, 32.0]), "scale": np.array([0.32, 0.32])}] * 2
    for rpsm, body, limbs, hm in ((pictorial.rpsm, HumanBody(), compute_limb_length, heatmaps),
                                  (jax_pictorial.rpsm, JaxBody(), jax_limbs,
                                   jnp.asarray(heatmaps))):
        with pytest.raises(IndexError):
            rpsm(cams, hm, center=gt[0], boxes=boxes, body=body,
                 limb_length=limbs(body, gt), img_size=(64, 64), recur_depth=1)


def test_lifting_direct_h36m_fails_in_both_packages(tree, monkeypatch):
    """C19: a lifting task's H36M items carry no image, and both train loops
    take the batch for a DEVICE_RENDER one: KeyError 'other_points-2d'."""
    from epipolar_transformers_tpu.config import DatasetCatalog as JaxCatalog
    from epipolar_transformers_tpu.config import load_config as jax_load_config
    from epipolar_transformers_tpu.data.pipeline import build_dataset as jax_build_dataset
    from epipolar_transformers_tpu.data.pipeline import collate as jax_collate
    from epipolar_transformers_tpu.engine.trainer import materialize_model_inputs

    recipe = os.path.join(REPO, "configs/lifting/lifting_direct_h36m.yaml")
    with pytest.raises(KeyError, match="other_points-2d"):
        _run(recipe, tree, monkeypatch, H36M_CUT)
    monkeypatch.setattr(JaxCatalog, "DATA_DIR", str(tree / "datasets"))
    jcfg = jax_load_config(recipe, H36M_CUT + ["DATASETS.H36M.TRAIN_SAMPLE", "0"])
    batch = jax_collate([jax_build_dataset(jcfg, "h36m_train")[0]])
    assert "img" not in batch
    with pytest.raises(KeyError, match="other_points-2d"):
        materialize_model_inputs(jcfg, batch)
