"""A JAX checkpoint (flax msgpack `.ckpt`) as the port's weights.

`utils/flax_msgpack.py` reads and writes the format without msgpack, flax
or JAX.  Held here against the JAX package on the tiny flagship
(epipolarposeR-18, 32 px, 8x8 heatmaps, 5 joints, K=4), whose weights are
randomized (the zero-init fusion BN's scale too, or the `z` path would not
show):

  * the JAX `Checkpointer.save` of a TrainState (adam moments, the step),
    with a bfloat16 leaf in `extra` and flax's chunking forced by a small
    `MAX_CHUNK_SIZE`, read by `restore` with every leaf bit-equal to
    `flax.serialization.msgpack_restore` (bfloat16 through its uint16 bits);
  * `serialize` writes the bytes `msgpack_serialize` writes, chunked or not;
  * the port's forward on the file, loaded through cfg.WEIGHTS, agrees with
    JAX's `apply` on the same weights (f32 on both sides: rtol 1e-4, atol
    1e-5; the heatmaps' scale here is ~1, so atol 1e-5 is ~1e-5 of it);
  * a `last_checkpoint` tag naming a `.ckpt` loads the weights only and
    returns its `extra`;
  * `write_checkpoint` of a port model gives back its state dict bit for bit;
  * scripts/torch_convert_20to17.py against scripts/convert_20to17.py.

The BackboneCatalog `.ckpt` graft is in tests/test_torch_pretrained.py.
"""

import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import flax.serialization as fser
import jax
import jax.numpy as jnp
import optax
import torch

from __graft_entry__ import _flagship_cfg
from epipolar_transformers_tpu.engine.trainer import TrainState
from epipolar_transformers_tpu.models import ModelBuilder as JModelBuilder
from epipolar_transformers_tpu.utils.checkpoint import Checkpointer as JCheckpointer
from epipolar_transformers_tpu_torch.config import flagship_cfg
from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
from epipolar_transformers_tpu_torch.data.pipeline import EvalLoader
from epipolar_transformers_tpu_torch.engine.tester import predict
from epipolar_transformers_tpu_torch.engine.trainer import load_weights
from epipolar_transformers_tpu_torch.models import ModelBuilder
from epipolar_transformers_tpu_torch.utils import flax_msgpack
from epipolar_transformers_tpu_torch.utils.checkpoint import Checkpointer
from epipolar_transformers_tpu_torch.utils.jax_import import (flax_variables, jax_state_dict,
                                                              load_jax_variables)
from test_torch_resnet import randomize_variables, to_numpy_tree
from torch_configs import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL_KEYS = ("img", "KRT", "other_img", "other_KRT")
FORWARD_TOL = dict(rtol=1e-4, atol=1e-5)
SMALL_CHUNK = 4096  # bytes: the trunk's larger kernels are chunked


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def _bits(v):
    """A leaf as comparable bits: bfloat16 through uint16."""
    if isinstance(v, torch.Tensor):
        assert v.dtype == torch.bfloat16
        return v.view(torch.int16).numpy().view(np.uint16)
    a = np.asarray(v)
    if a.dtype == jnp.bfloat16:
        return a.view(np.uint16)
    return a


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The JAX side: random tiny-flagship weights, a TrainState saved by
    the JAX Checkpointer with chunked leaves, and JAX's heatmaps."""
    rng = np.random.RandomState(0)
    jcfg = _flagship_cfg(tiny=True)
    groups = list(EvalLoader(SyntheticMultiview(flagship_cfg(tiny=True), is_train=False,
                                                n_samples=2)))
    jmodel = JModelBuilder(jcfg)
    inputs0 = {k: jnp.asarray(groups[0][k][0]) for k in EVAL_KEYS}
    variables = jax.jit(lambda k: jmodel.init(k, inputs0, is_train=False))(jax.random.PRNGKey(0))
    variables = randomize_variables(to_numpy_tree(variables), rng)
    bn = variables["params"]["reference"]["epipolar_sampler"]["bn"]["norm"]
    bn["scale"] = rng.randn(*bn["scale"].shape).astype(np.float32)
    state = TrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                              tx=optax.adam(1e-3), batch_stats=variables["batch_stats"])
    out_dir = tmp_path_factory.mktemp("jax_ckpt")
    probe = jnp.asarray(rng.randn(3, 7), jnp.bfloat16)
    old = fser.MAX_CHUNK_SIZE
    fser.MAX_CHUNK_SIZE = SMALL_CHUNK
    try:
        JCheckpointer(str(out_dir)).save("model_final", state, epoch=4, probe=probe)
    finally:
        fser.MAX_CHUNK_SIZE = old
    step = jax.jit(lambda v, x: jmodel.apply(v, x, is_train=False)[2])
    want = [np.asarray(step(variables, {k: jnp.asarray(g[k][0]) for k in EVAL_KEYS})[
        "heatmap_pred"], np.float32) for g in groups]
    return str(out_dir / "model_final.ckpt"), variables, groups, want


def test_restore_is_bit_equal_to_flax(saved):
    path = saved[0]
    data = open(path, "rb").read()
    assert b"__msgpack_chunked_array__" in data
    got, want = flax_msgpack.restore(data), fser.msgpack_restore(data)
    got_leaves, want_leaves = dict(_leaves(got)), dict(_leaves(want))
    assert list(got_leaves) == list(want_leaves)
    assert isinstance(got["extra"]["probe"], torch.Tensor)
    assert got["extra"]["probe"].dtype == torch.bfloat16
    for k, w in want_leaves.items():
        g = got_leaves[k]
        gb, wb = _bits(g), _bits(w)
        assert gb.dtype == wb.dtype and gb.shape == wb.shape, k
        assert np.array_equal(gb, wb), k


@pytest.mark.parametrize("chunk", [None, SMALL_CHUNK], ids=["whole", "chunked"])
def test_serialize_writes_flax_bytes(saved, chunk):
    tree = fser.msgpack_restore(open(saved[0], "rb").read())
    old = fser.MAX_CHUNK_SIZE
    fser.MAX_CHUNK_SIZE = chunk or old
    try:
        want = fser.msgpack_serialize(tree)
    finally:
        fser.MAX_CHUNK_SIZE = old
    assert flax_msgpack.serialize(tree, max_chunk=chunk or flax_msgpack.MAX_CHUNK_SIZE) == want
    # the port's own leaves (bfloat16 as a torch tensor) give the same bytes
    assert flax_msgpack.serialize(flax_msgpack.restore(want),
                                  max_chunk=chunk or flax_msgpack.MAX_CHUNK_SIZE) == want


def test_forward_on_the_ckpt_matches_jax(saved, tmp_path):
    path, variables, groups, want = saved
    cfg = flagship_cfg(tiny=True).replace(WEIGHTS=path, OUTPUT_DIR=str(tmp_path))
    model = ModelBuilder(cfg)
    extra = load_weights(cfg, model, load_opt=True)
    assert extra == {"epoch": 4, "probe": extra["probe"]}
    expect, _ = jax_state_dict(model, variables)
    for k, v in model.state_dict().items():
        assert torch.equal(v, expect[k]), k
    for got, w in zip(predict(cfg, model, groups), want):
        np.testing.assert_allclose(got["heatmap_pred"].numpy(), w.transpose(0, 3, 1, 2),
                                   **FORWARD_TOL)


def test_last_checkpoint_naming_a_ckpt_loads_weights_only(saved, tmp_path, caplog):
    path = saved[0]
    out = tmp_path / "out"
    out.mkdir()
    os.symlink(path, out / "model_final.ckpt")
    (out / "last_checkpoint").write_text("model_final.ckpt")
    cfg = flagship_cfg(tiny=True).replace(OUTPUT_DIR=str(out), WEIGHTS="")
    model = ModelBuilder(cfg)
    with caplog.at_level(logging.INFO):
        extra = Checkpointer(str(out)).load(model, None, None, load_opt=True)
    assert extra["epoch"] == 4
    assert "Loaded model weights only (WEIGHTS_LOAD_OPT=False)" in caplog.text
    expect, _ = jax_state_dict(model, saved[1])
    assert all(torch.equal(v, expect[k]) for k, v in model.state_dict().items())


def test_write_checkpoint_round_trips_the_port_model(tmp_path):
    model = ModelBuilder(flagship_cfg(tiny=True))
    model.init_weights(torch.Generator().manual_seed(3))
    path = str(tmp_path / "w.ckpt")
    flax_msgpack.write_checkpoint(path, model, epoch=2)
    payload = fser.msgpack_restore(open(path, "rb").read())
    assert set(payload) == {"state", "extra"} and payload["extra"] == {"epoch": 2}
    fresh = ModelBuilder(flagship_cfg(tiny=True))
    load_jax_variables(fresh, {"params": payload["state"]["params"],
                               "batch_stats": payload["state"]["batch_stats"]})
    want = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    for k, v in want.items():
        assert torch.equal(fresh.state_dict()[k], v), k
    variables = flax_variables(model)
    assert flax_msgpack.serialize(variables) == fser.msgpack_serialize(variables)


def test_unreadable_ckpt_raises_naming_the_file(tmp_path):
    path = tmp_path / "bad.ckpt"
    path.write_bytes(b"\xc1not msgpack")
    with pytest.raises(flax_msgpack.MsgpackError, match="bad.ckpt"):
        flax_msgpack.read_checkpoint(str(path))


def test_ext_types_other_than_arrays_and_scalars_raise():
    # flax packs a Python complex as ext type 2; no checkpoint of these
    # models holds one, and the port reads only types 1 and 3
    data = fser.msgpack_serialize({"c": 1 + 2j})
    with pytest.raises(flax_msgpack.MsgpackError, match="unknown ext type 2"):
        flax_msgpack.restore(data)
    with pytest.raises(flax_msgpack.MsgpackError, match="cannot serialize complex"):
        flax_msgpack.serialize({"c": 1 + 2j})


def test_convert_20to17_matches_the_jax_script(tmp_path):
    """A 20-joint JAX checkpoint cut by both scripts: the port's output
    loads into a 17-joint port model bit-equal to the JAX output."""
    rng = np.random.RandomState(5)
    cfg20 = flagship_cfg(tiny=True).replace(KEYPOINT=flagship_cfg(tiny=True).KEYPOINT.replace(
        NUM_PTS=20))
    model20 = ModelBuilder(cfg20)
    for p in model20.parameters():
        p.data = torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
    src = str(tmp_path / "m20.ckpt")
    flax_msgpack.write_checkpoint(src, model20, epoch=1)
    jax_out, port_out = str(tmp_path / "m17.ckpt"), str(tmp_path / "m17.pth")
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, os.path.join(ROOT, "scripts/convert_20to17.py"), src,
                    jax_out], check=True, env=env, cwd=ROOT, capture_output=True)
    yaml = tmp_path / "tiny20.yaml"
    yaml.write_text(_tiny_yaml(20))
    subprocess.run([sys.executable, os.path.join(ROOT, "scripts/torch_convert_20to17.py"),
                    "--cfg", str(yaml), src, port_out], check=True, env=env, cwd=ROOT,
                   capture_output=True)
    cfg17 = flagship_cfg(tiny=True).replace(KEYPOINT=flagship_cfg(tiny=True).KEYPOINT.replace(
        NUM_PTS=17), WEIGHTS=port_out)
    model17 = ModelBuilder(cfg17)
    assert load_weights(cfg17, model17) == {"epoch": 1}
    jvars = fser.msgpack_restore(open(jax_out, "rb").read())["state"]
    want, _ = jax_state_dict(model17, {"params": jvars["params"],
                                       "batch_stats": jvars["batch_stats"]})
    for k, v in model17.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert model17.reference.final_layer.weight.shape[0] == 17
    # a port checkpoint goes through without a config
    again = str(tmp_path / "again.pth")
    torch.save({"model": model20.state_dict(), "optimizer": None, "extra": {}}, again)
    subprocess.run([sys.executable, os.path.join(ROOT, "scripts/torch_convert_20to17.py"),
                    again, again + ".17"], check=True, env=env, cwd=ROOT, capture_output=True)
    cut = torch.load(again + ".17", weights_only=True)["model"]
    assert torch.equal(cut["reference.final_layer.weight"],
                       model20.state_dict()["reference.final_layer.weight"][
                           torch.as_tensor([0, 1, 2, 3, 4, 5, 6, 7, 9, 11, 12, 14, 15, 16, 17,
                                            18, 19])])


def _tiny_yaml(joints: int) -> str:
    """The tiny flagship as a YAML (the port's `flagship_cfg(tiny=True)`)."""
    return f"""
DATASETS:
  TRAIN: ('synthetic_multiview_train',)
  TEST: ('synthetic_multiview_val',)
  TASK: multiview_keypoint
  IMAGE_SIZE: (32, 32)
BACKBONE:
  BODY: epipolarposeR-18
  PRETRAINED: False
KEYPOINT:
  NUM_PTS: {joints}
  HEATMAP_SIZE: (8, 8)
  SIGMA: 2.0
  LOSS: joint
EPIPOLAR:
  SAMPLESIZE: 4
  MERGE: late
  ATTENTION: avg
  SIMILARITY: dot
  PARAMETERIZED: ('z',)
  ZRESIDUAL: True
  SHARE_WEIGHTS: True
  PRETRAINED: False
  USE_CORRECT_NORMALIZE: True
"""
