"""Weight import (utils/pretrained.py, utils/torch_import.py) == the JAX
package's `apply_pretrained`, leaf for leaf.

A tiny epipolarposeR-18 (64 px, 16x16 heatmaps, 5 joints, K=8) starts from
one random JAX variables tree (the flax init's structure, carried across by
utils/jax_import with strict=True); the same torch files then
go through JAX `apply_pretrained` on the variables and through the port's
on the model, and the port's state dict must be bit-equal to
`jax_state_dict` of the JAX result: the BackboneCatalog single-view graft
(shared and unshared weights), BACKBONE.PRETRAINED_WEIGHTS without
`final_layer`, and a cfg.WEIGHTS `.pth` under the WEIGHTS_PREFIX rules.  The
full-model files hold `reference.epipolar_sampler.bn.*`, which JAX leaves
at its initial values (its BN sits one `norm` level deeper), so the port
must too.

Also: the C6 regression (a reference checkpoint under `module.`, and a bare
state dict, load through `train`), the port's own checkpoint as cfg.WEIGHTS,
the `last_checkpoint` tag winning over cfg.WEIGHTS, a `.ckpt` that is no
flax msgpack raising, the BackboneCatalog `model_final.ckpt` graft,
and the port's copies of the import helpers against the JAX originals.
"""

import argparse
import contextlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from epipolar_transformers_tpu.config.catalog import BackboneCatalog as JBackboneCatalog
from epipolar_transformers_tpu.models import ModelBuilder as JModelBuilder
from epipolar_transformers_tpu.utils import pretrained as jpretrained
from epipolar_transformers_tpu.utils import torch_import as jimport
from epipolar_transformers_tpu_torch.config import BackboneCatalog, flagship_cfg, update_from_dict
from epipolar_transformers_tpu_torch.engine.trainer import build_model, load_weights, train
from epipolar_transformers_tpu_torch.models import ModelBuilder
from epipolar_transformers_tpu_torch.utils import pretrained, torch_import
from epipolar_transformers_tpu_torch.utils.checkpoint import Checkpointer
from epipolar_transformers_tpu_torch.utils.jax_import import jax_state_dict, load_jax_variables
from test_torch_import import _tiny_torch_posenet_sd
from test_torch_resnet import to_numpy_tree
from torch_configs import config_pair, one_torch_thread  # noqa: F401 (autouse)


def _cfgs(share_weights=True, **d):
    base = {
        "DATASETS": {"TASK": "multiview_keypoint", "IMAGE_SIZE": (64, 64)},
        "BACKBONE": {"BODY": "epipolarposeR-18", "DOWNSAMPLE": 4},
        "KEYPOINT": {"NUM_PTS": 5, "HEATMAP_SIZE": (16, 16), "SIGMA": 2.0, "LOSS": "joint"},
        "EPIPOLAR": {"SHARE_WEIGHTS": share_weights, "PRETRAINED": False, "MERGE": "late",
                     "SAMPLESIZE": 8, "TOPK": 1, "PARAMETERIZED": ("z",), "ZRESIDUAL": True,
                     "ATTENTION": "avg", "SIMILARITY": "dot", "USE_CORRECT_NORMALIZE": True},
    }
    for k, v in d.items():
        base[k] = {**base[k], **v} if isinstance(v, dict) else v
    return config_pair(base)


def _jax_init(jcfg):
    rng = np.random.RandomState(1)
    n = 1
    inputs = {
        "img": rng.rand(n, 64, 64, 3).astype(np.float32),
        "other_img": rng.rand(n, 64, 64, 3).astype(np.float32),
        "KRT": np.tile(np.hstack([np.eye(3), np.zeros((3, 1))]), (n, 1, 1)).astype(np.float32),
        "other_KRT": np.tile(np.hstack([np.eye(3), np.ones((3, 1))]), (n, 1, 1)).astype(np.float32),
    }
    model = JModelBuilder(jcfg)
    # the tree's structure from a trace (no compile), random values
    shapes = jax.eval_shape(lambda k: model.init(
        k, {n: jnp.asarray(v) for n, v in inputs.items()}, is_train=False), jax.random.PRNGKey(0))
    return to_numpy_tree(jax.tree_util.tree_map(lambda t: rng.randn(*t.shape), shapes))


@pytest.fixture(scope="module")
def init_variables():
    """Initial JAX variables of the shared and the unshared model."""
    return {share: _jax_init(_cfgs(share)[1]) for share in (True, False)}


def _import_both(cfg, jcfg, variables):
    """(port state dict after its import, the JAX result as a port state
    dict, the keys the import changed), from the same initial weights."""
    model = ModelBuilder(cfg)
    load_jax_variables(model, variables)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    pretrained.apply_pretrained(cfg, model)
    jvars = jpretrained.apply_pretrained(jcfg, variables)
    want, _ = jax_state_dict(model, to_numpy_tree(jvars))
    got = model.state_dict()
    return got, want, {k for k in got if not torch.equal(got[k], init[k])}


def _assert_bit_equal(got, want):
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k


def _posenet_sd(seed, prefix=""):
    return {prefix + k: torch.from_numpy(np.asarray(v))
            for k, v in _tiny_torch_posenet_sd(np.random.RandomState(seed)).items()}


def _full_model_sd(cfg, seed, prefix=""):
    """A reference-format state dict of the whole multiview model: the
    port's own key names (the reference's), random values."""
    rng = np.random.RandomState(seed)
    return {prefix + k: torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
            if v.is_floating_point() else v
            for k, v in ModelBuilder(cfg).state_dict().items()}


@pytest.mark.parametrize("share", [True, False], ids=["shared", "unshared"])
def test_single_view_catalog_graft_matches_jax(tmp_path, monkeypatch, init_variables, share):
    monkeypatch.setattr(BackboneCatalog, "OUTS_DIR", str(tmp_path))
    monkeypatch.setattr(JBackboneCatalog, "OUTS_DIR", str(tmp_path))
    ckpt_dir = tmp_path / "benchmark" / "keypoint_h36m"
    ckpt_dir.mkdir(parents=True)
    torch.save({"model": _posenet_sd(3, "backbone.module.")}, ckpt_dir / "model.pth")
    (ckpt_dir / "last_checkpoint").write_text("model.pth")
    cfg, jcfg = _cfgs(share, EPIPOLAR={"PRETRAINED": True})
    got, want, changed = _import_both(cfg, jcfg, init_variables[share])
    _assert_bit_equal(got, want)
    assert "reference.conv1.weight" in changed
    assert ("backbone.conv1.weight" in changed) == (not share)
    assert not any("epipolar_sampler" in k for k in changed)


def test_backbone_pretrained_weights_match_jax(tmp_path, init_variables):
    path = str(tmp_path / "imagenet.pth")
    torch.save({"model": _posenet_sd(4, "module.")}, path)
    cfg, jcfg = _cfgs(BACKBONE={"PRETRAINED": True, "PRETRAINED_WEIGHTS": path})
    got, want, changed = _import_both(cfg, jcfg, init_variables[True])
    _assert_bit_equal(got, want)
    assert "reference.layer4.1.conv2.weight" in changed
    assert not any("final_layer" in k for k in changed)


@pytest.mark.parametrize("keys,weights", [
    ("module.", {"WEIGHTS_PREFIX": "module."}),
    ("module.", {"WEIGHTS_PREFIX": "module.", "WEIGHTS_PREFIX_REPLACE": "reference."}),
    ("mixed", {"WEIGHTS_PREFIX": "module.", "WEIGHTS_ALLOW_DIFF_PREFIX": True}),
    ("mixed", {"WEIGHTS_PREFIX": "module."}),
    ("", {"WEIGHTS_PREFIX": "", "WEIGHTS_PREFIX_REPLACE": "reference."}),
], ids=["prefix", "replace", "allow-diff", "diff-untouched", "empty-prefix-replace"])
def test_cfg_weights_pth_matches_jax(tmp_path, init_variables, keys, weights):
    """Full-model files (`reference.*` under `module.`, a bare backbone
    under `module.` with a replacement, mixed prefixes with and without
    WEIGHTS_ALLOW_DIFF_PREFIX) and an empty prefix with a replacement."""
    cfg, _ = _cfgs()
    if keys == "mixed":
        sd = {**_full_model_sd(cfg, 5, "module."), **_posenet_sd(6, "teacher.")}
    elif "WEIGHTS_PREFIX_REPLACE" in weights:
        sd = _posenet_sd(7, keys)
    else:
        sd = _full_model_sd(cfg, 8, keys)
    path = str(tmp_path / "w.pth")
    torch.save({"model": sd}, path)
    cfg, jcfg = _cfgs(WEIGHTS=path, **weights)
    got, want, changed = _import_both(cfg, jcfg, init_variables[True])
    _assert_bit_equal(got, want)
    assert "reference.layer1.0.conv1.weight" in changed
    assert not any(k.startswith("reference.epipolar_sampler.bn.") for k in changed)


def test_fusion_layers_import_as_jax(tmp_path):
    """A reference-format file of the whole R-50 model with MERGE 'both' and
    the param recipe's layer (theta/phi/g, BOTTLENECK 2, POOLING): the same
    leaves loaded as the JAX import loads (both samplers' theta, phi, g and
    z), the same left at their initial values (their zero-init BNs, under
    flax's extra `norm` level)."""
    fusion = {"BACKBONE": {"BODY": "epipolarposeR-50", "DOWNSAMPLE": 4},
              "EPIPOLAR": {"MERGE": "both", "PARAMETERIZED": ("z", "theta", "phi", "g"),
                           "BOTTLENECK": 2, "POOLING": True, "ZRESIDUAL": False}}
    cfg, jcfg = _cfgs(**fusion)
    sd = _full_model_sd(cfg, 9, "module.")
    path = str(tmp_path / "w.pth")
    torch.save({"model": sd}, path)
    cfg, jcfg = _cfgs(WEIGHTS=path, WEIGHTS_PREFIX="module.", **fusion)
    got, want, changed = _import_both(cfg, jcfg, _jax_init(jcfg))
    _assert_bit_equal(got, want)
    for sampler in ("epipolar_sampler", "epipolar_sampler1"):
        for name in ("theta", "phi", "g", "z"):
            assert f"reference.{sampler}.{name}.weight" in changed, (sampler, name)
        assert not any(k.startswith(f"reference.{sampler}.bn.") for k in changed), sampler


@pytest.mark.parametrize("wrap", [True, False], ids=["module-prefix", "bare-state-dict"])
def test_reference_checkpoint_loads_through_train(tmp_path, wrap):
    """C6: a reference checkpoint ({'model': ...}, keys under `module.`) and
    a bare state dict in cfg.WEIGHTS are imported, not read as the port's
    own checkpoint.  One step at learning rate 0 leaves the parameters as
    imported; the zero-init fusion BN keeps its initial weights (as JAX
    does, see the module docstring)."""
    cfg = update_from_dict(flagship_cfg(tiny=True), {
        "SOLVER": {"OPTIMIZER": "sgd", "BASE_LR": 0.0, "IMS_PER_BATCH": 2},
        "OUTPUT_DIR": str(tmp_path / "out")})
    sd = _full_model_sd(cfg, 9)
    path = str(tmp_path / "ref.pth")
    torch.save({"model": {"module." + k: v for k, v in sd.items()}} if wrap else sd, path)
    model, optimizer = train(cfg.replace(WEIGHTS=path), max_steps=1, device="cpu")
    assert optimizer.count == 1
    imported = 0
    for k, p in model.named_parameters():
        if k.startswith("reference.epipolar_sampler.bn."):
            assert not p.detach().abs().any(), k
        else:
            assert torch.equal(p.detach(), sd[k]), k
            imported += 1
    assert imported > 50


def test_port_checkpoint_resumes_and_the_tag_wins(tmp_path):
    cfg = update_from_dict(flagship_cfg(tiny=True), {"OUTPUT_DIR": str(tmp_path / "out")})
    saved = build_model(cfg.replace(SEED=5), torch.device("cpu"))
    Checkpointer(str(tmp_path / "run")).save("model_007", saved, None, epoch=7)
    native = str(tmp_path / "run" / "model_007.pth")

    # the port's own .pth in cfg.WEIGHTS goes through the Checkpointer
    model = build_model(cfg, torch.device("cpu"))
    extra = load_weights(cfg.replace(WEIGHTS=native), model)
    assert extra == {"epoch": 7}
    for (k, a), b in zip(saved.state_dict().items(), model.state_dict().values()):
        assert torch.equal(a, b), k

    # a last_checkpoint tag in OUTPUT_DIR wins over a foreign cfg.WEIGHTS
    foreign = str(tmp_path / "ref.pth")
    torch.save({"model": _full_model_sd(cfg, 10, "module.")}, foreign)
    Checkpointer(cfg.OUTPUT_DIR).save("model_001", saved, None, epoch=1)
    model = build_model(cfg, torch.device("cpu"))
    assert load_weights(cfg.replace(WEIGHTS=foreign), model) == {"epoch": 1}
    for (k, a), b in zip(saved.state_dict().items(), model.state_dict().values()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("extra,weights_only", [(None, [True]),
                                                 (argparse.Namespace(lr=0.1), [True, False])],
                         ids=["tensors-only", "with-an-object"])
def test_read_torch_file_needs_the_full_unpickler_only_for_objects(tmp_path, monkeypatch,
                                                                   extra, weights_only):
    """A file of tensors (a state dict, the port's own checkpoint) is read
    by the weights-only unpickler; only a file holding other objects, as a
    reference checkpoint's training arguments, falls back to the full one."""
    sd = _posenet_sd(14)
    path = str(tmp_path / "w.pth")
    torch.save({"model": sd} if extra is None else {"model": sd, "args": extra}, path)
    calls, load = [], torch.load
    monkeypatch.setattr(torch, "load", lambda *a, **kw: calls.append(kw["weights_only"])
                        or load(*a, **kw))
    payload = torch_import.read_torch_file(path)
    assert calls == weights_only
    assert all(torch.equal(payload["model"][k], v) for k, v in sd.items())
    if extra is not None:
        assert payload["args"] == extra


@pytest.mark.parametrize("name,match", [("w.ckpt", "not a flax msgpack checkpoint")])
def test_unported_formats_raise(tmp_path, name, match):
    """A `.ckpt` that holds no flax msgpack is refused, naming the file,
    before anything is imported."""
    cfg = flagship_cfg(tiny=True).replace(WEIGHTS=str(tmp_path / name))
    (tmp_path / name).write_bytes(b"")
    with pytest.raises(ValueError, match=match):
        load_weights(cfg, torch.nn.Module())


def _nest(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


@pytest.mark.parametrize("share", [True, False], ids=["shared", "unshared"])
def test_single_view_catalog_ckpt_graft_matches_jax(tmp_path, monkeypatch, init_variables,
                                                     share):
    """A BackboneCatalog directory's `model_final.ckpt` (a single-view JAX
    checkpoint, its trunk under `backbone`) grafted by suffix as JAX
    `_graft_subtree` does, bit-equal."""
    from flax import serialization

    monkeypatch.setattr(BackboneCatalog, "OUTS_DIR", str(tmp_path))
    monkeypatch.setattr(JBackboneCatalog, "OUTS_DIR", str(tmp_path))
    ckpt_dir = tmp_path / "benchmark" / "keypoint_h36m"
    ckpt_dir.mkdir(parents=True)
    params, stats = jimport.convert_state_dict(
        {k: v.numpy() for k, v in _posenet_sd(6).items()})
    payload = {"state": {"step": np.int32(7), "params": {"backbone": _nest(params)},
                         "batch_stats": {"backbone": _nest(stats)}}, "extra": {"epoch": 2}}
    (ckpt_dir / "model_final.ckpt").write_bytes(serialization.msgpack_serialize(payload))
    cfg, jcfg = _cfgs(share, EPIPOLAR={"PRETRAINED": True})
    got, want, changed = _import_both(cfg, jcfg, init_variables[share])
    _assert_bit_equal(got, want)
    assert "reference.conv1.weight" in changed and "reference.bn1.running_mean" in changed
    assert ("backbone.conv1.weight" in changed) == (not share)
    assert not any("epipolar_sampler" in k for k in changed)


def test_copies_match_jax(tmp_path):
    """The port's strip_prefix, convert_state_dict, align_by_suffix,
    load_torch_state_dict and resolve_checkpoint == the JAX originals."""
    sd = {k: v.numpy() for k, v in {**_posenet_sd(11, "module."),
                                    **_posenet_sd(12, "x.")}.items()}
    for args in (("module.", "", False), ("module.", "", True), ("module.", "r.", True),
                 ("", "r.", False), ("", "", False)):
        with pytest.warns(UserWarning) if args[0] else contextlib.nullcontext():
            got = torch_import.strip_prefix(sd, *args)
        with pytest.warns(UserWarning) if args[0] else contextlib.nullcontext():
            want = jimport.strip_prefix(sd, *args)
        assert list(got) == list(want), args
        got_p, got_s = torch_import.convert_state_dict(got)
        want_p, want_s = jimport.convert_state_dict(want)
        for g, w in ((got_p, want_p), (got_s, want_s)):
            assert list(g) == list(w)
            assert all(np.array_equal(g[k], w[k]) for k in g)
    dest = {("reference", "conv1", "kernel"): np.zeros((7, 7, 3, 64), np.float32),
            ("reference", "bn1", "scale"): np.zeros(64, np.float32),
            ("reference", "x", "kernel"): np.zeros(3, np.float32)}
    with pytest.warns(UserWarning):
        source = jimport.convert_state_dict(sd, "x.", "", True)[0]
    got, got_missing = torch_import.align_by_suffix(dest, source)
    want, want_missing = jimport.align_by_suffix(dest, source)
    assert got_missing == want_missing == ["reference/x/kernel"]
    assert all(np.array_equal(got[k], want[k]) for k in dest)

    path = str(tmp_path / "m.pth")
    torch.save({"model": _posenet_sd(13)}, path)
    got, want = torch_import.load_torch_state_dict(path), jimport.load_torch_state_dict(path)
    assert list(got) == list(want) and all(np.array_equal(got[k], want[k]) for k in got)
    for names in ((), ("model.pth",), ("model.pth", "model_final.ckpt"), ("last", "a.pth")):
        d = tmp_path / f"ckpt{len(names)}{names[:1]}"
        d.mkdir()
        for n in names:
            if n == "last":
                (d / "last_checkpoint").write_text("a.pth")
            else:
                (d / n).write_bytes(b"")
        assert pretrained.resolve_checkpoint(str(d)) == jpretrained.resolve_checkpoint(str(d))

