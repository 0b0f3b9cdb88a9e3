"""The port's copies of the JAX package's small utilities, and its depth IO.

  * utils/clustering.py (seeded numpy k-means), utils/file_utils.py's KRT
    parser, utils/timer.py, logger.py and registry.py: copies, held equal to
    the JAX originals on the same inputs (bit for bit; the timer by its
    bookkeeping);
  * utils/depth_io.py without cv2, against the JAX `load_depth` (cv2
    IMREAD_UNCHANGED) bit for bit: 16-bit grey PNG (every row filter),
    8-bit RGB PNG (cv2's first channel, blue), binary and text PGM of 8 and
    16 bits, uncompressed TIFF (16-bit and float32); a compressed TIFF
    raises naming its compression; `save_depth_png` reads back in cv2
    equal to the JAX writer's file; `rhd_depth_decode` equal.
"""

import logging
import os

import cv2
import numpy as np
import pytest

from epipolar_transformers_tpu.utils import clustering as jclustering
from epipolar_transformers_tpu.utils import depth_io as jdepth
from epipolar_transformers_tpu.utils import file_utils as jfile
from epipolar_transformers_tpu.utils import logger as jlogger
from epipolar_transformers_tpu.utils import registry as jregistry
from epipolar_transformers_tpu_torch.data.image_io import write_png
from epipolar_transformers_tpu_torch.utils import clustering, depth_io, file_utils
from epipolar_transformers_tpu_torch.utils import logger, registry, timer


def test_kmeans_copy_matches_jax():
    rng = np.random.RandomState(0)
    data = np.concatenate([rng.randn(60, 3) + 4, rng.randn(60, 3) - 4, rng.randn(30, 3)])
    for k, seed in ((2, 0), (3, 1), (5, 7)):
        got, want = clustering.kmeans(data, k, seed=seed), jclustering.kmeans(data, k, seed=seed)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    img = rng.rand(9, 11, 3).astype(np.float32)
    np.testing.assert_array_equal(clustering.quantize_image(img, k=4, seed=3),
                                  jclustering.quantize_image(img, k=4, seed=3))


def test_krt_copy_matches_jax(tmp_path):
    rng = np.random.RandomState(1)
    cams = {f"cam{i}": {"K": rng.rand(3, 3), "RT": rng.rand(3, 4)} for i in range(3)}
    file_utils.save_krt(str(tmp_path / "port.txt"), cams)
    jfile.save_krt(str(tmp_path / "jax.txt"), cams)
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    got, want = file_utils.load_krt(str(tmp_path / "jax.txt")), jfile.load_krt(
        str(tmp_path / "jax.txt"))
    assert list(got) == list(want)
    for name in got:
        for key in ("K", "RT", "KRT"):
            np.testing.assert_array_equal(got[name][key], want[name][key])


def test_timer_logger_registry_copies(tmp_path):
    t = timer.Timer()
    for _ in range(3):
        t.tic()
        t.toc()
    assert t.calls == 3 and t.average_time == pytest.approx(t.total_time / 3)
    assert len(timer.timestamp_name()) == len("2020-01-01_00-00-00")
    log = logger.setup_logger("port_copy_test", str(tmp_path), "log.txt")
    jlog = jlogger.setup_logger("jax_copy_test", str(tmp_path), "jlog.txt")
    assert [type(h) for h in log.handlers] == [type(h) for h in jlog.handlers]
    assert log.level == jlog.level == logging.DEBUG
    log.info("hello")
    assert "hello" in (tmp_path / "log.txt").read_text()
    assert logger.setup_logger("port_copy_test") is log
    for reg in (registry.Registry(), jregistry.Registry()):
        reg.register("a", 1)

        @reg.register("f")
        def f():
            return 2
        assert reg["a"] == 1 and reg["f"]() == 2
        with pytest.raises(KeyError, match="already registered"):
            reg.register("a", 3)


def _pair(tmp_path, name, img, params=()):
    path = str(tmp_path / name)
    assert cv2.imwrite(path, img, list(params))
    return path


@pytest.mark.parametrize("case", ["png16", "png16_filters", "png8_rgb", "pgm16", "pgm8",
                                  "pgm_text", "tiff16", "tiff_float"])
def test_load_depth_matches_cv2(tmp_path, case):
    rng = np.random.RandomState(2)
    d16 = rng.randint(0, 65536, (23, 31)).astype(np.uint16)
    d8 = rng.randint(0, 256, (23, 31)).astype(np.uint8)
    if case == "png16":
        path = _pair(tmp_path, "d.png", d16)
    elif case == "png16_filters":  # the port's writer, every row filter
        path = str(tmp_path / "d.png")
        write_png(path, d16, filters=(0, 1, 2, 3, 4))
    elif case == "png8_rgb":
        path = _pair(tmp_path, "d.png", rng.randint(0, 256, (23, 31, 3)).astype(np.uint8))
    elif case == "pgm16":
        path = _pair(tmp_path, "d.pgm", d16)
    elif case == "pgm8":
        path = _pair(tmp_path, "d.pgm", d8)
    elif case == "pgm_text":
        path = _pair(tmp_path, "d.pgm", d16, (cv2.IMWRITE_PXM_BINARY, 0))
    elif case == "tiff16":
        path = _pair(tmp_path, "d.tiff", d16, (cv2.IMWRITE_TIFF_COMPRESSION, 1))
    else:
        path = _pair(tmp_path, "d.tiff", rng.rand(23, 31).astype(np.float32),
                     (cv2.IMWRITE_TIFF_COMPRESSION, 1))
    got, want = depth_io.load_depth(path, 0.001), jdepth.load_depth(path, 0.001)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_compressed_tiff_raises_naming_it(tmp_path):
    path = _pair(tmp_path, "lzw.tiff", np.zeros((4, 4), np.uint16),
                 (cv2.IMWRITE_TIFF_COMPRESSION, 5))
    with pytest.raises(ValueError, match="LZW"):
        depth_io.load_depth(path)
    with pytest.raises(FileNotFoundError):
        depth_io.load_depth(str(tmp_path / "missing.png"))


def test_save_depth_png_and_rhd_decode_match_jax(tmp_path):
    rng = np.random.RandomState(3)
    depth = rng.rand(17, 19) * 70.0 - 1.0  # clipped at 0 and 65535 mm
    depth_io.save_depth_png(str(tmp_path / "port.png"), depth)
    jdepth.save_depth_png(str(tmp_path / "jax.png"), depth)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "port.png"), cv2.IMREAD_UNCHANGED),
        cv2.imread(str(tmp_path / "jax.png"), cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(depth_io.load_depth(str(tmp_path / "jax.png")),
                                  jdepth.load_depth(str(tmp_path / "port.png")))
    rgb = rng.randint(0, 256, (5, 6, 3)).astype(np.uint8)
    np.testing.assert_array_equal(depth_io.rhd_depth_decode(rgb), jdepth.rhd_depth_decode(rgb))
    assert os.path.getsize(tmp_path / "port.png") > 0
