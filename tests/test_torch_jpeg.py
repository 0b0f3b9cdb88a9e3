"""The port's baseline JPEG decoder and encoder (data/jpeg.py) against cv2.

`read_jpeg` is bit-equal to cv2.imdecode / cv2.imread (IMREAD_COLOR, whose
libjpeg-turbo decodes with the ISLOW IDCT, fancy upsampling and the
fixed-point YCbCr tables) on files cv2 writes: qualities 50/75/92/100,
sampling 4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1, grey, restart intervals,
sizes from 1x1 to a 1002x1000 fake H36M frame, and small images drawn by
hypothesis; it raises, naming the file, on a progressive JPEG.  The
encoder's files decode bit-equal in cv2 and in the port, within a stated
PSNR of their source, and its tables are libjpeg's.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

cv2 = pytest.importorskip("cv2")

from epipolar_transformers_tpu_torch.data.jpeg import (  # noqa: E402
    JpegError, encode_jpeg, quality_tables, read_jpeg, write_jpeg)

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
# the encoder's PSNR to its source may fall this far below cv2's own file's
PSNR_SLACK_DB = 0.5


def textured(h, w, seed=0, grey=False):
    """A gradient with noise: every block has AC coefficients."""
    rng = np.random.RandomState(seed)
    base = np.add.outer(np.linspace(0, 180, h), np.linspace(0, 60, w))[..., None]
    img = np.clip(base + rng.randint(0, 50, (h, w, 3)), 0, 255).astype(np.uint8)
    return img[..., 0] if grey else img


def cv2_bytes(img, *params):
    ok, buf = cv2.imencode(".jpg", img, list(params))
    assert ok
    return buf.tobytes()


def assert_decodes_like_cv2(data):
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    got = read_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("quality", [50, 75, 92, 100])
def test_qualities(quality):
    assert_decodes_like_cv2(cv2_bytes(textured(37, 53), cv2.IMWRITE_JPEG_QUALITY, quality))


@pytest.mark.parametrize("sampling", sorted(SAMPLING))
def test_sampling(sampling):
    assert_decodes_like_cv2(cv2_bytes(textured(37, 53, seed=1), cv2.IMWRITE_JPEG_QUALITY, 92,
                                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]))


def test_grey_is_replicated_to_three_channels():
    data = cv2_bytes(textured(37, 53, grey=True), cv2.IMWRITE_JPEG_QUALITY, 92)
    assert_decodes_like_cv2(data)
    got = read_jpeg(data)
    assert (got[..., 0] == got[..., 1]).all() and (got[..., 1] == got[..., 2]).all()


@pytest.mark.parametrize("sampling,interval", [("420", 1), ("420", 3), ("444", 7), ("422", 2)])
def test_restart_intervals(sampling, interval):
    data = cv2_bytes(textured(45, 61, seed=2), cv2.IMWRITE_JPEG_QUALITY, 92,
                     cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                     cv2.IMWRITE_JPEG_RST_INTERVAL, interval)
    assert b"\xff\xdd" in data and b"\xff\xd0" in data
    assert_decodes_like_cv2(data)


@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (37, 53), (1002, 1000)])
def test_sizes(shape):
    assert_decodes_like_cv2(cv2_bytes(textured(*shape, seed=3), cv2.IMWRITE_JPEG_QUALITY, 92))


def test_fake_h36m_frame_file(tmp_path):
    """A frame of scripts/make_fake_h36m.py as it writes it (1002x1000,
    quality 92), read from the file as cv2.imread reads it."""
    from scripts.make_fake_h36m import render_frame

    from epipolar_transformers_tpu.ops.synthetic_render import joint_colors

    rng = np.random.RandomState(0)
    frame = render_frame(rng.uniform(200, 800, (17, 2)), joint_colors(17), (1000, 1000),
                         sigma=10.0)
    path = str(tmp_path / "frame.jpg")
    cv2.imwrite(path, frame, [cv2.IMWRITE_JPEG_QUALITY, 92])
    want = cv2.imread(path, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
    np.testing.assert_array_equal(read_jpeg(path), want)


@settings(max_examples=25, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40), quality=st.integers(1, 100),
       sampling=st.sampled_from(sorted(SAMPLING)), interval=st.integers(0, 5),
       grey=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_drawn_images(h, w, quality, sampling, interval, grey, seed):
    img = np.random.RandomState(seed).randint(0, 256, (h, w) if grey else (h, w, 3))
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_RST_INTERVAL, interval]
    if not grey:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    assert_decodes_like_cv2(cv2_bytes(img.astype(np.uint8), *params))


def test_progressive_raises_naming_the_file(tmp_path):
    path = tmp_path / "progressive.jpg"
    path.write_bytes(cv2_bytes(textured(16, 16), cv2.IMWRITE_JPEG_PROGRESSIVE, 1))
    with pytest.raises(JpegError, match="progressive.jpg: progressive JPEG"):
        read_jpeg(str(path))


@pytest.mark.parametrize("data,match", [
    (b"\x89PNG\r\n\x1a\n", "not a JPEG"),
    (b"\xff\xd8\xff\xc0\x00\x0b\x0c\x00\x10\x00\x10\x01\x01\x11\x00", "12-bit"),
    (b"\xff\xd8\xff\xc0\x00\x14\x08\x00\x10\x00\x10\x04" + bytes(12), "4 components"),
    (b"\xff\xd8\xff\xc9\x00\x02", "arithmetic"),
])
def test_other_files_raise(data, match):
    with pytest.raises(JpegError, match=match):
        read_jpeg(data, name="x.jpg")


@pytest.mark.parametrize("quality", [50, 75, 92, 100])
@pytest.mark.parametrize("shape", [(1, 1), (17, 16), (37, 53)])
def test_encoder(quality, shape, tmp_path):
    """write_jpeg's files: cv2 and read_jpeg decode them alike, and their
    PSNR to the source is within PSNR_SLACK_DB of cv2's own 4:2:0 file at
    that quality (above 1x1, where one sample holds no signal)."""
    src = textured(*shape, seed=4)
    path = str(tmp_path / "out.jpg")
    write_jpeg(path, src, quality)
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(read_jpeg(path), want)
    if shape != (1, 1):
        theirs = cv2.imdecode(np.frombuffer(cv2_bytes(src, cv2.IMWRITE_JPEG_QUALITY, quality),
                                            np.uint8), cv2.IMREAD_COLOR)
        assert psnr(want, src) > psnr(theirs, src) - PSNR_SLACK_DB


def test_encoder_on_a_fake_frame():
    """A 1002x1000 fake H36M frame at quality 92: bit-equal decodes, within
    40 dB of its source."""
    from scripts.make_fake_h36m import render_frame

    from epipolar_transformers_tpu.ops.synthetic_render import joint_colors

    frame = render_frame(np.random.RandomState(1).uniform(200, 800, (17, 2)),
                         joint_colors(17), (1000, 1000), sigma=10.0)
    data = encode_jpeg(frame, 92)
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(read_jpeg(data), want)
    assert psnr(want, frame) > 40.0


def _segments(data, marker):
    out, pos = [], 2
    while pos < len(data) and data[pos] == 0xFF and data[pos + 1] != 0xDA:
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] == marker:
            out.append(data[pos + 4:pos + 2 + length])
        pos += 2 + length
    return out


@pytest.mark.parametrize("quality", [10, 50, 92, 100])
def test_tables_are_libjpegs(quality):
    """The encoder's quantisation tables are those libjpeg scales for the
    quality, and its Huffman tables libjpeg's standard ones."""
    src = textured(16, 16)
    ours, theirs = encode_jpeg(src, quality), cv2_bytes(src, cv2.IMWRITE_JPEG_QUALITY, quality)
    for marker in (0xDB, 0xC4):  # DQT, DHT
        assert b"".join(_segments(ours, marker)) == b"".join(_segments(theirs, marker))
    zig = np.frombuffer(_segments(theirs, 0xDB)[0][1:65], np.uint8)
    assert sorted(zig.tolist()) == sorted(quality_tables(quality)[0].tolist())
