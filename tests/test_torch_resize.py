"""``ops/resize`` against ``cv2.resize`` and the C PNG un-filter against
its numpy twin, on the CPU.

- ``resize_linear_u8`` (INTER_LINEAR, u8 BGR) and ``resize_nearest``
  (INTER_NEAREST, u16 carried in int32) are bitwise equal to cv2 on the
  common camera profiles resized to 640 wide, other downscales, exact 2x
  downscales (cv2's INTER_AREA fast path), upscales of one axis and of
  both (the 2-D upscale rule of the module docstring), and random sizes.
- ``io/png._unfilter`` (``csrc/png_unfilter.c``, built at first use) is
  bitwise equal to ``_unfilter_plain`` on all five filter types and rows
  mixing them, at bpp 1, 2, 3, 4, 6 and 8; ``read_png`` reads hand-built
  Average- and Paeth-filtered files as ``cv2.imread`` does.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from fealess_tpu_torch.io import png
from fealess_tpu_torch.ops import _build
from fealess_tpu_torch.ops.resize import (resize_host, resize_linear_u8,
                                          resize_nearest)
from tests.test_torch_io import _encode_png

torch.set_num_threads(1)

# (source w, h) -> (target w, h)
_SHAPES = [
    # camera profiles to the 640 processing width (h = round(H * 640 / W))
    ((1280, 960), (640, 480)), ((1280, 720), (640, 360)),
    ((1920, 1080), (640, 360)), ((848, 480), (640, 362)),
    ((1024, 768), (640, 480)), ((1000, 700), (640, 448)),
    ((1280, 800), (640, 400)),
    # other downscales, 2x exact and not
    ((640, 480), (480, 360)), ((480, 270), (240, 135)),
    ((641, 479), (320, 240)),
    # 2-D upscales
    ((320, 240), (640, 480)), ((300, 240), (641, 480)),
    ((320, 240), (641, 480)), ((120, 81), (240, 162)), ((7, 5), (640, 480)),
    # one axis up, the other down or kept
    ((320, 240), (640, 240)), ((320, 240), (320, 480)),
    ((320, 240), (640, 200)), ((320, 240), (200, 480)),
    # degenerate sizes
    ((1, 1), (3, 3)), ((640, 480), (1, 1)), ((2, 2), (5, 5)),
]


def _check_resize(src_wh, dst_wh, rng, channels=3):
    (sw, sh), (dw, dh) = src_wh, dst_wh
    img = rng.integers(0, 256, (sh, sw, channels), dtype=np.uint8)
    want = cv2.resize(img, (dw, dh)).reshape(dh, dw, channels)
    got = resize_linear_u8(torch.from_numpy(img), (dw, dh))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want,
                                  err_msg=f"{src_wh} -> {dst_wh}")
    depth = rng.integers(0, 65536, (sh, sw), dtype=np.uint16)
    want = cv2.resize(depth, (dw, dh), interpolation=cv2.INTER_NEAREST)
    got = resize_nearest(torch.from_numpy(depth.astype(np.int32)), (dw, dh))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32),
                                  err_msg=f"{src_wh} -> {dst_wh}")
    np.testing.assert_array_equal(resize_host(depth, (dw, dh), nearest=True),
                                  want)


@pytest.mark.parametrize("src_wh,dst_wh", _SHAPES,
                         ids=[f"{a[0]}x{a[1]}-{b[0]}x{b[1]}"
                              for a, b in _SHAPES])
def test_resize_matches_cv2(src_wh, dst_wh):
    _check_resize(src_wh, dst_wh, np.random.default_rng(sum(src_wh + dst_wh)))


@pytest.mark.parametrize("seed", range(6))
def test_resize_random_sizes_match_cv2(seed):
    """25 random (source, target) pairs a seed, up to 300 pixels a side,
    with 1, 3 or 4 channels."""
    rng = np.random.default_rng(100 + seed)
    for i in range(25):
        sw, sh, dw, dh = (int(v) for v in rng.integers(1, 300, 4))
        _check_resize((sw, sh), (dw, dh), rng, channels=(3, 1, 4)[i % 3])


def test_resize_same_size_and_refusals():
    """The target size copies (as cv2 does); a non-u8 or 2-D colour image
    is refused."""
    img = torch.arange(24, dtype=torch.uint8).reshape(2, 4, 3)
    out = resize_linear_u8(img, (4, 2))
    assert torch.equal(out, img) and out.data_ptr() != img.data_ptr()
    with pytest.raises(ValueError):
        resize_linear_u8(img.to(torch.int32), (2, 1))
    with pytest.raises(ValueError):
        resize_linear_u8(img[:, :, 0], (2, 1))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4],
                                     [4, 3, 2, 1, 0, 3, 4]])
def test_unfilter_c_matches_twin(bpp, filters):
    """Random filtered bytes (each row led by its filter type) at widths
    of 1, 3 and 17 pixels (a PNG row is always whole pixels: sub-byte
    depths have bpp 1)."""
    rng = np.random.default_rng(bpp * 31 + len(filters))
    for h, stride in ((9, 17 * bpp), (4, 3 * bpp), (1, bpp), (6, bpp)):
        raw = rng.integers(0, 256, (h, stride + 1), dtype=np.uint8)
        raw[:, 0] = [filters[r % len(filters)] for r in range(h)]
        np.testing.assert_array_equal(
            png._unfilter(raw, h, stride, bpp),
            png._unfilter_plain(raw, h, stride, bpp))


def test_unfilter_c_refuses_bad_filter_and_build_is_cached():
    raw = np.zeros((3, 7), np.uint8)
    raw[1, 0] = 5
    with pytest.raises(png.DecodeError, match="filter type 5"):
        png._unfilter(raw, 3, 6, 3)
    with pytest.raises(png.DecodeError, match="filter type 5"):
        png._unfilter_plain(raw, 3, 6, 3)
    so = _build.build_host("png_unfilter")
    assert so.exists() and so.parent == _build.BUILD_DIR
    assert _build.build_host("png_unfilter") == so


def test_build_host_raises_on_failure(monkeypatch, tmp_path):
    """A source that does not compile raises; nothing falls back."""
    (tmp_path / "broken.c").write_text("int f( {\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed"):
        _build.build_host("broken")


@pytest.mark.parametrize("filters", [[3], [4], [4, 3]])
@pytest.mark.parametrize("kind", ["rgb8", "rgb16", "gray8", "gray16"])
def test_read_png_average_paeth_matches_cv2(tmp_path, kind, filters):
    """Files whose rows use the Average and Paeth filters, as libpng's
    adaptive writer emits them, read as cv2.imread reads them
    (IMREAD_UNCHANGED and IMREAD_COLOR)."""
    rng = np.random.default_rng(len(kind) + sum(filters))
    shape = (23, 37, 3) if kind.startswith("rgb") else (23, 37)
    top = 65536 if kind.endswith("16") else 256
    img = rng.integers(0, top, shape).astype(
        np.uint16 if top > 256 else np.uint8)
    path = str(tmp_path / f"{kind}.png")
    with open(path, "wb") as f:
        f.write(_encode_png(img, filters))
    for color, flag in ((False, cv2.IMREAD_UNCHANGED),
                        (True, cv2.IMREAD_COLOR)):
        want = cv2.imread(path, flag)
        got = png.read_png(path, color=color)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_read_png_paeth_frame_matches_cv2(tmp_path):
    """A 640x480 RGB frame with Paeth rows (the slow case of the numpy
    un-filter) reads as cv2.imread reads it."""
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
    path = os.path.join(str(tmp_path), "paeth.png")
    with open(path, "wb") as f:
        f.write(_encode_png(img, [4]))
    np.testing.assert_array_equal(png.read_png(path, color=True),
                                  cv2.imread(path))
