"""Write ``tests/data/torch_frames/``: the image files that
``chip_smoke.py`` phase 7d decodes on the card, where there is no cv2,
and the values it holds them to, taken from cv2 and the JAX package here.

    python tests/make_torch_frames.py

- small JPEG and BMP files (every sampling factor cv2 writes,
  progressive, restart markers, gray, EXIF orientations 6 and 8, odd
  sizes, a file cut short, JPEG data under a ``.png`` name, colour and
  gray files with their DHT segments cut, as Motion JPEG frames come,
  which libjpeg reads with its standard tables; BMP 8, 24
  and 32 bits from cv2, RLE8, RLE4 and top-down built by hand), and a
  series of three 640x480 frames of the fixture scene
  (``series/gray/<i>.png`` holding JPEG data: baseline 4:2:0 q95,
  progressive q95, and pan frame 2 at 4:4:4 q90 with restart markers);
- ``digests.json``: for each file and each flag (-1, 0, 1) the shape and
  the sha256 of ``cv2.imread``'s array;
- ``recon.json``: the JAX CLI's ``recon`` lines on that series with the
  fixture's features (depth written by the fixture's rule, x10 as u16
  PNG), with the default ICP settings ("a") and with iterations forced to
  the cap ("b", ``chip_smoke.FORCED``), and the JAX engine's match (x, y)
  on each frame, which the lines do not print.

``tests/test_torch_imfile.py`` holds the digests to cv2 here, so they
cannot go stale.  The BMP builders are shared with that test.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "torch_frames")
SERIES_FRAMES = 3
FLAGS = (-1, 0, 1)
# chip_smoke.FORCED: ICP iterations forced to the cap
FORCED = {"icp_dist_mean_threshold": 0.0, "icp_dist_diff_threshold": -1e30}


def build_bmp(w: int, h: int, bpp: int, pixels: bytes, comp: int = 0,
              palette=None, topdown: bool = False, masks=None,
              hsize: int = 40) -> bytes:
    """A BMP file: ``pixels`` as stored (rows padded, bottom-up unless
    ``topdown``), a ``hsize``-byte header (12: OS/2), ``palette`` as
    (n, 4) B G R x, ``masks`` (R, G, B) after a 40-byte header."""
    pal = b""
    if palette is not None:
        pal = np.asarray(palette, np.uint8)
        pal = (pal[:, :3] if hsize == 12 else pal).tobytes()
    extra = b"" if masks is None else struct.pack("<III", *masks)
    if hsize == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bpp)
    else:
        n = 0 if palette is None else len(palette)
        info = struct.pack("<IiiHHIIiiII", hsize, w, -h if topdown else h, 1,
                           bpp, comp, len(pixels), 2835, 2835, n, 0)
        info += bytes(hsize - 40)
    off = 14 + len(info) + len(extra) + len(pal)
    return (b"BM" + struct.pack("<IHHI", off + len(pixels), 0, 0, off)
            + info + extra + pal + pixels)


def padded_rows(rows, pitch: int) -> bytes:
    return b"".join(r + bytes(pitch - len(r)) for r in rows)


def rle8(idx: np.ndarray) -> bytes:
    """RLE8 of index rows (in file order): runs of 3 or more encoded,
    shorter stretches in absolute mode (single pixels as runs of 1), an
    end of line after each row and an end of bitmap."""
    out = b""
    for row in idx.tolist():
        i, w = 0, len(row)
        while i < w:
            j = i
            while j < w and row[j] == row[i] and j - i < 255:
                j += 1
            if j - i >= 3:
                out += bytes([j - i, row[i]])
                i = j
                continue
            k = min(w, i + 20)
            if k - i < 3:
                out += bytes([1, row[i]])
                i += 1
                continue
            out += bytes([0, k - i]) + bytes(row[i:k]) + bytes((k - i) % 2)
            i = k
        out += b"\0\0"
    return out[:-2] + b"\0\1"


def rle4(idx: np.ndarray) -> bytes:
    """RLE4 of index rows (in file order): alternating pairs encoded,
    other stretches of up to 9 in absolute mode, an end of line after
    each row and an end of bitmap."""
    out = b""
    for row in idx.tolist():
        i, w = 0, len(row)
        while i < w:
            if i + 4 <= w and row[i] == row[i + 2] and \
                    row[i + 1] == row[i + 3]:
                j = i
                while j + 2 <= w and row[j] == row[i] and \
                        row[j + 1] == row[i + 1] and j - i < 250:
                    j += 2
                out += bytes([j - i, (row[i] << 4) | row[i + 1]])
                i = j
                continue
            k = min(w, i + 9)
            n = k - i
            if n < 3:
                out += bytes([n, (row[i] << 4) | (row[i + 1] if n > 1
                                                  else 0)])
                i = k
                continue
            vals = row[i:k] + [0]
            packed = bytes((vals[2 * t] << 4) | vals[2 * t + 1]
                           for t in range((n + 1) // 2))
            out += bytes([0, n]) + packed + bytes(len(packed) % 2)
            i = k
        out += b"\0\0"
    return out[:-2] + b"\0\1"


def with_exif(jpg: bytes, orientation: int, order: str = "II") -> bytes:
    """``jpg`` with an Exif APP1 segment right after SOI whose first IFD
    holds one entry, the orientation (SHORT), in byte order ``order``."""
    e = "<" if order == "II" else ">"
    tiff = (order.encode() + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x112, 3, 1, orientation, 0)
            + struct.pack(e + "I", 0))
    body = b"Exif\0\0" + tiff
    return (jpg[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body
            + jpg[2:])


def strip_dht(jpg: bytes) -> bytes:
    """``jpg`` without its DHT segments (a Motion JPEG frame as a camera
    streams it: the decoder supplies the standard Huffman tables)."""
    blob = bytearray(jpg)
    while (at := blob.find(b"\xff\xc4")) >= 0:
        length = struct.unpack(">H", blob[at + 2:at + 4])[0]
        del blob[at:at + 2 + length]
    return bytes(blob)


def smooth_image(rng, h: int, w: int, channels: int = 3) -> np.ndarray:
    """Seeded noise, blurred so that the chroma is smooth."""
    import cv2
    shape = (h, w, channels) if channels > 1 else (h, w)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    if min(h, w) > 3:
        img = cv2.GaussianBlur(img, (5, 5), 2)
    return img


def small_files() -> dict:
    """name -> bytes of the small JPEG and BMP files."""
    import cv2
    rng = np.random.default_rng(18)
    img = smooth_image(rng, 37, 53)
    sf = cv2.IMWRITE_JPEG_SAMPLING_FACTOR

    def jpg(image, *params):
        return cv2.imencode(".jpg", image, list(params))[1].tobytes()

    files = {
        f"s{name}.jpg": jpg(img, cv2.IMWRITE_JPEG_QUALITY, q, sf, code)
        for name, code, q in (
            ("411", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411, 90),
            ("420", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, 95),
            ("422", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422, 100),
            ("440", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440, 75),
            ("444", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, 50))}
    files["progressive.jpg"] = jpg(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                   cv2.IMWRITE_JPEG_OPTIMIZE, 1)
    files["restart.jpg"] = jpg(img, cv2.IMWRITE_JPEG_RST_INTERVAL, 1)
    files["gray.jpg"] = jpg(img[:, :, 1])
    files["gray_progressive.jpg"] = jpg(img[:, :, 2],
                                        cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    files["exif6.jpg"] = with_exif(jpg(img), 6)
    files["exif8.jpg"] = with_exif(jpg(img), 8, "MM")
    files["odd_1x1.jpg"] = jpg(smooth_image(rng, 1, 1))
    files["odd_7x9.jpg"] = jpg(smooth_image(rng, 7, 9))
    files["odd_17x33.jpg"] = jpg(smooth_image(rng, 17, 33), sf,
                                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411)
    whole = jpg(smooth_image(rng, 64, 80), cv2.IMWRITE_JPEG_QUALITY, 95)
    files["truncated.jpg"] = whole[:len(whole) * 3 // 5]
    files["jpeg_named.png"] = jpg(img, cv2.IMWRITE_JPEG_QUALITY, 80)
    # cv2 reads no progressive file without DHT: sequential ones only
    files["default_tables.jpg"] = strip_dht(
        jpg(img, cv2.IMWRITE_JPEG_RST_INTERVAL, 2))
    files["default_tables_gray.jpg"] = strip_dht(jpg(img[:, :, 0]))
    files["bmp8.bmp"] = cv2.imencode(".bmp", img[:, :, 0])[1].tobytes()
    files["bmp24.bmp"] = cv2.imencode(".bmp", img)[1].tobytes()
    files["bmp32.bmp"] = cv2.imencode(
        ".bmp", np.dstack([img, img[:, :, :1]]))[1].tobytes()
    pal = rng.integers(0, 256, (256, 4))
    idx = rng.integers(0, 4, (37, 53))
    idx[:, :20] = 3
    files["rle8.bmp"] = build_bmp(53, 37, 8, rle8(idx), comp=1, palette=pal)
    idx = rng.integers(0, 16, (37, 53))
    idx[:, 10:30] = 5
    files["rle4.bmp"] = build_bmp(53, 37, 4, rle4(idx), comp=2,
                                  palette=pal[:16])
    px = img[:, :, ::-1]                   # RGB bytes stored as B, G, R
    files["topdown.bmp"] = build_bmp(
        53, 37, 24, padded_rows([r.tobytes() for r in px], (53 * 3 + 3) & -4),
        topdown=True)
    return files


def series_files() -> dict:
    """series/gray/<i>.png -> JPEG bytes of the fixture's pan frames."""
    import cv2
    sys.path.insert(0, REPO)
    from fealess_tpu_torch.apps import fixture
    from fealess_tpu_torch.io.png import read_png
    bgr = read_png(os.path.join(fixture.FIXTURE, "scene_bgr.png"))
    depth = read_png(os.path.join(fixture.FIXTURE, "scene_depth.png"))
    frames = fixture.pan(bgr, depth, SERIES_FRAMES)
    params = ([cv2.IMWRITE_JPEG_QUALITY, 95],
              [cv2.IMWRITE_JPEG_QUALITY, 95, cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
              [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
               cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
               cv2.IMWRITE_JPEG_RST_INTERVAL, 4])
    # frames 0 and 1 are the scene itself (baseline and progressive)
    sources = (frames[0][0], frames[0][0], frames[2][0])
    return {f"series/gray/{i}.png": cv2.imencode(".jpg", src, p)[1].tobytes()
            for i, (src, p) in enumerate(zip(sources, params))}


def series_depths() -> list:
    """The series' depth frames as the fixture writes them (x10, u16)."""
    sys.path.insert(0, REPO)
    from fealess_tpu_torch.apps import fixture
    from fealess_tpu_torch.io.png import read_png
    bgr = read_png(os.path.join(fixture.FIXTURE, "scene_bgr.png"))
    depth = read_png(os.path.join(fixture.FIXTURE, "scene_depth.png"))
    frames = fixture.pan(bgr, depth, SERIES_FRAMES)
    src = (frames[0][1], frames[0][1], frames[2][1])
    return [(d.astype(np.uint32) * 10).astype(np.uint16) for d in src]


def digest(img: np.ndarray) -> list:
    return [list(img.shape), hashlib.sha256(
        np.ascontiguousarray(img).tobytes()).hexdigest()]


def cv2_digests(directory: str, names) -> dict:
    import cv2
    return {name: {str(f): digest(cv2.imread(os.path.join(directory, name),
                                             f)) for f in FLAGS}
            for name in names}


def jax_recon(series: str, frames: int = SERIES_FRAMES) -> dict:
    """The JAX CLI's recon lines on ``series`` in settings a and b, and
    the JAX engine's match on each of its ``frames`` frames."""
    import contextlib
    import io

    import jax
    jax.config.update("jax_platforms", "cpu")
    from fealess_tpu.apps import cli as jax_cli
    sys.path.insert(0, REPO)
    from fealess_tpu_torch.apps import fixture

    features = os.path.join(fixture.FIXTURE, "features")
    build = jax_cli._engine_for
    out = {}
    for setting in ("a", "b"):
        def engine_for(args, width, height, forced=setting == "b"):
            eng = build(args, width, height)
            for name, value in FORCED.items() if forced else ():
                eng.set_advanced_param(name, value)
            return eng

        jax_cli._engine_for = engine_for
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                rc = jax_cli.main(["recon", features, "--series", series])
        finally:
            jax_cli._engine_for = build
        assert rc == 0
        out[setting] = [json.loads(ln) for ln in buf.getvalue().splitlines()
                        if ln.startswith("{")]
    # the match (x, y) of each frame, which the lines do not print: the
    # JAX engine on cv2's decode of the frame
    import cv2
    from fealess_tpu.engine import CamIntrinsics, ObjReco
    eng = ObjReco.create("LmICP")
    eng.add_obj(features)
    cam = CamIntrinsics(608.0, 608.0, 320.0, 240.0, 640, 480)
    out["match"] = []
    for i in range(frames):
        bgr = cv2.imread(os.path.join(series, "gray", f"{i}.png"))
        depth = cv2.imread(os.path.join(series, "depth", f"{i}.png"),
                           cv2.IMREAD_UNCHANGED)
        mm = np.clip(np.rint(depth * 0.1), 0, 65535).astype(np.uint16)
        res = eng.recognition(bgr, mm, cam)
        out["match"].append([float(v) for v in res[0].match_rect[:2]])
    return out


def main() -> None:
    import cv2
    files = {**small_files(), **series_files()}
    for name, blob in files.items():
        path = os.path.join(OUT, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(blob)
    with open(os.path.join(OUT, "digests.json"), "w") as f:
        json.dump(cv2_digests(OUT, sorted(files)), f, indent=1,
                  sort_keys=True)
        f.write("\n")
    with tempfile.TemporaryDirectory() as tmp:
        for sub in ("gray", "depth"):
            os.makedirs(os.path.join(tmp, sub))
        for i, d in enumerate(series_depths()):
            cv2.imwrite(os.path.join(tmp, "depth", f"{i}.png"), d)
            with open(os.path.join(tmp, "gray", f"{i}.png"), "wb") as f:
                f.write(files[f"series/gray/{i}.png"])
        recon = jax_recon(tmp)
    with open(os.path.join(OUT, "recon.json"), "w") as f:
        json.dump(recon, f, indent=1)
        f.write("\n")
    total = sum(len(b) for b in files.values())
    print(f"wrote {len(files)} files ({total} bytes) to {OUT}")


if __name__ == "__main__":
    main()
