"""Video files as ``cv2.VideoCapture`` reads them (the JAX reader's
source for a path that is not a directory), bit for bit, for the
container and codecs that ``cv2.VideoWriter`` writes and USB cameras
record: AVI (:mod:`~fealess_tpu_torch.io.avi`) holding Motion JPEG
(:mod:`~fealess_tpu_torch.io.mjpeg`: fourcc ``MJPG``, ``mjpg``, ``AVRn``,
``dmb1``) or FFV1 (:mod:`~fealess_tpu_torch.io.ffv1`: ``FFV1``, ``ffv1``).
Decoding stays on the host, as FFmpeg's does under cv2.

The container is found by content.  A path that does not exist, a file
of no container the port knows, or an AVI without a video stream raises
``OSError("cannot open video source ...")``, as the JAX reader raises
when ``cv2.VideoCapture`` does not open.  A container or codec cv2
reads and the port does not (MP4/MOV, Matroska/WebM, MPEG, raw Motion
JPEG; MPEG-4 Part 2 (``XVID``, ``mp4v``), H.264, HEVC, an interlaced
Motion JPEG (two fields a chunk), a frame kind
:mod:`~fealess_tpu_torch.io.mjpeg` or :mod:`~fealess_tpu_torch.io.ffv1`
does not read) raises :class:`UnsupportedVideo`, naming it: no frame cv2
would serve is dropped without a word.  A frame FFmpeg's decoder rejects
(``DecodeError``) is skipped, as cv2 skips a packet its decoder rejects.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from fealess_tpu_torch.io.avi import AviError, AviFile, is_avi
from fealess_tpu_torch.io.jpeg import UnsupportedImage
from fealess_tpu_torch.io.png import DecodeError

MJPEG_FOURCCS = (b"MJPG", b"mjpg", b"AVRn", b"dmb1")
FFV1_FOURCCS = (b"FFV1", b"ffv1")


class UnsupportedVideo(ValueError):
    """A video cv2 reads and the port does not: the message names the
    container or the codec."""


def _container(head: bytes) -> Optional[str]:
    """The name of a container cv2's FFmpeg opens and the port does not
    read, by its first bytes, or None."""
    if head[4:8] == b"ftyp" or head[4:8] in (b"moov", b"mdat", b"wide"):
        return "MP4/QuickTime (ISO base media)"
    if head[:4] == b"\x1aE\xdf\xa3":
        return "Matroska/WebM"
    if head[:3] == b"\xff\xd8\xff":
        return "raw Motion JPEG (JPEG images back to back)"
    if head[:4] in (b"\x00\x00\x01\xba", b"\x00\x00\x01\xb3"):
        return "MPEG program stream"
    if head[:1] == b"\x47" and len(head) > 188 and head[188:189] == b"\x47":
        return "MPEG transport stream"
    if head[:4] == b"OggS":
        return "Ogg"
    if head[:3] == b"FLV":
        return "FLV"
    if head[:4] == b"\x30\x26\xb2\x75":
        return "ASF/WMV"
    if head[:4] == b"RIFF":
        return f"RIFF {head[8:12]!r} (not AVI)"
    return None


def _codec(fourcc: bytes) -> str:
    names = {b"XVID": "MPEG-4 Part 2 (XVID)", b"xvid": "MPEG-4 Part 2 (xvid)",
             b"DIVX": "MPEG-4 Part 2 (DIVX)", b"DX50": "MPEG-4 Part 2 (DX50)",
             b"FMP4": "MPEG-4 Part 2 (FMP4)", b"mp4v": "MPEG-4 Part 2 (mp4v)",
             b"MP4V": "MPEG-4 Part 2 (MP4V)", b"H264": "H.264 (H264)",
             b"h264": "H.264 (h264)", b"avc1": "H.264 (avc1)",
             b"X264": "H.264 (X264)", b"HEVC": "HEVC (HEVC)",
             b"hev1": "HEVC (hev1)", b"hvc1": "HEVC (hvc1)",
             b"\0\0\0\0": "uncompressed (BI_RGB)"}
    return names.get(fourcc, f"fourcc {fourcc!r}")


class VideoReader:
    """Iterate the BGR u8 frames of the video file at ``path``."""

    def __init__(self, path: str):
        self.path = path
        try:
            with open(path, "rb") as f:
                head = f.read(200)
        except OSError as e:
            raise OSError(f"cannot open video source {path!r}") from e
        if not is_avi(head):
            kind = _container(head)
            if kind is None:
                raise OSError(f"cannot open video source {path!r}")
            raise UnsupportedVideo(f"{path}: {kind} is read by "
                                   f"cv2.VideoCapture but not by the port "
                                   f"(which reads AVI)")
        try:
            self._avi = AviFile(path)
        except AviError as e:        # no video stream, headers cut
            raise OSError(f"cannot open video source {path!r}: {e}") from e
        s = self._avi.stream
        # FFmpeg takes strf's compression, else strh's handler
        fourcc = s.compression
        if fourcc not in MJPEG_FOURCCS + FFV1_FOURCCS and \
                s.handler in MJPEG_FOURCCS + FFV1_FOURCCS:
            fourcc = s.handler
        self.fourcc = fourcc
        if fourcc not in MJPEG_FOURCCS + FFV1_FOURCCS:
            self._avi.close()
            raise UnsupportedVideo(
                f"{path}: AVI with {_codec(fourcc)} video is read by "
                f"cv2.VideoCapture but not by the port (which reads Motion "
                f"JPEG and FFV1)")
        self.width, self.height = s.width, abs(s.height)

    def __iter__(self) -> Iterator[np.ndarray]:
        if self.fourcc in FFV1_FOURCCS:
            yield from self._ffv1()
        else:
            yield from self._mjpeg()

    def _mjpeg(self) -> Iterator[np.ndarray]:
        from fealess_tpu_torch.io import mjpeg
        limited = False          # FFmpeg's cs_itu601 stays set once seen
        for i, data in enumerate(self._avi.frames()):
            what = f"{self.path} frame {i}"
            try:
                _, rows = mjpeg.header(data, what)
                now, later = mjpeg.itu601_comment(data)
                limited = limited or now
                # mjpegdec's test: a field is under 3/4 of the stream's
                # height
                if rows < self.height * 3 // 4:
                    raise UnsupportedImage(
                        f"interlaced Motion JPEG ({rows} rows a field, "
                        f"{self.height} a frame)")
                frame = mjpeg.decode_frame(data, not limited, what)
                limited = limited or later
            except UnsupportedImage as e:
                raise UnsupportedVideo(f"{what}: {e}") from None
            except DecodeError:
                continue
            yield frame

    def _ffv1(self) -> Iterator[np.ndarray]:
        from fealess_tpu_torch.io.ffv1 import FFV1Decoder
        s = self._avi.stream
        try:
            dec = FFV1Decoder(s.extradata, self.width, self.height,
                              self.path)
        except UnsupportedImage as e:
            raise UnsupportedVideo(str(e)) from None
        try:
            for data in self._avi.frames():
                try:
                    frame = dec.decode(data)
                except DecodeError:
                    continue
                yield frame
        finally:
            dec.close()

    def close(self) -> None:
        self._avi.close()

    def __enter__(self) -> "VideoReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
