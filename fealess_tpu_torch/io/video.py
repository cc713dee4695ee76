"""Video files, image files and printf patterns as ``cv2.VideoCapture``
reads them (the JAX reader's source for a path that is not a directory),
bit for bit and in cv2's number, for the containers and codecs listed
below, and what USB cameras record.  Decoding stays on the host, as
FFmpeg's does under cv2.  ``tests/test_torch_containers.py`` writes every
fourcc and container pair ``cv2.VideoWriter`` writes here and holds each
to one of three ends: read equal to cv2, refused naming a codec of
:data:`QUEUED_FOURCCS` or a container of :data:`QUEUED_CONTAINERS`
(ROADMAP's decoding and demuxing queues), or ``OSError`` where cv2 does
not open what its writer wrote.

Containers read, picked as FFmpeg picks its demuxer:

- a path with a printf field (``%d``, ``%0Nd``) and an image extension,
  or with a field and no file of its literal name, is an image2 sequence
  (:mod:`~fealess_tpu_torch.io.image2`: its first number in 0-4, its run
  of files, the codec by extension);
- otherwise the file's first bytes: AVI (:mod:`~fealess_tpu_torch.io.avi`),
  ISO base media: MP4 and MOV, fragmented (``.ismv``) or not
  (:mod:`~fealess_tpu_torch.io.isobmff`), Matroska and WebM
  (:mod:`~fealess_tpu_torch.io.matroska`), YUV4MPEG2
  (:mod:`~fealess_tpu_torch.io.y4m`), the MPEG video elementary stream
  (:mod:`~fealess_tpu_torch.io.mpegvideo`), MPEG program streams
  (``.mpg``, ``.vob``: :mod:`~fealess_tpu_torch.io.mpegps`), MPEG
  transport streams of 188-byte packets and BDAV's 192-byte ones
  (``.ts``, ``.m2ts``: :mod:`~fealess_tpu_torch.io.mpegts`), Ogg
  (:mod:`~fealess_tpu_torch.io.ogg`), FLV (:mod:`~fealess_tpu_torch.io.
  flv`), SWF (:mod:`~fealess_tpu_torch.io.swf`), ASF (``.asf``, ``.wmv``:
  :mod:`~fealess_tpu_torch.io.asf`),
  NUT (:mod:`~fealess_tpu_torch.io.nut`), or PNG, JPEG and BMP images:
  one image, PNG images back to back (``png_pipe``, split by FFmpeg's png
  parser) and JPEG images back to back under a name image2 does not take
  (raw Motion JPEG, split by FFmpeg's mjpeg parser).

Codecs read, each by its decoder:

- Motion JPEG (:mod:`~fealess_tpu_torch.io.mjpeg`): AVI fourcc ``MJPG``,
  ``mjpg``, ``AVRn``, ``dmb1``, ``jpeg``, ``LJPG`` (baseline JPEG as
  ``cv2.VideoWriter`` writes it); MP4 ``mp4v`` with object type 0x6C and
  ``jpeg``; Matroska ``V_MJPEG``; JPEG images and raw Motion JPEG;
- FFV1 (:mod:`~fealess_tpu_torch.io.ffv1`): AVI ``FFV1``, ``ffv1``; MP4
  ``FFV1``; Matroska ``V_FFV1``;
- raw video (:mod:`~fealess_tpu_torch.io.rawvideo`): yuv420p as AVI
  ``I420``, ``IYUV`` (``cv2.VideoWriter``'s fourcc 0) and ``YV12``, gray
  as ``Y800``, ``Y8  `` and ``GREY``, ``NV12`` and ``RGBA``, in AVI and
  in Matroska's ``V_UNCOMPRESSED``; ``RGBA`` in MOV; YUV4MPEG2's 4:2:0
  and ``Cmono``;
- PNG (:func:`~fealess_tpu_torch.io.image2.png_frame`): AVI ``MPNG``,
  ``PNG1``, ``png ``; MP4 ``mp4v`` with object type 0x6D and ``png ``;
  PNG images and pipes;
- Huffyuv (:mod:`~fealess_tpu_torch.io.huffyuv`): AVI ``HFYU``;
- MPEG-4 Part 2 (:mod:`~fealess_tpu_torch.io.mpeg4`): AVI ``mp4v``,
  ``MP4V``, ``XVID``, ``xvid``, ``FMP4``, ``DIVX``, ``DX50``, and
  GeoVision's ``GEOX`` and ``GEOV``, whose pictures FFmpeg turns upside
  down; MP4 ``mp4v`` with object type 0x20; Matroska ``V_MPEG4/ISO/SP``,
  ``ASP``, ``AP``; MPEG program and transport streams (stream type 0x10,
  or private data its probe takes), cut at its VOPs;
- VP8 (:mod:`~fealess_tpu_torch.io.vp8`): AVI ``VP80``; Matroska and
  WebM ``V_VP8``; Ogg's ``OVP80`` streams;
- VP9 (:mod:`~fealess_tpu_torch.io.vp9`): AVI ``VP90``; MP4 ``vp09``;
  Matroska and WebM ``V_VP9`` (a superframe's packet gives each frame it
  shows, a ``show_existing_frame`` packet its slot's frame again);
  enhanced FLV's ``vp09``;
- MPEG-2 (:mod:`~fealess_tpu_torch.io.mpeg2`): AVI ``mpg2``, ``MPEG``;
  MP4 ``mp4v`` with object types 0x60-0x65; MOV ``m2v1`` and the HDV,
  XDCAM and IMX tags (``xd5b``, ``mp2v``, ...); Matroska ``V_MPEG2``; the
  MPEG video elementary stream, and MPEG program and transport streams
  (stream types 0x01 and 0x02), cut into pictures alike (B pictures
  leave the decoder in display
  order, one anchor late; the last anchor comes from draining it after
  the last packet, as FFmpeg drains at the end of the file);
- H.263 (:mod:`~fealess_tpu_torch.io.h263`): AVI ``H263``, ``U263``;
  MOV ``h263`` and 3GP / 3G2 ``s263``;
- Sorenson Spark (:mod:`~fealess_tpu_torch.io.h263`): AVI ``FLV1``; MOV
  ``FLV1``; FLV's legacy codec id 2; SWF;
- MS MPEG-4 v2 (:mod:`~fealess_tpu_torch.io.msmpeg4`): AVI ``MP42``,
  ``DIV2``, and MOV with the same tags;
- MS MPEG-4 v3 (:mod:`~fealess_tpu_torch.io.msmpeg4`): AVI ``DIV3``,
  ``MP43``, ``DIV4``, ``DIV5``, ``DIV6``, ``MPG3``, ``AP41``, ``COL1``,
  ``COL0``, ``3IVD``; MOV ``3IVD``; Matroska ``V_MPEG4/MS/V3``;
- WMV7 (:mod:`~fealess_tpu_torch.io.msmpeg4`): AVI and MOV ``WMV1``;
- WMV8 (:mod:`~fealess_tpu_torch.io.wmv2`): AVI and MOV ``WMV2``, its
  settings the container's 4-byte extradata;
- BMP (:func:`~fealess_tpu_torch.io.image2.bmp_frame`): BMP images.

Matroska's ``V_MS/VFW/FOURCC``, ASF's and NUT's fourccs take the AVI
ones.  A path that does not exist, a file of no container cv2 knows, a
container without a video stream, or with none FFmpeg finds a codec for
(an MPEG program or transport stream of what ``cv2.VideoWriter`` writes
there for Motion JPEG, FFV1, raw video, VP8, ...), a stream whose decoder
does not open (corrupt extradata), a YUV4MPEG2 header FFmpeg refuses,
NUT headers whose checksums fail, an LZMA SWF (``ZWS``, which FFmpeg
does not know) and a pattern with no file at 0-4 raise
``OSError("cannot open video source ...")``, as the JAX reader raises when
``cv2.VideoCapture`` does not open.  A PAM image without a ``TUPLTYPE``
line (``cv2.imwrite``'s) under an image name opens and gives no frame,
as in cv2, whose image2 decoder refuses it.

A source cv2 reads and the port does not raises :class:`UnsupportedVideo`,
naming it:

- containers, by their first bytes: RealMedia and raw Dirac
  (:data:`QUEUED_CONTAINERS`); these are named even where cv2 then finds
  no stream it decodes in them;
- codecs: those of :data:`QUEUED_FOURCCS` (FFmpeg's Huffyuv variant, Ut
  Video, MagicYUV, JPEG-LS, ASUS V1 and V2, TIFF, Snow, Dirac, JPEG
  2000, RealVideo 1 and 2) and others no writer here writes
  (AV1, H.264, HEVC, uncompressed BI_RGB, VP8 in MP4, MPEG-1, ...);
- kinds inside a codec or container: edit lists that drop frames and
  Matroska with compressed blocks; a program stream map, ASF's
  compressed payloads, NUT's side data, encrypted or multitrack FLV tags
  and a PreviousTagSize that does not match its tag, MP4 fragments of
  another sample description, compressed SWF (``CWS``, which FFmpeg
  inflates losing bytes) and SWF's other codecs and bitmap tags; the
  tools :mod:`~fealess_tpu_torch.io.mpeg4`, :mod:`~fealess_tpu_torch.io.
  vp8`, :mod:`~fealess_tpu_torch.io.vp9`, :mod:`~fealess_tpu_torch.io.
  mpeg2`, :mod:`~fealess_tpu_torch.io.h263`, :mod:`~fealess_tpu_torch.
  io.msmpeg4` and :mod:`~fealess_tpu_torch.io.wmv2` refuse by name;
  YUV4MPEG2
  of other colour spaces, interlaced, or sited left or top-left at an odd
  height; images of other formats (TIFF, WebP, PNM, ...); the PNG and BMP kinds :mod:`~fealess_tpu_torch.io.image2`
  names (16-bit colour PNG, Adam7 PNG, 16-bit BMP, RLE deltas, BMP data
  ``cv2.imread`` cannot finish); JPEG images back to back under the
  image extension of another codec (cv2 decodes the first or none, as
  FFmpeg's probe of the first bytes finds the second image or not); an
  image sequence or pipe whose frames differ in size (cv2 scales them to
  the first's) or whose extension FFmpeg does not know (OpenCV's own
  CAP_IMAGES reader opens it); an interlaced Motion JPEG; a frame kind
  :mod:`~fealess_tpu_torch.io.mjpeg`, :mod:`~fealess_tpu_torch.io.ffv1`
  or :mod:`~fealess_tpu_torch.io.huffyuv` does not read.

No frame cv2 would serve is dropped without a word.  A packet the decoder
rejects (``DecodeError``) is where cv2's ``read`` first returns False:
iterating a :class:`VideoReader` ends there, as the JAX reader's loop
does.  A VP8 frame that FFmpeg stops part way (its end-of-data check) is
one too: cv2 returns it with the macroblocks left undecoded holding an
older buffer's pixels, which no reader can match; so is an MPEG-2 packet
cut short, whose missing macroblocks FFmpeg conceals.
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from fealess_tpu_torch.io import image2
from fealess_tpu_torch.io.asf import AsfError, AsfFile, UnsupportedAsf, is_asf
from fealess_tpu_torch.io.avi import AviError, AviFile, is_avi
from fealess_tpu_torch.io.flv import FlvError, FlvFile, UnsupportedFlv, is_flv
from fealess_tpu_torch.io.h263 import H263_FOURCCS, SORENSON_FOURCCS
from fealess_tpu_torch.io.imfile import image_format
from fealess_tpu_torch.io.isobmff import (Mp4Error, Mp4File, UnsupportedMp4,
                                          is_isobmff)
from fealess_tpu_torch.io.jpeg import UnsupportedImage
from fealess_tpu_torch.io.matroska import (CODEC_NAMES, MatroskaError,
                                           MkvFile, UnsupportedMatroska,
                                           is_ebml)
from fealess_tpu_torch.io.mpeg2 import CODEC_ID as MPEG2_CODEC_ID
from fealess_tpu_torch.io.mpeg2 import FOURCCS as MPEG2_FOURCCS
from fealess_tpu_torch.io.mpeg4 import FOURCCS as MPEG4_FOURCCS
from fealess_tpu_torch.io.mpegps import (MpegPsError, MpegPsFile,
                                         UnsupportedMpegPs, is_mpeg_ps)
from fealess_tpu_torch.io.mpegts import (MpegTsError, MpegTsFile,
                                         UnsupportedMpegTs, packet_layout)
from fealess_tpu_torch.io.mpegvideo import MpegVideoFile, is_mpeg_video
from fealess_tpu_torch.io.msmpeg4 import FOURCCS as MSMPEG4_FOURCCS
from fealess_tpu_torch.io.msmpeg4 import codec_of as msmpeg4_codec
from fealess_tpu_torch.io.nut import NutError, NutFile, UnsupportedNut, is_nut
from fealess_tpu_torch.io.ogg import OggError, OggFile, UnsupportedOgg, is_ogg
from fealess_tpu_torch.io.png import DecodeError
from fealess_tpu_torch.io.rawvideo import RAW_FOURCCS
from fealess_tpu_torch.io.swf import SwfError, SwfFile, UnsupportedSwf, is_swf
from fealess_tpu_torch.io.vp8 import CODEC_ID as VP8_CODEC_ID
from fealess_tpu_torch.io.vp8 import FOURCCS as VP8_FOURCCS
from fealess_tpu_torch.io.vp9 import CODEC_ID as VP9_CODEC_ID
from fealess_tpu_torch.io.vp9 import FOURCCS as VP9_FOURCCS
from fealess_tpu_torch.io.wmv2 import codec_of as wmv2_codec
from fealess_tpu_torch.io.y4m import UnsupportedY4m, Y4mError, Y4mFile, is_y4m

MJPEG_FOURCCS = (b"MJPG", b"mjpg", b"AVRn", b"dmb1", b"jpeg", b"LJPG")
FFV1_FOURCCS = (b"FFV1", b"ffv1")
PNG_FOURCCS = (b"MPNG", b"PNG1", b"png ")
HUFFYUV_FOURCCS = (b"HFYU",)
# imfile.image_format's names -> the decoder FFmpeg picks for the image
_IMAGE_CODECS = {"png": "png", "jpeg": "mjpeg", "bmp": "bmp"}


class UnsupportedVideo(ValueError):
    """A video cv2 reads and the port does not: the message names the
    container or the codec."""


def _container(head: bytes) -> Optional[str]:
    """The name of a container cv2's FFmpeg opens and the port does not
    read, by its first bytes (FFmpeg's probes, reduced to their
    signatures), or None."""
    if head[:4] in (b".RMF", b".RMP"):
        return "RealMedia"
    if is_swf(head):                 # io/swf reads or names these first
        return "SWF"
    if head[:4] == b"BBCD":
        return "raw Dirac"
    if head[:4] == b"RIFF":
        return f"RIFF {head[8:12]!r} (not AVI)"
    return None


# the containers cv2's FFmpeg opens that the port does not demux yet
# (ROADMAP's demuxing queue), as the refusals name them
QUEUED_CONTAINERS = ("RealMedia", "raw Dirac")


_FOURCC_NAMES = {
    b"H264": "H.264 (H264)",
    b"h264": "H.264 (h264)", b"avc1": "H.264 (avc1)",
    b"X264": "H.264 (X264)", b"HEVC": "HEVC (HEVC)",
    b"hev1": "HEVC (hev1)", b"hvc1": "HEVC (hvc1)",
    b"\0\0\0\0": "uncompressed (BI_RGB)"}
# the codecs cv2.VideoWriter writes that the port does not decode yet
# (ROADMAP's decoding queue), by the fourccs FFmpeg's AVI demuxer maps to
# them
QUEUED_FOURCCS = {
    "FFmpeg's Huffyuv variant": (b"FFVH", b"ffvh"),
    "Ut Video": (b"ULY0", b"ULY2", b"ULY4", b"ULRG", b"ULRA", b"ULH0",
                 b"ULH2", b"ULH4", b"UQY0", b"UQY2", b"UQRG", b"UQRA",
                 b"UMY2", b"UMY4", b"UMH2", b"UMH4"),
    "MagicYUV": (b"MAGY", b"M8RG", b"M8RA", b"M8G0", b"M8Y0", b"M8Y2",
                 b"M8Y4", b"M8YA"),
    "JPEG-LS": (b"MJLS",), "ASUS V1": (b"ASV1",), "ASUS V2": (b"ASV2",),
    "TIFF": (b"tiff", b"TIFF"), "Snow": (b"SNOW",), "Dirac": (b"drac",),
    "JPEG 2000": (b"MJ2C", b"mjp2", b"LJ2C", b"LJ2K", b"MJP2"),
    "RealVideo 1": (b"RV10",), "RealVideo 2": (b"RV20",)}
_FOURCC_NAMES.update({cc: f"{name} ({cc.decode()})"
                      for name, ccs in QUEUED_FOURCCS.items() for cc in ccs})


def _codec(fourcc: bytes) -> str:
    return _FOURCC_NAMES.get(fourcc, f"fourcc {fourcc!r}")


def fourcc_codec(fourcc: bytes) -> Optional[str]:
    """The port's decoder for an AVI / VfW fourcc, or None."""
    if fourcc in MJPEG_FOURCCS:
        return "mjpeg"
    if fourcc in FFV1_FOURCCS:
        return "ffv1"
    if fourcc in RAW_FOURCCS:
        return "rawvideo"
    if fourcc in PNG_FOURCCS:
        return "png"
    if fourcc in HUFFYUV_FOURCCS:
        return "huffyuv"
    if fourcc in MPEG4_FOURCCS:
        return "mpeg4"
    if fourcc in VP8_FOURCCS:
        return "vp8"
    if fourcc in VP9_FOURCCS:
        return "vp9"
    if fourcc in MPEG2_FOURCCS:
        return "mpeg2"
    if fourcc in H263_FOURCCS:
        return "h263"
    if fourcc in SORENSON_FOURCCS:
        return "flv1"
    return msmpeg4_codec(fourcc) or wmv2_codec(fourcc) or None


_CONTAINERS = ("AVI, MP4 and MOV (fragmented too), Matroska, YUV4MPEG2, "
               "the MPEG video elementary stream, MPEG program and "
               "transport streams, Ogg, FLV, ASF, NUT, image files and "
               "their pipes")
_READS = ("Motion JPEG, FFV1, raw I420 / IYUV / YV12 / gray / NV12 / RGBA, "
          "PNG, Huffyuv, MPEG-4 Part 2, VP8, VP9, MPEG-2, H.263, Sorenson "
          "Spark, MS MPEG-4 v2 and v3, WMV7 and WMV8")


def _pam_without_tuple_type(path: str) -> bool:
    """Whether ``path`` is a PAM image with no ``TUPLTYPE`` line (what
    ``cv2.imwrite`` writes), which FFmpeg's PNM header parser refuses,
    under a name whose extension image2 takes."""
    if image2.extension_codec(path) is None:
        return False
    with open(path, "rb") as f:
        head = f.read(4096)
    end = head.find(b"ENDHDR")
    return head.startswith(b"P7") and end > 0 and \
        b"TUPLTYPE" not in head[:end]


# what a demuxer refuses part way through the stream
_STREAM_REFUSALS = (UnsupportedAsf, UnsupportedNut)


class VideoReader:
    """Iterate the BGR u8 frames of the video file, image file or printf
    pattern at ``path`` (see the module docstring)."""

    def __init__(self, path: str):
        self.path = path
        self.container = ""
        self.codec = ""
        self.fourcc = b""
        self.width = self.height = 0
        self.extradata = b""
        self.raw_format = ""
        self.full_range = False
        self._close: Callable[[], None] = lambda: None
        self._packets: Callable[[], Iterator[bytes]] = lambda: iter(())
        self._image2 = False
        self._open(path)
        try:                   # FFmpeg opens the decoder with the stream
            self._decoder()[1]()
        except BaseException:
            self.close()
            raise

    def _open(self, path: str) -> None:
        # image2 takes a pattern by its name alone where the extension is
        # an image one; FFmpeg opens any other path by content
        if image2.is_pattern(path) and (image2.extension_codec(path) or
                                        not os.path.isfile(path)):
            self._open_pattern(path)
            return
        try:
            with open(path, "rb") as f:
                head = f.read(256)
        except OSError as e:
            raise OSError(f"cannot open video source {path!r}") from e
        image = image_format(head[:16])
        if is_avi(head):
            self._open_avi(path)
        elif is_isobmff(head):
            self._open_mp4(path)
        elif is_ebml(head):
            self._open_mkv(path)
        elif is_y4m(head):
            self._open_y4m(path)
        elif is_mpeg_video(head):
            self.container = "MPEG video elementary stream"
            self._set("mpeg2", b"", 0, 0, b"", MpegVideoFile(path))
        elif is_mpeg_ps(head):
            self._open_stream(path, "MPEG program stream", MpegPsFile,
                              MpegPsError, UnsupportedMpegPs)
        elif packet_layout(head) is not None:
            self._open_stream(path, "MPEG transport stream", MpegTsFile,
                              MpegTsError, UnsupportedMpegTs)
        elif is_ogg(head):
            self._open_stream(path, "Ogg", OggFile, OggError, UnsupportedOgg)
        elif is_flv(head):
            self._open_stream(path, "FLV", FlvFile, FlvError, UnsupportedFlv)
        elif is_swf(head):
            self._open_stream(path, "SWF", SwfFile, SwfError, UnsupportedSwf)
        elif is_asf(head):
            self._open_fourcc(path, "ASF", AsfFile, AsfError, UnsupportedAsf)
        elif is_nut(head):
            self._open_fourcc(path, "NUT", NutFile, NutError, UnsupportedNut)
        elif image in _IMAGE_CODECS:          # the image pipes' probes
            self._open_image(path, _IMAGE_CODECS[image])
        elif image == "PNM" and _pam_without_tuple_type(path):
            # image2 takes the name's image extension and its decoder
            # refuses the file: cv2 opens it and reads no frame
            self.codec, self._image2 = "pam", True
        elif image:
            raise UnsupportedVideo(
                f"{path}: a {image} image is read by cv2.VideoCapture but "
                f"not by the port (which reads PNG, JPEG and BMP images)")
        else:
            self._refuse_other(path, head)

    # ---- demuxers ----

    def _open_pattern(self, path: str) -> None:
        codec = image2.extension_codec(path)
        if codec is None:
            # FFmpeg does not take the path; OpenCV's own image sequence
            # reader tries numbers 0 and 1
            if any(os.path.isfile(image2.frame_filename(path, n))
                   for n in (0, 1)):
                raise UnsupportedVideo(
                    f"{path}: an image sequence whose extension FFmpeg's "
                    f"image2 does not know is read by cv2.VideoCapture "
                    f"through OpenCV's CAP_IMAGES reader, not by the port")
            raise OSError(f"cannot open video source {path!r}")
        files = list(image2.sequence_files(path))
        if not files:
            raise OSError(f"cannot open video source {path!r}")
        if codec not in image2.DECODED:
            raise UnsupportedVideo(
                f"{path}: an image sequence of {codec} files is read by "
                f"cv2.VideoCapture but not by the port (which reads PNG, "
                f"JPEG and BMP)")
        self.codec, self._image2 = codec, True

        def packets() -> Iterator[bytes]:
            for name in files:
                try:
                    with open(name, "rb") as f:
                        data = f.read()
                except OSError:       # gone since the open: the stream ends
                    return
                yield data
        self._packets = packets

    def _open_image(self, path: str, codec: str) -> None:
        with open(path, "rb") as f:
            data = f.read()
        ext = image2.extension_codec(path)
        packets = [data]
        if codec == "png":               # png_pipe outbids image2's probe
            packets = image2.png_packets(data)
        elif codec == "mjpeg" and ext is None:   # FFmpeg's mjpeg demuxer
            packets = image2.jpeg_packets(data)
        elif codec == "mjpeg" and ext != "mjpeg" and \
                image2.jpeg_frame_end(data) >= 0:
            raise UnsupportedVideo(
                f"{path}: raw Motion JPEG (JPEG images back to back) under "
                f"the image extension of {ext}: cv2 decodes the first image "
                f"or none, as FFmpeg's probe of the file's first bytes "
                f"finds the second image or not")
        self.codec, self._image2 = codec, True
        self._packets = lambda: iter(packets)

    def _open_avi(self, path: str) -> None:
        try:
            avi = AviFile(path)
        except AviError as e:        # no video stream, headers cut
            raise OSError(f"cannot open video source {path!r}: {e}") from e
        s = avi.stream
        # FFmpeg takes strf's compression, else strh's handler
        fourcc = s.compression
        if fourcc_codec(fourcc) is None and fourcc_codec(s.handler):
            fourcc = s.handler
        if fourcc_codec(fourcc) is None:
            avi.close()
            raise UnsupportedVideo(
                f"{path}: AVI with {_codec(fourcc)} video is read by "
                f"cv2.VideoCapture but not by the port (which reads "
                f"{_READS})")
        self.container = "AVI"
        self._set(fourcc_codec(fourcc), fourcc, s.width, abs(s.height),
                  s.extradata, avi)

    def _open_y4m(self, path: str) -> None:
        try:
            y4m = Y4mFile(path)
        except Y4mError as e:
            raise OSError(f"cannot open video source {path!r}: {e}") from e
        except UnsupportedY4m as e:
            raise UnsupportedVideo(f"{e}: read by cv2.VideoCapture but not "
                                   f"by the port") from None
        self.container = "YUV4MPEG2"
        self._set("rawvideo", b"", y4m.width, y4m.height, b"", y4m)
        self.raw_format, self.full_range = y4m.fmt, y4m.full_range

    @staticmethod
    def _demuxer(path: str, cls, error, unsupported):
        """``cls(path)``, its errors raised as the JAX reader's OSError
        (cv2 does not open the file) or as :class:`UnsupportedVideo`."""
        try:
            return cls(path)
        except error as e:
            raise OSError(f"cannot open video source {path!r}: {e}") from e
        except unsupported as e:
            raise UnsupportedVideo(f"{e}: read by cv2.VideoCapture but not "
                                   f"by the port") from None

    def _open_stream(self, path: str, container: str, *demuxer) -> None:
        """A container whose demuxer names its codec (no fourcc: FFmpeg's
        codec tag is 0 there)."""
        d = self._demuxer(path, *demuxer)
        self.container = container
        self._set(d.codec, b"", d.width, d.height, b"", d)

    def _open_fourcc(self, path: str, container: str, *demuxer) -> None:
        """A container whose video stream carries a BITMAPINFOHEADER-style
        fourcc and extradata, looked up as in AVI."""
        d = self._demuxer(path, *demuxer)
        if fourcc_codec(d.fourcc) is None:
            d.close()
            raise UnsupportedVideo(
                f"{path}: {container} with {_codec(d.fourcc)} video is read "
                f"by cv2.VideoCapture but not by the port (which reads "
                f"{_READS})")
        self.container = container
        self._set(fourcc_codec(d.fourcc), d.fourcc, d.width, d.height,
                  d.extradata, d)

    def _open_mp4(self, path: str) -> None:
        try:
            mp4 = Mp4File(path)
        except Mp4Error as e:
            raise OSError(f"cannot open video source {path!r}: {e}") from e
        except UnsupportedMp4 as e:
            raise UnsupportedVideo(f"{e}: read by cv2.VideoCapture but not "
                                   f"by the port") from None
        t = mp4.track
        if t.codec.startswith("fourcc "):
            # FFmpeg's mov demuxer takes a format its own table lacks from
            # the AVI fourccs
            t.codec = fourcc_codec(t.fourcc) or _codec(t.fourcc)
        if t.codec not in ("ffv1", "mjpeg", "png", "mpeg4", "vp9", "mpeg2",
                           "huffyuv", "rawvideo", "h263", "flv1",
                           "wmv2") + tuple(MSMPEG4_FOURCCS):
            mp4.close()
            fourcc = t.fourcc.decode("latin-1")
            raise UnsupportedVideo(
                f"{path}: MP4 with {t.codec} video ({fourcc}) is read by "
                f"cv2.VideoCapture but not by the port (which reads FFV1, "
                f"Huffyuv, Motion JPEG, PNG, MPEG-4 Part 2, VP9, MPEG-2, "
                f"H.263, Sorenson Spark, MS MPEG-4 v2 and v3, WMV7, WMV8 "
                f"and raw RGBA in MP4 and MOV)")
        self.container = "MP4"
        self._set(t.codec, t.fourcc, t.width, t.height, t.extradata, mp4)

    def _open_mkv(self, path: str) -> None:
        try:
            mkv = MkvFile(path)
        except MatroskaError as e:
            raise OSError(f"cannot open video source {path!r}: {e}") from e
        except UnsupportedMatroska as e:
            raise UnsupportedVideo(f"{e}: read by cv2.VideoCapture but not "
                                   f"by the port") from None
        t = mkv.track
        codec, fourcc, extradata = None, t.codec_id.encode("latin-1"), b""
        if t.codec_id == "V_FFV1":
            codec, extradata = "ffv1", t.codec_private
        elif t.codec_id == "V_MJPEG":
            codec = "mjpeg"
        elif t.codec_id in ("V_MPEG4/ISO/SP", "V_MPEG4/ISO/ASP",
                            "V_MPEG4/ISO/AP"):
            codec, fourcc, extradata = "mpeg4", b"", t.codec_private
        elif t.codec_id == VP8_CODEC_ID:
            codec, fourcc = "vp8", b""
        elif t.codec_id == VP9_CODEC_ID:
            codec, fourcc = "vp9", b""
        elif t.codec_id == MPEG2_CODEC_ID:
            codec, fourcc, extradata = "mpeg2", b"", t.codec_private
        elif t.codec_id == "V_MPEG4/MS/V3":
            codec, fourcc = "msmpeg4v3", b""
        elif t.codec_id == "V_UNCOMPRESSED":
            fourcc = t.colour_space
            codec = "rawvideo" if fourcc in RAW_FOURCCS else None
        elif t.codec_id == "V_MS/VFW/FOURCC" and len(t.codec_private) >= 40:
            fourcc = t.codec_private[16:20]
            codec, extradata = fourcc_codec(fourcc), t.codec_private[40:]
        if codec is None:
            mkv.close()
            if t.codec_id == "V_UNCOMPRESSED":
                kind = f"raw video {fourcc!r}"
            elif t.codec_id == "V_MS/VFW/FOURCC":
                kind = _codec(fourcc)
            elif t.codec_id == "V_QUICKTIME" and len(t.codec_private) >= 8:
                # FFmpeg takes the QuickTime sample description's format
                kind = _codec(t.codec_private[4:8])
            else:
                kind = CODEC_NAMES.get(t.codec_id, t.codec_id)
            raise UnsupportedVideo(
                f"{path}: Matroska/WebM with {kind} video ({t.codec_id}) is "
                f"read by cv2.VideoCapture but not by the port (which reads "
                f"{_READS})")
        self.container = "Matroska"
        self._set(codec, fourcc, t.width, t.height, extradata, mkv)

    def _set(self, codec, fourcc, width, height, extradata, demuxer) -> None:
        self.codec, self.fourcc = codec, fourcc
        self.raw_format = RAW_FOURCCS.get(fourcc, "")
        self.width, self.height, self.extradata = width, height, extradata
        self._packets, self._close = demuxer.frames, demuxer.close

    def _refuse_other(self, path: str, head: bytes) -> None:
        kind = _container(head)
        if kind:
            raise UnsupportedVideo(f"{path}: {kind} is read by "
                                   f"cv2.VideoCapture but not by the port "
                                   f"(which reads {_CONTAINERS})")
        raise OSError(f"cannot open video source {path!r}")

    # ---- decoders ----

    def _decoder(self) -> Tuple[Callable[[bytes, str], np.ndarray],
                                Callable[[], None], Callable[[], list]]:
        """(decode(packet, what), close, drain) for one pass over the
        stream: drain gives the frames a decoder still holds after the
        last packet."""
        try:
            decoder = self._new_decoder()
            if len(decoder) == 2:
                decoder += (list,)
            return decoder
        except UnsupportedImage as e:
            raise UnsupportedVideo(str(e)) from None
        except DecodeError as e:      # the codec does not open: nor does cv2
            raise OSError(f"cannot open video source {self.path!r}: "
                          f"{e}") from e

    def _new_decoder(self):
        def nothing() -> None:
            pass
        if self.codec == "mjpeg":
            return self._mjpeg(), nothing
        if self.codec == "ffv1":
            from fealess_tpu_torch.io.ffv1 import FFV1Decoder
            dec = FFV1Decoder(self.extradata, self.width, self.height,
                              self.path)
            return lambda data, what: dec.decode(data), dec.close
        if self.codec == "rawvideo":
            from fealess_tpu_torch.io.rawvideo import decode_raw
            return lambda data, what: decode_raw(
                data, self.width, self.height, self.raw_format, what,
                self.full_range), nothing
        if self.codec == "huffyuv":
            from fealess_tpu_torch.io.huffyuv import HuffyuvDecoder
            dec = HuffyuvDecoder(self.extradata, self.width, self.height,
                                 self.path)
            return lambda data, what: dec.decode(data), dec.close
        if self.codec == "mpeg4":
            from fealess_tpu_torch.io.mpeg4 import Mpeg4Decoder
            dec = Mpeg4Decoder(self.extradata, self.fourcc, self.path,
                               self.container)
            if self.fourcc.upper() in (b"GEOV", b"GEOX"):
                # FFmpeg turns GeoVision's pictures upside down
                def flipped(data, what):
                    frame = dec.decode(data)
                    return None if frame is None else \
                        np.ascontiguousarray(frame[::-1])
                return flipped, dec.close
            return lambda data, what: dec.decode(data), dec.close
        if self.codec == "vp8":
            from fealess_tpu_torch.io.vp8 import Vp8Decoder
            dec = Vp8Decoder(self.path, self.container)
            return lambda data, what: dec.decode(data), dec.close
        if self.codec == "vp9":
            from fealess_tpu_torch.io.vp9 import Vp9Decoder
            dec = Vp9Decoder(self.path, self.container)
            return lambda data, what: dec.decode(data), dec.close
        if self.codec == "mpeg2":
            from fealess_tpu_torch.io.mpeg2 import Mpeg2Decoder
            dec = Mpeg2Decoder(self.extradata, self.path, self.container)
            return lambda data, what: dec.decode(data), dec.close, dec.flush
        if self.codec in ("h263", "flv1"):
            from fealess_tpu_torch.io.h263 import H263Decoder
            dec = H263Decoder(self.extradata, self.fourcc, self.path,
                              self.container, "h263" if self.codec == "h263"
                              else "sorenson")
            return lambda data, what: dec.decode(data), dec.close
        if self.codec in MSMPEG4_FOURCCS:
            from fealess_tpu_torch.io.msmpeg4 import MSMPEG4Decoder
            dec = MSMPEG4Decoder(self.codec, self.width, self.height,
                                 self.fourcc, self.path, self.container)
            return lambda data, what: dec.decode(data), dec.close
        if self.codec == "wmv2":
            from fealess_tpu_torch.io.wmv2 import WMV2Decoder
            dec = WMV2Decoder(self.extradata, self.width, self.height,
                              self.fourcc, self.path, self.container)
            return lambda data, what: dec.decode(data), dec.close
        if self.codec == "png":
            return image2.png_frame, nothing
        return image2.bmp_frame, nothing

    def _mjpeg(self) -> Callable[[bytes, str], np.ndarray]:
        from fealess_tpu_torch.io import mjpeg
        limited = False          # FFmpeg's cs_itu601 stays set once seen

        def decode(data: bytes, what: str) -> np.ndarray:
            nonlocal limited
            _, rows = mjpeg.header(data, what)
            if not self.height:          # image2: the first frame's
                self.height = rows
            now, later = mjpeg.itu601_comment(data)
            limited = limited or now
            # mjpegdec's test: a field is under 3/4 of the stream's height
            if rows < self.height * 3 // 4:
                raise UnsupportedImage(
                    f"interlaced Motion JPEG ({rows} rows a field, "
                    f"{self.height} a frame)")
            frame = mjpeg.decode_frame(data, not limited, what)
            limited = limited or later
            return frame
        return decode

    def __iter__(self) -> Iterator[np.ndarray]:
        """The frames cv2's ``read`` returns, up to the first packet the
        decoder rejects (where ``read`` first returns False), then those
        the decoder holds at the end of the stream."""
        decode, close, drain = self._decoder()
        first = None
        try:
            for i, data in enumerate(self._demuxed()):
                what = f"{self.path} frame {i}"
                try:
                    frame = decode(data, what)
                except UnsupportedImage as e:
                    raise UnsupportedVideo(
                        e if str(e).startswith(what) else f"{what}: {e}"
                    ) from None
                except DecodeError:
                    return
                if isinstance(frame, list):   # VP9 or MPEG-2: 0-n frames
                    yield from frame
                    continue
                if frame is None:    # a VOP not coded, a hidden VP8 frame
                    continue
                if self._image2:
                    if first is None:
                        first = frame.shape
                    elif frame.shape != first:
                        raise UnsupportedVideo(
                            f"{what}: an image sequence or pipe whose frames "
                            f"differ in size ({frame.shape[1]}x"
                            f"{frame.shape[0]} "
                            f"after {first[1]}x{first[0]}: cv2 scales each "
                            f"to the first's with swscale)")
                yield frame
            yield from drain()
        finally:
            close()

    def _demuxed(self) -> Iterator[bytes]:
        """The demuxer's packets, its refusals of what it meets in the
        stream raised as :class:`UnsupportedVideo`."""
        try:
            yield from self._packets()
        except _STREAM_REFUSALS as e:
            raise UnsupportedVideo(f"{e}: read by cv2.VideoCapture but not "
                                   f"by the port") from None

    def close(self) -> None:
        self._close()

    def __enter__(self) -> "VideoReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
