"""Frame sources for the acquisition tool (counterpart of
``fealess_tpu.io.series``).

Reimplements ``CImgSeriesReader`` (reference test/img_series_reader.h:9-28,
.cpp) for the sources the port can read:

- a directory of ``*.png``, ``*.jpg``, ``*.jpeg`` and ``*.bmp`` files
  (numerically sorted by stem, as the JAX reader globs and sorts them) or
  an explicit list of paths, decoded by ``io/imfile.read_image`` (by
  content, as ``cv2.imread``);
- any other path, read by ``io/video.VideoReader`` as ``cv2.VideoCapture``
  reads it: a video file (AVI, MP4 or Matroska holding Motion JPEG, FFV1,
  raw I420 or PNG frames), a single image file or a printf pattern
  (``seq/f_%03d.png``, FFmpeg's image2); a source cv2 reads and the port
  does not raises ``UnsupportedVideo`` naming it, a path that does not
  open raises ``OSError``.  Its frames are nameless (stem ``None``), and
  they stop at the first packet the decoder rejects, where cv2's ``read``
  returns False and the JAX reader stops.

Every frame is resized with ``ops/resize`` (cv2's INTER_LINEAR, bit for
bit) when ``target_wh`` is set.  A camera index needs a video device and
is refused with an error that names the limit.  RGB-D series (``gray/`` +
``depth/`` pairs) stream through ``io.native.FrameLoader`` instead.
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

# the JAX reader's globs, in its order
_EXTENSIONS = ("png", "jpg", "jpeg", "bmp")


def numeric_stem_key(path: str):
    """Sort key: numeric stems in numeric order first, then the others by
    name (``1, 2, 10, a``)."""
    stem = os.path.splitext(os.path.basename(path))[0]
    return (0, int(stem)) if stem.isdigit() else (1, stem)


class ImageSeriesReader:
    """Iterate BGR u8 frames from a directory of PNG, JPEG and BMP files,
    a list of image paths, or a video file, image file or printf pattern
    (``source``); ``target_wh`` resizes every frame."""

    def __init__(self, source, target_wh: Optional[Tuple[int, int]] = None):
        self._target = target_wh
        self._video = None
        paths: List[str] = []
        if isinstance(source, int):
            raise ValueError(
                f"frame source {source!r} is a camera index, which needs a "
                f"video device (cv2.VideoCapture); the port reads "
                f"directories and lists of image files and video files")
        if isinstance(source, (list, tuple)):
            paths = list(source)
        elif os.path.isdir(source):
            for ext in _EXTENSIONS:
                paths += glob.glob(os.path.join(source, f"*.{ext}"))
            paths.sort(key=numeric_stem_key)
        else:
            from fealess_tpu_torch.io.video import VideoReader
            self._video = VideoReader(source)
        self._paths = paths

    def __iter__(self) -> Iterator[np.ndarray]:
        for _, frame in self.iter_named():
            yield frame

    def iter_named(self) -> Iterator[Tuple[Optional[str], np.ndarray]]:
        """Yield ``(stem, frame)`` pairs; ``stem`` is the file's basename
        without extension (None for the frames of a video, an image file
        or a pattern), so consumers pair per-frame files (depth, pose) by
        name.  A file that is missing or
        does not decode is skipped; one of a format the port does not
        read raises ``UnsupportedImage`` (``UnsupportedVideo`` for a
        video's frame)."""
        from fealess_tpu_torch.io.imfile import (IMREAD_COLOR, DecodeError,
                                                 read_image)

        if self._video is not None:
            for frame in self._video:     # to cv2's first False
                yield None, self._resize(frame)
            return
        for p in self._paths:
            try:
                frame = read_image(p, IMREAD_COLOR)
            except (DecodeError, FileNotFoundError):   # cv2.imread: None
                continue
            yield os.path.splitext(os.path.basename(p))[0], self._resize(frame)

    def _resize(self, frame: np.ndarray) -> np.ndarray:
        if self._target is None:
            return frame
        from fealess_tpu_torch.ops.resize import resize_host
        return resize_host(frame, self._target)

    def close(self) -> None:
        """Close the video file, if the source is one."""
        if self._video is not None:
            self._video.close()
            self._video = None
