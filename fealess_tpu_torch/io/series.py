"""Frame sources for the acquisition tool (counterpart of
``fealess_tpu.io.series``).

Reimplements ``CImgSeriesReader`` (reference test/img_series_reader.h:9-28,
.cpp) for the sources the port can read: a directory of PNG files
(numerically sorted by stem) or an explicit list of PNG paths, decoded by
``io/png.py`` and resized with ``ops/resize`` (cv2's INTER_LINEAR, bit for
bit).  Two sources of the JAX package need cv2, which the card does not
have, and are refused with an error that names the limit: camera indices
and video files (``cv2.VideoCapture``), and JPEG or BMP files.  RGB-D
series (``gray/`` + ``depth/`` pairs) stream through
``io.native.FrameLoader`` instead.
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

# decoded by the JAX package's cv2.imread, not by the port's PNG reader
_CV2_ONLY_IMAGES = (".jpg", ".jpeg", ".bmp")


def numeric_stem_key(path: str):
    """Sort key: numeric stems in numeric order first, then the others by
    name (``1, 2, 10, a``)."""
    stem = os.path.splitext(os.path.basename(path))[0]
    return (0, int(stem)) if stem.isdigit() else (1, stem)


class ImageSeriesReader:
    """Iterate BGR u8 frames from a directory of PNG files or a list of
    PNG paths (``source``); ``target_wh`` resizes every frame."""

    def __init__(self, source, target_wh: Optional[Tuple[int, int]] = None):
        self._target = target_wh
        if isinstance(source, (list, tuple)):
            paths: List[str] = list(source)
        elif isinstance(source, str) and os.path.isdir(source):
            paths = []
            for ext in ("png",) + tuple(e[1:] for e in _CV2_ONLY_IMAGES):
                paths += glob.glob(os.path.join(source, f"*.{ext}"))
            paths.sort(key=numeric_stem_key)
        else:
            raise ValueError(
                f"frame source {source!r} is a camera index or a video "
                f"file, which needs cv2.VideoCapture; the port reads "
                f"directories and lists of PNG files only")
        cv2_only = [p for p in paths
                    if os.path.splitext(p)[1].lower() in _CV2_ONLY_IMAGES]
        if cv2_only:
            raise ValueError(
                f"{cv2_only[0]}: JPEG and BMP files need cv2.imread; the "
                f"port reads PNG files only")
        self._paths = paths

    def __iter__(self) -> Iterator[np.ndarray]:
        for _, frame in self.iter_named():
            yield frame

    def iter_named(self) -> Iterator[Tuple[str, np.ndarray]]:
        """Yield ``(stem, frame)`` pairs; ``stem`` is the file's basename
        without extension, so consumers pair per-frame files (depth, pose)
        by name.  A file that is missing or does not decode is skipped."""
        from fealess_tpu_torch.io.png import DecodeError, read_png
        from fealess_tpu_torch.ops.resize import resize_host

        for p in self._paths:
            try:
                frame = read_png(p, color=True)
            except (DecodeError, FileNotFoundError):   # cv2.imread: None
                continue
            if self._target is not None:
                frame = resize_host(frame, self._target)
            yield os.path.splitext(os.path.basename(p))[0], frame

    def close(self) -> None:
        """Nothing to release (kept for the JAX reader's interface)."""
