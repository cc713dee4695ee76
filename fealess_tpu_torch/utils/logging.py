"""The package's logger (the port's copy of ``fealess_tpu.utils.logging``;
the reference's LOGD macro, linemod/linemod.hpp:10-22).

One package-level logger, ``fealess_tpu_torch``, quiet by default
(WARNING); ``FEALESS_LOG=DEBUG`` (or any level name) raises its verbosity
for field debugging.  The environment is read once, at the first call.
"""

from __future__ import annotations

import logging
import os

ROOT = "fealess_tpu_torch"
_CONFIGURED = False


def get_logger(name: str = ROOT) -> logging.Logger:
    """The logger ``name`` (a child of the package's logger, or the package
    logger itself), configuring the package logger's handler and level on
    first use."""
    global _CONFIGURED
    if not _CONFIGURED:
        level = os.environ.get("FEALESS_LOG", "WARNING").upper()
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s: %(message)s"))
        root = logging.getLogger(ROOT)
        root.addHandler(handler)
        root.setLevel(getattr(logging, level, logging.WARNING))
        _CONFIGURED = True
    return logging.getLogger(name)
