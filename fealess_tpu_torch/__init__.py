"""fealess_tpu_torch: the PyTorch + CUDA port of the fealess_tpu engine.

The JAX package ``fealess_tpu`` is the reference; this package mirrors its
module layout (``engine``, ``pipeline``, ``detector``, ``icp``, ``bank``,
``ops/*``, ``geometry/*``, ``io/*``) with plain functions on tensors.  The
three Pallas kernels of the Recognition path are hand-written CUDA kernels
for Hopper (``csrc/``), each beside a plain PyTorch twin that the wrappers
use for CPU tensors only.

Configuration is the JAX package's own ``fealess_tpu.config`` (plain
dataclasses, no framework), re-exported here as ``config``.

Machines that run the port have no jax.  Importing ``fealess_tpu.config``
runs ``fealess_tpu/__init__.py``, and ``ops/response.py`` executes
``fealess_tpu/ops/luts.py`` by file path; those three files must stay free
of jax imports.  ``tests/test_torch_io.py`` checks in a subprocess that
importing and running the port loads no jax.
"""

import torch

from fealess_tpu import config  # noqa: F401

__version__ = "0.1.0"

# The ICP covariance and Gauss-Newton normal equations, and the similarity
# conversions downstream of integer scores, are held to full float32 on the
# card; TF32 keeps ~10 mantissa bits and would change poses and rounding.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["config", "__version__"]
