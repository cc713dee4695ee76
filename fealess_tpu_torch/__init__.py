"""fealess_tpu_torch: the PyTorch + CUDA port of the fealess_tpu engine.

The JAX package ``fealess_tpu`` is the reference; this package mirrors its
module layout (``engine``, ``pipeline``, ``detector``, ``icp``, ``bank``,
``ops/*``, ``geometry/*``, ``io/*``) with plain functions on tensors.  The
three Pallas kernels of the Recognition path are hand-written CUDA kernels
for Hopper (``csrc/``), each beside a plain PyTorch twin that the wrappers
use for CPU tensors only.

The package stands alone: it imports and loads nothing of ``fealess_tpu``.
What it shares with the reference, it keeps as its own copy under the
same names: ``config`` (the configuration dataclasses and their JSON
form), ``ops/luts.py``, ``io/native.py`` (the ctypes bindings of
``libfealess_host``), ``utils/profiling.py`` and ``apps/metrics.py`` /
``apps/model_mesh.py``.  The machines that run it have no jax, flax or
cv2; ``tests/test_torch_io.py`` and ``tests/test_torch_cli.py`` check in a
subprocess that running the port loads none of them and no module under
``fealess_tpu/``.

Entry points run on ``cuda`` unless the caller names another device; a
caller that wants the CPU passes ``device="cpu"``, as the tests do.
``python -m fealess_tpu_torch train|recon|export|track|eval|acq`` is the
command line (``apps/cli.py``).
"""

import torch

from fealess_tpu_torch import config  # noqa: F401

__version__ = "0.1.0"

# The ICP covariance and Gauss-Newton normal equations, and the similarity
# conversions downstream of integer scores, are held to full float32 on the
# card; TF32 keeps ~10 mantissa bits and would change poses and rounding.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["config", "__version__"]
