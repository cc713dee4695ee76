"""KCF tracker family (counterpart of ``fealess_tpu.tracker``)."""

from fealess_tpu_torch.tracker.kcf import KcfState, KcfTracker  # noqa: F401
