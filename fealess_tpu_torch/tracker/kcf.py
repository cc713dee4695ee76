"""Kernelized Correlation Filter tracker (counterpart of
``fealess_tpu.tracker.kcf``).

``KCFTracker`` (kcf_tracker/kcftracker.cpp:92-536) on tensors: subwindow
resample, FHOG (+ Lab) features, Hann window, Gaussian-kernel correlation
in the Fourier domain (``torch.fft``, complex64), sub-pixel peak, the +-1
scale-step tests and the linear-interpolation train step.  The per-frame
update runs over a leading batch axis of tracker states: one tracker is a
batch of 1, and ``update_batch`` updates every state of a geometry bucket
in one pass.

Numerics follow the JAX version as XLA compiles it under ``jit``:

- a division by a constant is a multiplication by the constant's float32
  reciprocal (XLA's algebraic simplifier does that rewrite), written so
  here with :func:`_recip`, and ``(c1 * s) * c2`` is ``s * (c1 * c2)``
  (the same simplifier folds the constants; it decides the truncated
  patch window at a scale step);
- the Lab conversion's powers (``** 2.4`` and the cube root, which XLA's
  CPU backend computes as glibc ``powf(x, 1/3)``) are evaluated in float64
  and rounded to float32, which gives the same values on the CPU and the
  card; against JAX on the CPU they differ in the last bit on 0.8% and
  0.16% of inputs, and the nearest-centroid decision on 2 of the
  16777216 u8 BGR triples (tests/test_torch_tracker.py counts them).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fealess_tpu_torch.config import KcfConfig
from fealess_tpu_torch.ops.sampling import sample_patch_bilinear
from fealess_tpu_torch.tracker import fhog

# The 15 fixed Lab cluster centroids (kcf_tracker/labdata.hpp:1-17).
LAB_CENTROIDS = np.array([
    [161.317504, 127.223401, 128.609333],
    [142.922425, 128.666965, 127.532319],
    [67.879757, 127.721830, 135.903311],
    [92.705062, 129.965717, 137.399500],
    [120.172257, 128.279647, 127.036493],
    [195.470568, 127.857070, 129.345415],
    [41.257102, 130.059468, 132.675336],
    [12.014861, 129.480555, 127.064714],
    [226.567086, 127.567831, 136.345727],
    [154.664210, 131.676606, 156.481669],
    [121.180447, 137.020793, 153.433743],
    [87.042204, 137.211742, 98.614874],
    [113.809537, 106.577104, 157.818094],
    [81.083293, 170.051905, 148.904079],
    [45.015485, 138.543124, 102.402528]], np.float32)

_RGB_TO_XYZ = np.array([[0.412453, 0.357580, 0.180423],
                        [0.212671, 0.715160, 0.072169],
                        [0.019334, 0.119193, 0.950227]], np.float32)
_WHITE = np.array([0.950456, 1.0, 1.088754], np.float32)


def kcf_reference_config(hog: bool = True, fixed_window: bool = True,
                         multiscale: bool = True,
                         lab: bool = True) -> KcfConfig:
    """The reference constructor's parameter resolution
    (kcftracker.cpp:92-160)."""
    lam, padding, out_sigma = 1e-4, 2.5, 0.125
    if hog:
        interp, sigma, cell = 0.012, 0.6, 4
        if lab:
            interp, sigma, out_sigma = 0.005, 0.4, 0.1
    else:
        interp, sigma, cell = 0.075, 0.2, 1
        lab = False   # "Lab features are only used with HOG features."
    if multiscale:
        template, step, fixed_window = 96, 1.05, True
    elif fixed_window:
        template, step = 96, 1.0
    else:
        template, step = 1, 1.0
    return KcfConfig(use_hog=hog, use_lab=lab,
                     use_fixed_window=fixed_window,
                     use_multiscale=multiscale, lambda_reg=lam,
                     padding=padding, output_sigma_factor=out_sigma,
                     interp_factor=interp, kernel_sigma=sigma,
                     cell_size=cell, template_size=template,
                     scale_step=step, scale_weight=0.95)


@dataclasses.dataclass
class KcfState:
    """Tracker state (the reference's members _tmpl, _alphaf, _roi,
    _scale); a batch of states carries a leading axis on every field."""
    tmpl: torch.Tensor     # (C, Hc, Wc) f32
    alphaf: torch.Tensor   # (Hc, Wc) complex64
    roi: torch.Tensor      # (4,) f32: x, y, w, h
    scale: torch.Tensor    # () f32


def state_from_numpy(leaves: Mapping[str, np.ndarray],
                     device="cuda") -> KcfState:
    """A KcfState from numpy leaves (``tmpl``, ``alphaf``, ``roi``,
    ``scale``), e.g. a JAX tracker's state fetched to the host."""
    return KcfState(**{f.name: torch.from_numpy(
        np.array(leaves[f.name])).to(device)
        for f in dataclasses.fields(KcfState)})


def _recip(c: float) -> float:
    """The float32 reciprocal of ``c``: XLA compiles ``x / c`` for a
    constant ``c`` as ``x * (1 / c)``, rounded so."""
    return float(np.float32(1.0) / np.float32(c))


def _pow(x: torch.Tensor, e: float) -> torch.Tensor:
    """``x ** float32(e)`` evaluated in float64, rounded to float32."""
    return x.double().pow(float(np.float32(e))).to(torch.float32)


def _bgr_to_lab_u8scale(bgr: torch.Tensor) -> torch.Tensor:
    """BGR (0..255 float, (..., 3)) -> Lab in OpenCV 8U scaling: L*255/100,
    a+128, b+128 (the float CIE D65 formula of the JAX version)."""
    dev = bgr.device
    rgb = bgr.flip(-1) * _recip(255.0)
    lin = torch.where(rgb > 0.04045, _pow((rgb + 0.055) * _recip(1.055), 2.4),
                      rgb * _recip(12.92))
    m = torch.from_numpy(_RGB_TO_XYZ).to(dev)
    inv_white = torch.tensor([_recip(v) for v in _WHITE], dtype=torch.float32,
                             device=dev)
    xyz = (lin @ m.T) * inv_white
    f = torch.where(xyz > 0.008856, _pow(xyz, 1.0 / 3.0),
                    7.787 * xyz + 16.0 / 116.0)
    lum = torch.where(xyz[..., 1] > 0.008856, 116.0 * f[..., 1] - 16.0,
                      903.3 * xyz[..., 1])
    a = 500.0 * (f[..., 0] - f[..., 1]) + 128.0
    b = 200.0 * (f[..., 1] - f[..., 2]) + 128.0
    return torch.stack([lum * 255.0 * _recip(100.0), a, b], dim=-1)


def _subpixel_peak(left, center, right):
    """1D quadratic peak interpolation (kcftracker.cpp:527-536)."""
    divisor = 2.0 * center - right - left
    return torch.where(divisor == 0.0, 0.0, 0.5 * (right - left) / divisor)


class KcfTracker:
    """Host facade holding the static patch geometry and its constants.

    Usage::

        tracker = KcfTracker(kcf_reference_config(), device="cuda")
        state = tracker.init((x, y, w, h), image_bgr_u8)
        state, roi = tracker.update(state, next_image)

    Re-init contract (as the JAX version): ``init`` bakes the patch
    geometry, Hann window and Gaussian peak for the GIVEN ROI size; to
    track a different object, or after an imposed ROI of another size, call
    ``init`` again.  Images are (H, W, 3) u8 BGR, numpy or tensors.
    """

    def __init__(self, cfg: KcfConfig | None = None, device="cuda"):
        self.cfg = cfg or kcf_reference_config()
        self.device = torch.device(device)
        self._geom = None   # (tmpl_w, tmpl_h, Hc, Wc, C, scale0)

    # -- geometry (getFeatures inithann branch, kcftracker.cpp:355-394)
    def _fit_template(self, roi_w: float, roi_h: float):
        c = self.cfg
        padded_w = int(roi_w * c.padding)
        padded_h = int(roi_h * c.padding)
        if c.template_size > 1:
            if padded_w >= padded_h:
                scale0 = padded_w / float(c.template_size)
            else:
                scale0 = padded_h / float(c.template_size)
            tw = int(padded_w / scale0)
            th = int(padded_h / scale0)
        else:
            tw, th, scale0 = padded_w, padded_h, 1.0
        k = c.cell_size
        if c.use_hog:
            tw = (tw // (2 * k)) * 2 * k + 2 * k
            th = (th // (2 * k)) * 2 * k + 2 * k
            hc, wc = th // k - 2, tw // k - 2
            nch = 31 + (LAB_CENTROIDS.shape[0] if c.use_lab else 0)
        else:
            tw, th = (tw // 2) * 2, (th // 2) * 2
            hc, wc, nch = th, tw, 1
        return tw, th, hc, wc, nch, scale0

    def _image(self, image) -> torch.Tensor:
        return torch.as_tensor(image, device=self.device).to(torch.float32)

    def init(self, roi: Tuple[float, float, float, float],
             image) -> KcfState:
        """First-frame initialisation (KCFTracker::init)."""
        x, y, w, h = (float(v) for v in roi)
        geom = self._fit_template(w, h)
        if geom != self._geom:
            # a new patch geometry: rebuild its constants (a multi-object
            # bucket re-init with the same geometry keeps them)
            self._geom = geom
            _, _, hc, wc, _, _ = geom
            c = self.cfg

            # Hann window (createHanningMats, kcftracker.cpp:497-523)
            def hann1(n):
                return 0.5 * (1.0 - np.cos(
                    2.0 * np.pi * np.arange(n) / (n - 1)))
            hann = np.outer(hann1(hc), hann1(wc)).astype(np.float32)

            # Gaussian peak y^ (createGaussianPeak, kcftracker.cpp:329-348)
            out_sigma = np.sqrt(float(wc * hc)) / c.padding \
                * c.output_sigma_factor
            mult = -0.5 / (out_sigma * out_sigma)
            iy = np.arange(hc)[:, None] - hc // 2
            ix = np.arange(wc)[None, :] - wc // 2
            peak = np.exp(mult * (iy * iy + ix * ix)).astype(np.float32)
            prob = np.fft.fft2(peak).astype(np.complex64)
            self._hann = torch.from_numpy(hann).to(self.device)
            self._prob = torch.from_numpy(prob).to(self.device)
            self._lab_centroids = torch.from_numpy(LAB_CENTROIDS).to(
                self.device)
        roi0 = torch.tensor([[x, y, w, h]], dtype=torch.float32,
                            device=self.device)
        scale0 = torch.tensor([geom[5]], dtype=torch.float32,
                              device=self.device)
        state = self._init_state(self._image(image), roi0, scale0)
        return self.unstack_states(state)[0]

    # -- feature extraction (getFeatures, kcftracker.cpp:351-494)
    def _features(self, image, roi, scale, scale_adjust: float):
        """Feature maps (B, C, Hc, Wc) of the patches around ``roi`` (B, 4)
        extracted at ``scale_adjust * scale`` (B,) (getFeatures)."""
        c = self.cfg
        tw, th, _, _, _, _ = self._geom
        cx = roi[:, 0] + roi[:, 2] * 0.5
        cy = roi[:, 1] + roi[:, 3] * 0.5
        adj = np.float32(scale_adjust)
        ew = torch.trunc(scale * float(adj * np.float32(tw)))
        eh = torch.trunc(scale * float(adj * np.float32(th)))
        ex = torch.trunc(cx - ew * 0.5)
        ey = torch.trunc(cy - eh * 0.5)
        patch = sample_patch_bilinear(image, ex, ey, ew, eh, th, tw)
        if c.use_hog:
            f = fhog.fhog31(patch, c.cell_size).movedim(-1, -3)
            if c.use_lab:
                f = torch.cat([f, self._lab(patch)], dim=-3)
        else:
            gray = (patch[..., 0] * 0.114 + patch[..., 1] * 0.587
                    + patch[..., 2] * 0.299)
            f = (gray * _recip(255.0) - 0.5)[..., None, :, :]
        return f * self._hann

    def _lab(self, patch):
        """Cell-pooled Lab-centroid assignment histogram
        (kcftracker.cpp:434-478): each interior-cell pixel votes 1/k^2 for
        its nearest of the 15 centroids.  (B, 15, Hc, Wc)."""
        k = self.cfg.cell_size
        _, _, hc, wc, _, _ = self._geom
        lab = _bgr_to_lab_u8scale(patch)
        core = lab[..., k:k + hc * k, k:k + wc * k, :]
        d = ((core[..., None, :] - self._lab_centroids) ** 2).sum(dim=-1)
        n = LAB_CENTROIDS.shape[0]
        onehot = F.one_hot(d.argmin(dim=-1), n).to(torch.float32)
        cells = onehot.reshape(*onehot.shape[:-3], hc, k, wc, k, n).sum(
            dim=(-4, -2)) * _recip(k * k)
        return cells.movedim(-1, -3)

    # -- Fourier-domain kernel machinery
    def _correlation_pre(self, x, tmpl_fc, tmpl_energy, size: int):
        """gaussianCorrelation (kcftracker.cpp:294-327) of (B, C, Hc, Wc)
        features against a PRE-TRANSFORMED template: ``tmpl_fc =
        conj(fft2(tmpl))`` and its energy (B,) are shared by a frame's
        scale detects."""
        s2 = self.cfg.kernel_sigma * self.cfg.kernel_sigma
        conv = torch.fft.ifft2(torch.fft.fft2(x) * tmpl_fc).real
        c = torch.fft.fftshift(conv.sum(dim=-3), dim=(-2, -1))
        d = (((x * x).sum(dim=(-3, -2, -1)) + tmpl_energy)[:, None, None]
             - 2.0 * c) * _recip(size)
        return torch.exp(-d.clamp(min=0.0) * _recip(s2))

    def _detect(self, tmpl, x, alphaf, tmpl_fc, tmpl_energy):
        """detect (kcftracker.cpp:233-266) per batch row: (dx, dy, peak),
        each (B,)."""
        _, _, hc, wc, _, _ = self._geom
        kxz = self._correlation_pre(x, tmpl_fc, tmpl_energy,
                                    tmpl[0].numel())
        res = torch.fft.ifft2(alphaf * torch.fft.fft2(kxz)).real
        b = torch.arange(res.shape[0], device=res.device)
        flat = res.reshape(res.shape[0], -1).argmax(dim=1)   # first max
        py, px = flat // wc, flat % wc
        pv = res[b, py, px]
        left = res[b, py, (px - 1).clamp(min=0)]
        right = res[b, py, (px + 1).clamp(max=wc - 1)]
        up = res[b, (py - 1).clamp(min=0), px]
        down = res[b, (py + 1).clamp(max=hc - 1), px]
        fx = px.to(torch.float32) + torch.where(
            (px > 0) & (px < wc - 1), _subpixel_peak(left, pv, right), 0.0)
        fy = py.to(torch.float32) + torch.where(
            (py > 0) & (py < hc - 1), _subpixel_peak(up, pv, down), 0.0)
        return fx - wc // 2, fy - hc // 2, pv

    def _train(self, state: KcfState, x, factor: float) -> KcfState:
        """train (kcftracker.cpp:269-290); the self-correlation's two FFT
        sets are one transform."""
        s2 = self.cfg.kernel_sigma * self.cfg.kernel_sigma
        f = torch.fft.fft2(x)
        conv = torch.fft.ifft2(f * f.conj()).real
        c = torch.fft.fftshift(conv.sum(dim=-3), dim=(-2, -1))
        d = (2.0 * (x * x).sum(dim=(-3, -2, -1))[:, None, None]
             - 2.0 * c) * _recip(x[0].numel())
        kxx = torch.exp(-d.clamp(min=0.0) * _recip(s2))
        alphaf_new = self._prob / (torch.fft.fft2(kxx) + self.cfg.lambda_reg)
        keep = float(np.float32(1.0) - np.float32(factor))   # in float32
        return dataclasses.replace(
            state, tmpl=keep * state.tmpl + factor * x,
            alphaf=keep * state.alphaf + factor * alphaf_new)

    def _init_state(self, image, roi, scale0) -> KcfState:
        tmpl = self._features(image, roi, scale0, 1.0)
        alphaf = torch.zeros((roi.shape[0],) + tuple(self._prob.shape),
                             dtype=torch.complex64, device=self.device)
        state = KcfState(tmpl=tmpl, alphaf=alphaf, roi=roi, scale=scale0)
        return self._train(state, tmpl, 1.0)

    # -- per-frame update (KCFTracker::update, kcftracker.cpp:173-230)
    def _update(self, state: KcfState, image: torch.Tensor):
        """One frame for a batch of states: (new states, peak (B,))."""
        c = self.cfg
        image = image.to(torch.float32)
        h, w = image.shape[:2]
        rx, ry, rw, rh = state.roi.unbind(dim=1)
        rx = torch.where(rx + rw <= 0, -rw + 1, rx)
        ry = torch.where(ry + rh <= 0, -rh + 1, ry)
        rx = torch.where(rx >= w - 1, float(w - 2), rx)
        ry = torch.where(ry >= h - 1, float(h - 2), ry)
        roi = torch.stack([rx, ry, rw, rh], dim=1)
        cx = rx + rw * 0.5
        cy = ry + rh * 0.5
        scale = state.scale

        # the template's FFT set and energy serve every scale detect
        tmpl_fc = torch.fft.fft2(state.tmpl).conj()
        tmpl_energy = (state.tmpl * state.tmpl).sum(dim=(-3, -2, -1))

        def detect(x):
            return self._detect(state.tmpl, x, state.alphaf, tmpl_fc,
                                tmpl_energy)

        dx, dy, pv = detect(self._features(image, roi, scale, 1.0))
        if c.use_multiscale and c.scale_step != 1.0:
            step = float(np.float32(c.scale_step))
            inv_step = _recip(step)
            dxs, dys, pvs = detect(self._features(image, roi, scale,
                                                  inv_step))
            take = c.scale_weight * pvs > pv
            dx, dy, pv = (torch.where(take, dxs, dx),
                          torch.where(take, dys, dy),
                          torch.where(take, pvs, pv))
            scale = torch.where(take, scale * inv_step, scale)
            rw = torch.where(take, rw * inv_step, rw)
            rh = torch.where(take, rh * inv_step, rh)

            # the reference runs the bigger-scale test AFTER _scale/_roi
            # were possibly shrunk by the smaller one (kcftracker.cpp:
            # 188-211)
            roi_b = torch.stack([rx, ry, rw, rh], dim=1)
            dxb, dyb, pvb = detect(self._features(image, roi_b, scale, step))
            take = c.scale_weight * pvb > pv
            dx, dy, pv = (torch.where(take, dxb, dx),
                          torch.where(take, dyb, dy),
                          torch.where(take, pvb, pv))
            scale = torch.where(take, scale * step, scale)
            rw = torch.where(take, rw * step, rw)
            rh = torch.where(take, rh * step, rh)

        rx = cx - rw * 0.5 + dx * c.cell_size * scale
        ry = cy - rh * 0.5 + dy * c.cell_size * scale
        rx = torch.where(rx >= w - 1, float(w - 1), rx)
        ry = torch.where(ry >= h - 1, float(h - 1), ry)
        rx = torch.where(rx + rw <= 0, -rw + 2, rx)
        ry = torch.where(ry + rh <= 0, -rh + 2, ry)
        roi = torch.stack([rx, ry, rw, rh], dim=1)

        x2 = self._features(image, roi, scale, 1.0)
        state = self._train(dataclasses.replace(state, roi=roi, scale=scale),
                            x2, c.interp_factor)
        return state, pv

    def update(self, state: KcfState, image) -> Tuple[KcfState, np.ndarray]:
        """Track one frame; returns (new_state, roi[x, y, w, h])."""
        batch, _ = self._update(self.stack_states([state]),
                                self._image(image))
        state = self.unstack_states(batch)[0]
        return state, state.roi.cpu().numpy()

    # -- batched multi-object tracking (shared geometry)
    def update_batch(self, states: KcfState, image) -> KcfState:
        """One frame for a STACKED batch of states (leading axis = tracker
        instance), all of this instance's patch geometry (one geometry
        bucket; see apps.track.MultiTrackedRecognizer)."""
        return self._update(states, self._image(image))[0]

    @staticmethod
    def stack_states(states: Sequence[KcfState]) -> KcfState:
        return KcfState(**{f.name: torch.stack([getattr(s, f.name)
                                                for s in states])
                           for f in dataclasses.fields(KcfState)})

    @staticmethod
    def unstack_states(batch: KcfState):
        return [KcfState(**{f.name: getattr(batch, f.name)[i]
                            for f in dataclasses.fields(KcfState)})
                for i in range(batch.roi.shape[0])]
