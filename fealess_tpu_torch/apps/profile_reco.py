"""Device-time breakdown of warm frames of one serving path on the in-repo
fixture.

Usage (from the repository root, on a machine with a CUDA card):

    python3 -m fealess_tpu_torch.apps.profile_reco [--path top1]
        [--frames 5] [--trace DIR]

Paths:

- ``top1``: ``ObjReco.recognition`` on the fixture scene, in two ICP
  settings: (a) the defaults and (b) iterations forced with
  ``icp_dist_mean_threshold=0`` and ``icp_dist_diff_threshold=-1e30``;
  stages prepare, front-end, match, refine;
- ``multi``: ``ObjReco.recognition_multi`` (8 candidates) on the
  two-instance scene (``fixture.two_instance_scene``), default ICP;
  stages prepare, front-end, match, the 8 refines, NMS;
- ``track``: ``TrackedRecognizer`` steps over panned fixture frames 1-3
  after an initialising frame 0, default ICP; stages KCF update, gated
  match (front-end included), refine.

For each setting it runs ``--frames`` warm frames under ``torch.profiler``
and prints, per frame:

- ``wall``: host clock around the frames (under the profiler);
- ``device busy``: the union of the intervals of every device-side event
  of the trace (kernels, copies, memsets), so overlapping work counts once;
- ``idle``: 1 - busy / wall;
- the number of device events and of ``cudaStreamSynchronize`` calls;
- the ten device-event names with the most time.

Then the path's stage split of one frame outside the profiler, each stage
timed on the host clock between ``torch.cuda.synchronize()`` calls.
``--trace DIR`` also writes each setting's Chrome trace there.
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from fealess_tpu_torch import detector as td
from fealess_tpu_torch import nms as nms_mod
from fealess_tpu_torch import pipeline
from fealess_tpu_torch.apps import fixture
from fealess_tpu_torch.apps.track import TrackedRecognizer, roi_box
from fealess_tpu_torch.tracker.kcf import KcfTracker

FORCED = {"icp_dist_mean_threshold": 0.0, "icp_dist_diff_threshold": -1e30}


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def stage_ms(fn, reps: int = 5):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps, out


def profile_frames(label: str, frame, n: int, trace_dir) -> None:
    """Warm ``frame()`` up, then profile ``n`` calls and print the
    per-frame summary."""
    for _ in range(3):
        frame()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    if not dev:
        raise SystemExit("profile_reco: the trace holds no device events")
    busy_ms = busy_us([(e.time_range.start, e.time_range.end)
                       for e in dev]) / 1e3 / n
    syncs = sum(e.name == "cudaStreamSynchronize" for e in events) / n
    print(f"{label}: wall {wall_ms:.3f} ms/frame, device busy "
          f"{busy_ms:.3f} ms/frame, idle {1 - busy_ms / wall_ms:.3f}, "
          f"{len(dev) / n:.0f} device events/frame, {syncs:.0f} "
          f"cudaStreamSynchronize/frame")
    by_name = collections.Counter()
    count = collections.Counter()
    for e in dev:
        by_name[e.name] += e.time_range.elapsed_us()
        count[e.name] += 1
    for name, us in by_name.most_common(10):
        print(f"  {us / 1e3 / n:8.3f} ms/frame {count[name] / n:7.1f}x "
              f"{name[:90]}")
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"trace_{label.replace(' ', '_')}.json"))


def set_icp(eng, params) -> None:
    defaults = type(eng.cfg.icp)()
    eng.set_advanced_param("icp_dist_mean_threshold",
                           defaults.dist_mean_threshold)
    eng.set_advanced_param("icp_dist_diff_threshold",
                           defaults.dist_diff_threshold)
    for name, value in params.items():
        eng.set_advanced_param(name, value)


def front_and_match(eng, bgr, depth, roi_box=None):
    det = eng.cfg.detector
    planes = td.response_planes(td.quantized_pyramid(bgr, depth, det), det)
    return planes, td.match_from_planes(eng.bank, planes,
                                        eng.cfg.matching_threshold, det,
                                        eng._kernels, roi_box=roi_box)


def refine(eng, depth, k, m, i):
    return pipeline._refine_candidate(
        eng.bank, eng._model_depth_dev, eng._origins_dev, depth, k,
        m.template_slot[i], m.x[i], m.y[i], eng.cfg, eng.cfg.refine_crop)


def path_top1(eng, bgr_np, depth_np, cam, args) -> None:
    for setting, params in (("a", {}), ("b", FORCED)):
        set_icp(eng, params)
        profile_frames(f"top1 setting {setting} ({eng.cfg.icp.mode})",
                       lambda: eng.recognition(bgr_np, depth_np, cam),
                       args.frames, args.trace)
        det = eng.cfg.detector
        bgr, depth, k = eng._prepare_frame(bgr_np, depth_np, cam)
        t_prep, _ = stage_ms(lambda: eng._prepare_frame(bgr_np, depth_np,
                                                        cam))
        t_fe, planes = stage_ms(lambda: td.response_planes(
            td.quantized_pyramid(bgr, depth, det), det))
        t_match, m = stage_ms(lambda: td.match_from_planes(
            eng.bank, planes, eng.cfg.matching_threshold, det, eng._kernels))
        t_ref, _ = stage_ms(lambda: refine(eng, depth, k, m, 0))
        print(f"stages top1 {setting}: prepare {t_prep:.3f} ms, front-end "
              f"{t_fe:.3f} ms, match {t_match:.3f} ms, refine {t_ref:.3f} ms")


def path_multi(eng, bgr_np, depth_np, cam, args) -> None:
    set_icp(eng, {})
    two_bgr, two_depth = fixture.two_instance_scene(bgr_np, depth_np)
    m_obj = eng.cfg.max_objects
    profile_frames(f"multi ({eng.cfg.icp.mode}, {m_obj} candidates)",
                   lambda: eng.recognition_multi(two_bgr, two_depth, cam),
                   args.frames, args.trace)
    det = eng.cfg.detector
    bgr, depth, k = eng._prepare_frame(two_bgr, two_depth, cam)
    t_prep, _ = stage_ms(lambda: eng._prepare_frame(two_bgr, two_depth, cam))
    t_fe, planes = stage_ms(lambda: td.response_planes(
        td.quantized_pyramid(bgr, depth, det), det))
    t_match, m = stage_ms(lambda: td.match_from_planes(
        eng.bank, planes, eng.cfg.matching_threshold, det, eng._kernels))
    t_ref, refs = stage_ms(lambda: [refine(eng, depth, k, m, i)
                                    for i in range(m_obj)])
    poses = torch.stack([p for p, _ in refs])
    fields = [torch.stack([getattr(r.icp, f) for _, r in refs])
              for f in ("dist_mean", "ok")]
    n_pairs = torch.stack([r.n_pairs for _, r in refs])
    t_nms, _ = stage_ms(lambda: nms_mod.nms_3d(
        poses[:, :3, 3], fields[0], n_pairs, m.valid[:m_obj] & fields[1],
        eng.cfg.nms_object_distance))
    print(f"stages multi: prepare {t_prep:.3f} ms, front-end {t_fe:.3f} ms, "
          f"match {t_match:.3f} ms, {m_obj} refines {t_ref:.3f} ms, NMS "
          f"{t_nms:.3f} ms")


def path_track(eng, bgr_np, depth_np, cam, args) -> None:
    set_icp(eng, {})
    frames = fixture.pan(bgr_np, depth_np, 4)
    tracker = TrackedRecognizer(eng)
    tracker.step(*frames[0], cam)
    turn = [0]

    def frame():
        b, d = frames[1 + turn[0] % 3]
        turn[0] += 1
        return tracker.step(b, d, cam)

    profile_frames(f"track ({eng.cfg.icp.mode})", frame, args.frames,
                   args.trace)
    kcf, state = tracker._tracker, tracker._state
    bgr, depth, k = eng._prepare_frame(*frames[1], cam)
    batch = KcfTracker.stack_states([state])
    t_kcf, (st, _) = stage_ms(lambda: kcf._update(batch, bgr))
    box = roi_box(st.roi[0], tracker.roi_expand)
    t_match, (_, m) = stage_ms(lambda: front_and_match(eng, bgr, depth, box))
    t_ref, _ = stage_ms(lambda: refine(eng, depth, k, m, 0))
    print(f"stages track: KCF update {t_kcf:.3f} ms, gated match (front-end "
          f"included) {t_match:.3f} ms, refine {t_ref:.3f} ms")


PATHS = {"top1": path_top1, "multi": path_multi, "track": path_track}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=sorted(PATHS), default="top1")
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--trace", default=None,
                    help="directory for the Chrome traces")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_reco: needs a CUDA card")
    eng, bgr_np, depth_np, cam = fixture.load("cuda")
    PATHS[args.path](eng, bgr_np, depth_np, cam, args)
    print("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
