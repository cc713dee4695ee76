"""Device-time breakdown of a warm Recognition on the in-repo fixture.

Usage (from the repository root, on a machine with a CUDA card):

    python3 -m fealess_tpu_torch.apps.profile_reco [--frames 5] [--trace DIR]

For each ICP setting, (a) the defaults and (b) iterations forced with
``icp_dist_mean_threshold=0`` and ``icp_dist_diff_threshold=-1e30``, it
runs ``--frames`` warm recognitions under ``torch.profiler`` and prints,
per frame:

- ``wall``: host clock around the recognitions (under the profiler);
- ``device busy``: the union of the intervals of every device-side event
  of the trace (kernels, copies, memsets), so overlapping work counts once;
- ``idle``: 1 - busy / wall;
- the number of device events and of ``cudaStreamSynchronize`` calls;
- the ten device-event names with the most time.

Then the stage split of one frame outside the profiler (prepare,
front-end, match, refine), each stage timed on the host clock between
``torch.cuda.synchronize()`` calls.  ``--trace DIR`` also writes each
setting's Chrome trace there.
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
from fealess_tpu_torch import pipeline
from fealess_tpu_torch.engine import CamIntrinsics, ObjReco
from fealess_tpu_torch.io.png import read_png

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIXTURE = os.path.join(REPO, "benchmarks", "reference", "out")
SETTINGS = {"a": {},
            "b": {"icp_dist_mean_threshold": 0.0,
                  "icp_dist_diff_threshold": -1e30}}


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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--trace", default=None,
                    help="directory for the Chrome traces")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_reco: needs a CUDA card")

    eng = ObjReco.create("LmICP", device="cuda")
    eng.add_obj(os.path.join(FIXTURE, "features"))
    bgr_np = read_png(os.path.join(FIXTURE, "scene_bgr.png"))
    depth_np = read_png(os.path.join(FIXTURE, "scene_depth.png"))
    with open(os.path.join(FIXTURE, "cam.txt")) as f:
        fx, fy, cx, cy = (float(v) for v in f.read().split())
    cam = CamIntrinsics(fx, fy, cx, cy, depth_np.shape[1], depth_np.shape[0])
    defaults = eng.cfg.icp
    n = args.frames

    for setting, params in SETTINGS.items():
        eng.set_advanced_param("icp_dist_mean_threshold",
                               defaults.dist_mean_threshold)
        eng.set_advanced_param("icp_dist_diff_threshold",
                               defaults.dist_diff_threshold)
        for name, value in params.items():
            eng.set_advanced_param(name, value)
        for _ in range(3):
            eng.recognition(bgr_np, depth_np, cam)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                eng.recognition(bgr_np, depth_np, cam)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        events = prof.events()
        dev = [e for e in events if e.device_type == DeviceType.CUDA]
        if not dev:
            raise SystemExit("profile_reco: the trace holds no device events")
        busy_ms = busy_us([(e.time_range.start, e.time_range.end)
                           for e in dev]) / 1e3 / n
        syncs = sum(e.name == "cudaStreamSynchronize" for e in events) / n
        print(f"setting {setting} ({defaults.mode}): wall {wall_ms:.3f} "
              f"ms/frame, device busy {busy_ms:.3f} ms/frame, idle "
              f"{1 - busy_ms / wall_ms:.3f}, {len(dev) / n:.0f} device "
              f"events/frame, {syncs:.0f} cudaStreamSynchronize/frame")
        by_name = collections.Counter()
        count = collections.Counter()
        for e in dev:
            by_name[e.name] += e.time_range.elapsed_us()
            count[e.name] += 1
        for name, us in by_name.most_common(10):
            print(f"  {us / 1e3 / n:8.3f} ms/frame {count[name] / n:7.1f}x "
                  f"{name[:90]}")
        if args.trace:
            os.makedirs(args.trace, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(args.trace, f"trace_{setting}.json"))

        det = eng.cfg.detector
        bgr, depth, k = eng._prepare_frame(bgr_np, depth_np, cam)
        t_prep, _ = stage_ms(lambda: eng._prepare_frame(bgr_np, depth_np,
                                                        cam))
        t_fe, planes = stage_ms(lambda: td.response_planes(
            td.quantized_pyramid(bgr, depth, det), det))
        t_match, m = stage_ms(lambda: td.match_from_planes(
            eng.bank, planes, eng.cfg.matching_threshold, det, eng._kernels))
        t_ref, _ = stage_ms(lambda: pipeline._refine_candidate(
            eng.bank, eng._model_depth_dev, eng._origins_dev, depth, k,
            m.template_slot[0], m.x[0], m.y[0], eng.cfg, eng.cfg.refine_crop))
        print(f"stages {setting}: prepare {t_prep:.3f} ms, front-end "
              f"{t_fe:.3f} ms, match {t_match:.3f} ms, refine {t_ref:.3f} ms")
    print("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
