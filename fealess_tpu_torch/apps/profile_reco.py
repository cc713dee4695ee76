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
- ``top1-zoom``: ``ObjReco.recognition`` with default ICP on the fixture
  scene at 640x480 and as a 1280x960 camera sees it (``fixture.doubled``:
  resized on the card to 640x480 by ``ops/resize``); the same stages;
- ``track``: ``TrackedRecognizer`` steps over panned fixture frames 1-3
  after an initialising frame 0, default ICP; stages KCF update, gated
  match (front-end included), refine.

For each setting it runs ``--frames`` warm frames under ``torch.profiler``,
recording device activity and the CUDA runtime's calls but not the host's
operators (``utils.profiling.profile_calls``, as ``--profile``'s
device-stage table does), and prints, per frame:

- ``wall``: host clock around the frames (under the profiler);
- ``device busy``: the union of the intervals of every device-side event
  of the trace (kernels, copies, memsets), so overlapping work counts once;
- ``idle``: 1 - busy / wall;
- the number of device events and of ``cudaStreamSynchronize`` calls;
- the ten device-event names with the most time.

Then the path's stage split of one frame outside the profiler, each stage
timed on the host clock between ``torch.cuda.synchronize()`` calls.  The
``top1`` path also profiles the coarse stage alone
(``detector.coarse_candidates``, ``--frames`` calls on the fixture's
planes) and prints its device time a call split into kernel K1 and the
rest of the stage (the candidate gates and the top-K), and K1's time
between CUDA events around a CUDA graph of 20 launches; and one
refinement level alone (level 0 of ``detector.match_from_planes``:
positions in, new x, y and similarity out): its device time and device
events a call, its host time a call (enqueue only, and to a
synchronisation), and K2's time from a CUDA graph of 20 launches.
``--trace DIR`` also writes each setting's Chrome trace there.
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import time

import torch

from fealess_tpu_torch import detector as td
from fealess_tpu_torch import nms as nms_mod
from fealess_tpu_torch import pipeline
from fealess_tpu_torch.apps import fixture
from fealess_tpu_torch.apps.track import TrackedRecognizer, roi_box
from fealess_tpu_torch.ops import score
from fealess_tpu_torch.tracker.kcf import KcfTracker
from fealess_tpu_torch.utils.profiling import (WARMUP, busy_us, graph_ms,
                                              profile_calls, stage_ms)

FORCED = {"icp_dist_mean_threshold": 0.0, "icp_dist_diff_threshold": -1e30}


def profile_frames(label: str, frame, n: int, trace_dir) -> float:
    """Warm ``frame()`` up, then profile ``n`` calls
    (``utils.profiling.profile_calls``) and print the per-frame summary;
    returns the device busy ms per frame."""
    for _ in range(WARMUP):
        frame()
    run = profile_calls(frame, n)
    dev = run.device_events
    if not dev:
        raise SystemExit("profile_reco: the trace holds no device events")
    syncs = sum(e.name == "cudaStreamSynchronize"
                for e in run.prof.events()) / n
    print(f"{label}: wall {run.wall_ms:.3f} ms/frame, device busy "
          f"{run.busy_ms:.3f} ms/frame, idle "
          f"{1 - run.busy_ms / run.wall_ms:.3f}, {len(dev) / n:.0f} device "
          f"events/frame, {syncs:.0f} cudaStreamSynchronize/frame")
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
        run.prof.export_chrome_trace(os.path.join(
            trace_dir, f"trace_{label.replace(' ', '_')}.json"))
    return run.busy_ms


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


def coarse_stage(eng, planes, n: int) -> None:
    """Print the device time of one ``detector.coarse_candidates`` call
    from a trace of ``n`` calls: K1's kernel, and the rest of the stage;
    then K1 alone between CUDA events around a CUDA graph of 20
    launches."""
    det = eng.cfg.detector
    l_c = det.pyramid_levels - 1

    def call():
        return td.coarse_candidates(eng.bank, planes,
                                    eng.cfg.matching_threshold, det,
                                    eng._kernels)

    for _ in range(WARMUP):
        call()
    run = profile_calls(call, n)
    dev = run.device_events
    k1 = [e for e in dev if "coarse_scores_kernel" in e.name]
    if not k1:
        raise SystemExit("profile_reco: no K1 kernel in the coarse stage")
    total = run.busy_ms
    k1_ms = busy_us([(e.time_range.start, e.time_range.end)
                     for e in k1]) / 1e3 / n
    print(f"coarse stage: device busy {total:.4f} ms/call, K1 {k1_ms:.4f} "
          f"ms ({len(k1) / n:.0f}x), rest {total - k1_ms:.4f} ms "
          f"({(len(dev) - len(k1)) / n:.0f} device events)")
    k1_graph = graph_ms(
        lambda: score.coarse_scores(planes[l_c][0], eng._kernels[l_c]), 20)
    print(f"coarse stage: K1 {k1_graph:.4f} ms a launch between CUDA "
          f"events around a CUDA graph of 20")


def _refine_level_unfused(eng, planes, tslot, x, y, nf):
    """Level 0 of ``match_from_planes`` as trees without
    ``detector.refine_level`` run it (``local_window_inputs``, K2 at the
    given origins, then the argmax epilogue in torch), so that A/B runs
    time the same stage in both."""
    det = eng.cfg.detector
    t, win = det.t_at_level[0], score.LOCAL_WINDOW
    d0, table_k, px0, py0, x, y = td.local_window_inputs(
        eng.bank, planes, det, eng._kernels, 0, tslot, x, y)
    total = score.local_scores(d0, table_k, px0, py0).reshape(
        -1, win * win).to(torch.float32)
    best, best_idx = total.max(dim=1).values, total.argmax(dim=1)
    offs = td._offset(t)
    x = ((x // t - 8 + best_idx % win) * t + offs).to(torch.int32)
    y = ((y // t - 8 + best_idx // win) * t + offs).to(torch.int32)
    sim = best * 100.0 / (4 * nf[tslot, 0].clamp(min=1)).to(torch.float32)
    return x, y, sim


def local_stage(eng, planes, n: int) -> None:
    """Print one refinement level's device time and device events a call
    from a trace of ``n`` calls (level 0, on the coarse stage's
    candidates), its host time a call, enqueued only and to a
    synchronisation, and K2 alone between CUDA events around a CUDA graph
    of 20 launches."""
    det = eng.cfg.detector
    _, tslot, x, y = td.coarse_candidates(eng.bank, planes,
                                          eng.cfg.matching_threshold, det,
                                          eng._kernels)
    nf = eng.bank.num_features()
    if hasattr(td, "refine_level"):
        t = det.t_at_level[0]

        def call():
            return td.refine_level(eng.bank, planes, det, eng._kernels, 0,
                                   tslot, x, y, nf)

        def k2():
            return score.local_refine(
                planes[0][0], eng._kernels[0], tslot, x, y, eng.bank.width,
                eng.bank.height, nf, 0, t, td._offset(t), planes[0][1])
    else:
        def call():
            return _refine_level_unfused(eng, planes, tslot, x, y, nf)

        d0, table_k, px0, py0, _, _ = td.local_window_inputs(
            eng.bank, planes, det, eng._kernels, 0, tslot, x, y)

        def k2():
            return score.local_scores(d0, table_k, px0, py0)

    for _ in range(WARMUP):
        call()
    run = profile_calls(call, n)
    dev, busy = run.device_events, run.busy_ms
    reps = 50
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    synced_ms, _ = stage_ms(call, reps)
    print(f"local stage: device busy {busy:.4f} ms/call, {len(dev) / n:.0f} "
          f"device events/call, host {enqueue_ms:.4f} ms/call enqueued, "
          f"{synced_ms:.4f} ms/call to a synchronisation")
    print(f"local stage: K2 {graph_ms(k2, 20):.4f} ms a launch between "
          f"CUDA events around a CUDA graph of 20")


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
    coarse_stage(eng, planes, args.frames)
    local_stage(eng, planes, args.frames)


def path_top1_zoom(eng, bgr_np, depth_np, cam, args) -> None:
    set_icp(eng, {})
    big = fixture.doubled(bgr_np, depth_np, cam)
    det = eng.cfg.detector
    for label, frame in (("640x480", (bgr_np, depth_np, cam)),
                         ("1280x960 zoomed", big)):
        profile_frames(f"top1 {label} (a, {eng.cfg.icp.mode})",
                       lambda: eng.recognition(*frame), args.frames,
                       args.trace)
        bgr, depth, k = eng._prepare_frame(*frame)
        t_prep, _ = stage_ms(lambda: eng._prepare_frame(*frame))
        t_fe, planes = stage_ms(lambda: td.response_planes(
            td.quantized_pyramid(bgr, depth, det), det))
        t_match, m = stage_ms(lambda: td.match_from_planes(
            eng.bank, planes, eng.cfg.matching_threshold, det, eng._kernels))
        t_ref, _ = stage_ms(lambda: refine(eng, depth, k, m, 0))
        print(f"stages top1 {label}: prepare {t_prep:.3f} ms, front-end "
              f"{t_fe:.3f} ms, match {t_match:.3f} ms, refine {t_ref:.3f} "
              f"ms")


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


PATHS = {"top1": path_top1, "top1-zoom": path_top1_zoom,
         "multi": path_multi, "track": path_track}


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
