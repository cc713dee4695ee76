#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (fealess_tpu_torch) on one GPU.

Usage (from the repository root, on a machine with a CUDA card):

    python3 chip_smoke.py

Phases, one line of output each (or a few):

1. card and versions: ``nvidia-smi`` name and power limit, torch, CUDA,
   nvcc; fails when ``torch.cuda.is_available()`` is false;
2. build of the hand-written kernels from ``fealess_tpu_torch/csrc``;
3. each kernel against its plain PyTorch twin on the same CUDA tensors, at
   the shapes the Recognition path gives it on the in-repo fixture
   (``benchmarks/reference/out``: 1024 templates, 640x480 RGB-D scene):
   K1 coarse scores and K2 local scores bitwise, K3 nearest neighbour
   index-equal and d2 bitwise;
4. ``ObjReco.recognition`` end to end in both ICP modes, with default ICP
   settings (a) and with forced iterations (b), each result checked
   against the JAX package's numbers on this fixture;
4b. ``ObjReco.recognition_multi`` (top-8 refine + 3D NMS) in both ICP
   modes on the fixture scene (1 result) and on a two-instance scene (the
   object's rect pasted at (20, 57): 2 results, 4 NN launches a frame);
4c. ``TrackedRecognizer`` over 4 panned fixture frames and
   ``MultiTrackedRecognizer`` over 4 panned two-instance frames: redetect
   flags, object counts and matches checked against the JAX package's;
   ROIs and scale steps against the same KCF tracker run on CPU tensors
   in this process (see ``EXPECT_TRACK``), and their distance from the
   JAX package's ROIs printed;
5. CUDA-event times of each kernel and twin, and warm per-frame times of
   Recognition, multi-object Recognition and a tracked frame.

Each path of phases 4-4c runs with the kernels' launch counters set to 0
just before it and read just after; every kernel must have run on the
paths that reach it.  The line before the last is a JSON object with one
entry per kernel (launches summed over the paths); the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero without printing that line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
REPEATS = 3            # recognitions per (mode, setting) in phase 4
TIMED_FRAMES = 10      # warm recognitions timed per setting in phase 5

# The JAX package's result on this fixture (JAX on CPU, 1024 templates),
# the same in both ICP modes: match (237, 157) at slot 0 with similarity
# 100.0 and 16384 ICP pairs.  Default ICP stops after 0 iterations with
# the identity rotation; forced ICP runs 10 and rotates by 0.0661 deg.
EXPECT_MATCH = (237.0, 157.0)
EXPECT_T = {"a": (-3.756, -3.583, -2.099), "b": (-3.672, -3.562, -2.001)}
T_TOL_MM = {"a": 0.05, "b": 0.1}
EXPECT_ROT_DEG = {"a": 0.0, "b": 0.0661}
ROT_TOL_DEG = 0.01
EXPECT_ITERS = {"a": 0, "b": 10}
EXPECT_NN = {"a": 0, "b": 9}          # K3 launches per recognition
EXPECT_DIST_B, DIST_TOL_B = 0.2852, 1e-3
FORCED = {"icp_dist_mean_threshold": 0.0, "icp_dist_diff_threshold": -1e30}

# Multi-object and tracking expectations, from the JAX package on the CPU
# on this fixture with EngineConfig() defaults (max_objects 8).
# The two-instance scene (fixture.two_instance_scene): the fixture scene
# with its rect bgr/depth[157:316, 237:428] pasted at x 20, y 57.
RECT_WH = (191.0, 159.0)
# recognition_multi, both ICP modes (JAX on CPU): the fixture scene gives
# one result, equal to top-1 (the 8 tied candidates form one NMS
# cluster); the two-instance scene gives (22, 57) then (237, 157).  Each
# (22, 57) candidate runs 2 ICP iterations, so K3 launches 4x per frame.
EXPECT_MULTI = {
    "fixture": [((237.0, 157.0), (-3.7562, -3.5826, -2.0991), 0.3830)],
    "two": [((22.0, 57.0), (-271.885, -119.516, -0.631), 7.6308),
            ((237.0, 157.0), (-3.7562, -3.5826, -2.0991), 0.3830)]}
EXPECT_MULTI_NN = {"fixture": 0, "two": 4}
MULTI_T_TOL_MM, MULTI_DIST_TOL = 0.05, 1e-3
# TrackedRecognizer over frame i = the fixture rolled by 2i columns and i
# rows (JAX on CPU, kcf_reference_config(): hog + lab + multiscale):
# (redetected, roi, match x, y).  The fixture's object has blue + green =
# 255 on 90% of its pixels, so FHOG's strongest-channel choice is an
# exact tie there, broken by the last bit of each implementation's patch
# arithmetic (XLA's fused loops in JAX): the port's features differ by up
# to 0.22 (of 0.39) and its scale-test peaks by 0.5-3% from identical
# states.  So the ROIs and scale steps are held against the port's own
# tracker on CPU tensors, and the distance from these JAX ROIs is
# printed, not checked.
EXPECT_TRACK = [
    (True, (237.0, 157.0, 191.0, 159.0), (237.0, 157.0)),
    (False, (235.273, 153.078, 200.550, 166.950), (242.0, 162.0)),
    (False, (238.038, 152.594, 200.550, 166.950), (242.0, 162.0)),
    (False, (242.651, 169.821, 191.0, 159.0), (247.0, 162.0))]
# MultiTrackedRecognizer(max_objects=8) over the two-instance scene with
# the same rolls (JAX on CPU): frame 0 re-detects and tracks 2 objects in
# 1 geometry bucket; then (roi, match x, y) per object.
EXPECT_MULTI_TRACK = [
    None,
    [((28.22, 61.04, 181.9, 151.43), (22.0, 62.0)),
     ((241.9, 160.62, 181.9, 151.43), (242.0, 162.0))],
    [((29.92, 61.92, 181.9, 151.43), (22.0, 62.0)),
     ((244.44, 161.28, 181.9, 151.43), (242.0, 162.0))],
    [((29.76, 63.11, 181.9, 151.43), (27.0, 62.0)),
     ((243.6, 156.55, 191.0, 159.0), (247.0, 162.0))]]
ROI_TOL_PX = 1.0       # card vs CPU tracker: cuFFT vs the CPU's FFT
SIZE_TOL_PX = 0.01     # w, h: the same scale steps


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def apply_setting(eng, setting: str, default_icp) -> None:
    """ICP setting (a): the defaults; (b): iterations forced to the cap,
    through the engine's own advanced parameters."""
    for name, value in (("icp_dist_mean_threshold",
                         default_icp.dist_mean_threshold),
                        ("icp_dist_diff_threshold",
                         default_icp.dist_diff_threshold)):
        eng.set_advanced_param(name, FORCED[name] if setting == "b"
                               else value)


def rotation_deg(r) -> float:
    """Rotation angle of a near-identity 3x3 in degrees, from its skew part
    (accurate at small angles, unlike the trace)."""
    import numpy as np
    w = 0.5 * np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0],
                        r[1, 0] - r[0, 1]], np.float64)
    return float(np.degrees(np.arcsin(min(np.linalg.norm(w), 1.0))))


def close(got, want, tol) -> bool:
    return all(abs(float(g) - float(w)) <= tol for g, w in zip(got, want))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call between CUDA events, after one warm-up."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA card")
    run(torch.device("cuda", 0))


def run(dev) -> None:
    import numpy as np
    import torch
    sys.path.insert(0, REPO)
    from fealess_tpu_torch import detector as td
    from fealess_tpu_torch import pipeline
    from fealess_tpu_torch.apps.track import (MultiTrackedRecognizer,
                                              TrackedRecognizer)
    from fealess_tpu_torch.apps import fixture
    from fealess_tpu_torch.ops import _build, nn, score
    from fealess_tpu_torch.tracker.kcf import KcfTracker

    # -- 1. card and versions
    card = card_line()
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    print(f"card: {card}")
    print(f"versions: python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, torch.version.cuda {torch.version.cuda}, "
          f"nvcc {nvcc.strip().splitlines()[-1]}")

    # -- 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds else 'cached'}"
          f" s)")
    log = (_build.BUILD_DIR / "build.log").read_text()
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # -- fixture on the card
    t0 = time.perf_counter()
    eng, bgr_np, depth_np, cam = fixture.load(dev)
    check(eng.bank.capacity == 1024, f"bank capacity {eng.bank.capacity}")
    print(f"fixture: {eng.bank.num_templates} templates, scene "
          f"{bgr_np.shape[1]}x{bgr_np.shape[0]}, loaded in "
          f"{time.perf_counter() - t0:.2f} s")

    # -- 3. kernels vs twins at the main path's shapes
    det = eng.cfg.detector
    bgr, depth, scene_k = eng._prepare_frame(bgr_np, depth_np, cam)
    planes = td.response_planes(td.quantized_pyramid(bgr, depth, det), det)
    tables = eng._kernels
    coarse_planes = planes[det.pyramid_levels - 1][0]
    coarse_table = tables[det.pyramid_levels - 1]
    sim, tslot, x, y = td.coarse_candidates(eng.bank, planes,
                                            eng.cfg.matching_threshold, det,
                                            tables)
    d0, table_k, px0, py0, _, _ = td.local_window_inputs(
        eng.bank, planes, det, tables, 0, tslot, x, y)
    matches = td.match_from_planes(eng.bank, planes,
                                   eng.cfg.matching_threshold, det, tables)
    cand = pipeline.candidate_inputs(eng.bank, eng._model_depth_dev,
                                     eng._origins_dev,
                                     matches.template_slot[0], eng.cfg)
    crop = eng.cfg.refine_crop
    ref, model, pair_mask, _, _ = pipeline.paired_clouds(
        depth, scene_k, *cand[:6], matches.x[0], matches.y[0], eng.cfg,
        crop, crop)
    # planted exact ties: every ref row twice, so each query's minimum
    # occurs at j and j + P/2 and the first must win
    half = ref.shape[0] // 2
    tie_ref = torch.cat([ref[:half], ref[:half]]).contiguous()

    cases = {
        "coarse_scores": [(score.coarse_scores, score.coarse_scores_plain,
                           (coarse_planes, coarse_table))],
        "local_scores": [(score.local_scores, score.local_scores_plain,
                          (d0, table_k, px0, py0)),
                         (score.local_scores, score.local_scores_plain,
                          (d0, table_k, px0 - 20, py0 - 20))],
        "nearest_neighbor": [(nn.nearest_neighbor, nn.nearest_neighbor_plain,
                              (model, ref)),
                             (nn.nearest_neighbor, nn.nearest_neighbor_plain,
                              (model, tie_ref))],
    }
    errs = {}
    for name, runs in cases.items():
        errs[name] = 0.0
        for kernel, plain, args in runs:
            got = kernel(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            if name == "nearest_neighbor":
                check(torch.equal(got[0], want[0]),
                      f"{name}: idx differs at "
                      f"{int((got[0] != want[0]).sum())} queries")
                check(torch.equal(got[1], want[1]),
                      f"{name}: d2 not bitwise equal")
                err = (got[1] - want[1]).abs().max().item()
            else:
                check(got.dtype == want.dtype and got.shape == want.shape,
                      f"{name}: {got.dtype}{tuple(got.shape)} vs "
                      f"{want.dtype}{tuple(want.shape)}")
                err = (got - want).abs().max().item()
                check(err == 0, f"{name}: max |kernel - twin| = {err}")
            errs[name] = max(errs[name], float(err))
        shapes = [tuple(a.shape) for a in runs[0][2] if hasattr(a, "shape")]
        print(f"kernel {name}: equal to its twin on {len(runs)} case(s), "
              f"inputs {shapes}, max_abs_err {errs[name]}")
    check(int(pair_mask.sum()) == eng.cfg.icp.max_points,
          f"ICP pairs {int(pair_mask.sum())}")

    # -- 4. end to end through the public API
    counted = (score.coarse_scores, score.local_scores, nn.nearest_neighbor)
    path_launches = {}

    def zero_counts():
        for fn in counted:
            fn.launches = 0

    def read_counts(path):
        path_launches[path] = [fn.launches for fn in counted]
        print(f"launches on path {path}: K1/K2/K3 {path_launches[path]}")

    zero_counts()
    n_reco = 0
    default_icp = eng.cfg.icp
    for mode in ("point_to_plane", "point_to_point"):
        for setting in ("a", "b"):
            eng.set_advanced_param("icp_mode", mode)
            apply_setting(eng, setting, default_icp)
            before = [fn.launches for fn in counted]
            for _ in range(REPEATS):
                res = eng.recognition(bgr_np, depth_np, cam)
                n_reco += 1
                check(len(res) == 1, f"{mode}/{setting}: no detection")
                r = res[0]
                check(r.obj_tag == "obj", r.obj_tag)
                check(tuple(r.match_rect[:2]) == EXPECT_MATCH,
                      f"{mode}/{setting}: match {r.match_rect}")
                check(r.similarity == 100.0,
                      f"{mode}/{setting}: similarity {r.similarity}")
                pose = r.world2cam
                check(pose.shape == (4, 4) and bool(np.isfinite(pose).all()),
                      f"{mode}/{setting}: pose {pose}")
                angle = rotation_deg(pose[:3, :3])
                check(abs(angle - EXPECT_ROT_DEG[setting]) <= ROT_TOL_DEG,
                      f"{mode}/{setting}: rotation {angle} deg from "
                      f"identity, expected {EXPECT_ROT_DEG[setting]}")
                t_err = max(abs(float(pose[i, 3]) - EXPECT_T[setting][i])
                            for i in range(3))
                check(t_err <= T_TOL_MM[setting],
                      f"{mode}/{setting}: t {pose[:3, 3]} vs "
                      f"{EXPECT_T[setting]}")
                if setting == "b":
                    check(abs(r.icp_dist - EXPECT_DIST_B) <= DIST_TOL_B,
                          f"{mode}/b: dist_mean {r.icp_dist}")
            grew = [fn.launches - b for fn, b in zip(counted, before)]
            check(grew[0] >= REPEATS and grew[1] >= REPEATS,
                  f"{mode}/{setting}: score kernels launched {grew[:2]}")
            check(grew[2] == EXPECT_NN[setting] * REPEATS,
                  f"{mode}/{setting}: NN kernel launched {grew[2]} times, "
                  f"expected {EXPECT_NN[setting]} per recognition")
            print(f"e2e {mode}/{setting}: {REPEATS} recognitions, match "
                  f"{r.match_rect[:2]} sim {r.similarity} t "
                  f"{[round(float(v), 5) for v in pose[:3, 3]]} "
                  f"(max |dt| {t_err:.5f} mm vs JAX) rotation {angle:.5f} "
                  f"deg, dist_mean {r.icp_dist:.5f}, launches K1/K2/K3 "
                  f"+{grew}")
    read_counts("recognition")
    for fn, count in zip(counted, path_launches["recognition"]):
        check(count > 0, f"{fn.__name__} never launched on the Recognition "
              f"path")

    # the step's own fields: slot, ICP iterations and pair count
    for setting in ("a", "b"):
        apply_setting(eng, setting, default_icp)
        step = pipeline.recognize_top1(eng.bank, eng._model_depth_dev,
                                       eng._origins_dev, bgr, depth, scene_k,
                                       eng.cfg, kernels=tables)
        iters = int(step.refine.icp.iterations)
        check(int(step.template_slot) == 0, f"slot {int(step.template_slot)}")
        check(iters == EXPECT_ITERS[setting], f"{setting}: {iters} iterations")
        check(int(step.refine.n_pairs) == 16384,
              f"n_pairs {int(step.refine.n_pairs)}")
        print(f"step {setting}: slot 0, {iters} ICP iterations, 16384 pairs")
    apply_setting(eng, "a", default_icp)

    # -- 4b. multi-object Recognition (default ICP settings)
    two_bgr, two_depth = fixture.two_instance_scene(bgr_np, depth_np)
    scenes = {"fixture": (bgr_np, depth_np), "two": (two_bgr, two_depth)}
    zero_counts()
    for mode in ("point_to_plane", "point_to_point"):
        eng.set_advanced_param("icp_mode", mode)
        for name, (b, d) in scenes.items():
            before = [fn.launches for fn in counted]
            res = eng.recognition_multi(b, d, cam)
            grew = [fn.launches - x for fn, x in zip(counted, before)]
            want = EXPECT_MULTI[name]
            check(len(res) == len(want), f"multi {mode}/{name}: "
                  f"{len(res)} results, expected {len(want)}")
            for r, (xy, t, dist) in zip(res, want):
                pose = r.world2cam
                check(r.match_rect == xy + RECT_WH and r.similarity == 100.0
                      and r.obj_tag == "obj",
                      f"multi {mode}/{name}: {r.match_rect} {r.similarity}")
                check(bool(np.isfinite(pose).all()) and close(
                    pose[:3, 3], t, MULTI_T_TOL_MM),
                    f"multi {mode}/{name}: t {pose[:3, 3]} vs {t}")
                check(abs(r.icp_dist - dist) <= MULTI_DIST_TOL,
                      f"multi {mode}/{name}: dist {r.icp_dist} vs {dist}")
            check(grew[0] >= 1 and grew[1] >= 1,
                  f"multi {mode}/{name}: score kernels launched {grew[:2]}")
            check(grew[2] == EXPECT_MULTI_NN[name],
                  f"multi {mode}/{name}: K3 launched {grew[2]}, expected "
                  f"{EXPECT_MULTI_NN[name]}")
            print(f"multi {mode}/{name}: {len(res)} result(s) " + ", ".join(
                f"{r.match_rect[:2]} sim {r.similarity} t "
                f"{[round(float(v), 4) for v in r.world2cam[:3, 3]]} dist "
                f"{r.icp_dist:.4f}" for r in res) + f"; launches +{grew}")
    read_counts("recognition_multi")
    eng.set_advanced_param("icp_mode", default_icp.mode)

    # -- 4c. KCF-gated tracking
    # the ROIs depend on the KCF tracker alone (a match re-initialises it
    # only on re-detection), so the same tracker on CPU tensors, from the
    # same initial ROIs, gives each frame's expected ROI
    def cpu_trace(scene_bgr, scene_depth, rois):
        frames = [b for b, _ in fixture.pan(scene_bgr, scene_depth, 4)]
        kcf = KcfTracker(None, "cpu")
        batch = KcfTracker.stack_states([kcf.init(r, frames[0])
                                         for r in rois])
        out = [[tuple(r) for r in rois]]
        for f in frames[1:]:
            batch = kcf.update_batch(batch, f)
            out.append([tuple(float(v) for v in r) for r in batch.roi])
        return out

    def same_roi(where, roi, want, jax_roi):
        print(f"  {where}: roi {[round(v, 3) for v in roi]}, CPU tracker "
              f"{[round(v, 3) for v in want]}, |d| vs JAX "
              f"{max(abs(a - b) for a, b in zip(roi, jax_roi)):.3f} px")
        check(close(roi[:2], want[:2], ROI_TOL_PX)
              and close(roi[2:], want[2:], SIZE_TOL_PX),
              f"{where}: roi {roi} vs CPU tracker {want}")

    zero_counts()
    tracker = TrackedRecognizer(eng)
    want_rois = cpu_trace(bgr_np, depth_np, [EXPECT_TRACK[0][1]])
    for i, ((b, d), (redet, jax_roi, mxy)) in enumerate(
            zip(fixture.pan(bgr_np, depth_np, 4), EXPECT_TRACK)):
        before = [fn.launches for fn in counted]
        st = tracker.step(b, d, cam)
        grew = [fn.launches - x for fn, x in zip(counted, before)]
        print(f"track frame {i}: redetected {st.redetected}, matches "
              f"{[r.match_rect[:2] for r in st.results]} sim "
              f"{[r.similarity for r in st.results]}; launches +{grew}")
        check(st.redetected == redet and len(st.results) == 1,
              f"track frame {i}: redetected {st.redetected}, "
              f"{len(st.results)} results")
        r = st.results[0]
        check(r.match_rect[:2] == mxy and r.similarity == 100.0,
              f"track frame {i}: match {r.match_rect} sim {r.similarity}")
        same_roi(f"track frame {i}", st.roi, want_rois[i][0], jax_roi)
        check(grew[0] >= 1 and grew[1] >= 1,
              f"track frame {i}: score kernels launched {grew[:2]}")
    multi = MultiTrackedRecognizer(eng, max_objects=8)
    for i, ((b, d), want) in enumerate(
            zip(fixture.pan(two_bgr, two_depth, 4), EXPECT_MULTI_TRACK)):
        before = [fn.launches for fn in counted]
        st = multi.step(b, d, cam)
        grew = [fn.launches - x for fn, x in zip(counted, before)]
        print(f"multi-track frame {i}: redetected {st.redetected}, "
              f"{st.n_tracked} tracked, {len(multi._trackers)} bucket(s), "
              f"matches {[r.match_rect[:2] for r in st.results]}; launches "
              f"+{grew}")
        check(st.redetected == (i == 0) and st.n_tracked == 2
              and len(st.results) == 2,
              f"multi-track frame {i}: redetected {st.redetected}, "
              f"{st.n_tracked} tracked, {len(st.results)} results")
        if i == 0:
            check(len(multi._trackers) == 1,
                  f"{len(multi._trackers)} geometry buckets")
            want_rois = cpu_trace(two_bgr, two_depth, st.rois)
        else:
            for k, (roi, r, (jax_roi, mxy)) in enumerate(
                    zip(st.rois, st.results, want)):
                check(r.match_rect[:2] == mxy and r.similarity == 100.0,
                      f"multi-track frame {i}: match {r.match_rect}")
                same_roi(f"multi-track frame {i} object {k}", roi,
                         want_rois[i][k], jax_roi)
        check(grew[0] >= 1 and grew[1] >= 1,
              f"multi-track frame {i}: score kernels launched {grew[:2]}")
    read_counts("tracking")
    launches = {fn.__name__: sum(v[k] for v in path_launches.values())
                for k, fn in enumerate(counted)}

    # -- 5. timing
    times = {}
    for name, runs in cases.items():
        kernel, plain, args = runs[0]
        times[name] = (cuda_ms(lambda: kernel(*args), 20),
                       cuda_ms(lambda: plain(*args), 3))
        print(f"time {name}: kernel {times[name][0]:.4f} ms, twin "
              f"{times[name][1]:.4f} ms ({card})")
    eng.set_advanced_param("icp_mode", default_icp.mode)
    frame_ms = {}
    for setting in ("a", "b"):
        apply_setting(eng, setting, default_icp)
        eng.recognition(bgr_np, depth_np, cam)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_FRAMES):
            eng.recognition(bgr_np, depth_np, cam)
        frame_ms[setting] = (time.perf_counter() - t0) * 1e3 / TIMED_FRAMES
        print(f"time recognition ({setting}, {default_icp.mode}): "
              f"{frame_ms[setting]:.3f} ms/frame warm, mean of "
              f"{TIMED_FRAMES} ({card})")
    apply_setting(eng, "a", default_icp)
    eng.recognition_multi(two_bgr, two_depth, cam)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_FRAMES):
        eng.recognition_multi(two_bgr, two_depth, cam)
    multi_ms = (time.perf_counter() - t0) * 1e3 / TIMED_FRAMES
    print(f"time recognition_multi (two-instance scene, "
          f"{default_icp.mode}): {multi_ms:.3f} ms/frame warm, mean of "
          f"{TIMED_FRAMES} ({card})")
    frames = fixture.pan(bgr_np, depth_np, 4)
    tracker = TrackedRecognizer(eng)
    for b, d in frames:
        tracker.step(b, d, cam)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    redetects = 0
    for k in range(TIMED_FRAMES):
        b, d = frames[1 + k % 3]
        redetects += tracker.step(b, d, cam).redetected
    track_ms = (time.perf_counter() - t0) * 1e3 / TIMED_FRAMES
    print(f"time tracked frame (frames 1-3 repeated, {default_icp.mode}): "
          f"{track_ms:.3f} ms/frame warm, mean of {TIMED_FRAMES}, "
          f"{redetects} re-detections ({card})")
    print(f"peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    src = {"coarse_scores": ("fealess_tpu_torch/csrc/score.cu",
                             "fealess_tpu/ops/score_pallas.py:153"),
           "local_scores": ("fealess_tpu_torch/csrc/score.cu",
                            "fealess_tpu/ops/score_pallas.py:277"),
           "nearest_neighbor": ("fealess_tpu_torch/csrc/nn.cu",
                                "fealess_tpu/ops/nn_pallas.py:35")}
    print(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src[name][0],
         "replaces": src[name][1], "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1]} for name in cases]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
