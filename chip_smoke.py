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
   K1 coarse scores bitwise; K2 as the fused refinement level
   (``score.local_refine``: scores, x, y, best sum and feature count
   bitwise) and with the origins given (``score.local_scores``), on its
   edge cases (``local_cases``: all-zero planes, 4096 features on u8 up
   to 255, misaligned planes, Wd = 125, K = 1 and 0, clamps at the
   border from both sides, windows shifted out of the plane); K3 nearest
   neighbour index-equal and d2 bitwise; K1 also on distinct templates
   and its edge cases (``coarse_cases``: random features, Wd = 37, Hd =
   1, templates without features, features at the largest offsets, 4096
   features on u8 up to 255, misaligned planes), K3 on the edges of its
   split of the
   reference set (``nn_cases``: duplicate rows straddling every chunk
   boundary, ragged query and reference counts, a single row, rows at
   ``icp.PAD_COORD``); and the coarse stage (``detector.coarse_candidates``:
   K1, the gates and the top-K) equal to the same stage on CPU copies of
   its inputs;
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
4d. training and the command line on the card: ``libfealess_host`` built
   by the port (``ops/_build.build_native_host``: three sources of
   ``native/fealess_host`` with the host C++ compiler; its path and build
   seconds printed) and loaded, so the host extraction runs native; the
   fixture's training view through ``add_template`` and
   ``add_templates_batched`` (and through the numpy twin) equals
   template 0 of the repo's YAML bank; a 4-frame scan package (the panned
   fixture frames, written with the port's PNG writer) goes through
   ``python -m fealess_tpu_torch`` ``train`` (the database's sha256 equals
   the JAX package's), ``recon`` (results against the JAX CLI's),
   ``export`` and ``recon --artifact`` (lines equal to ``recon``'s); on
   the served bank, each kernel against its twin as in phase 3 at the
   shapes that bank gives it, then one recognition with forced ICP;
   templates per second of the batched trainer's stages (crop, front-end,
   extraction) on the 4-view chunk and on a 32-view chunk of panned
   frames beside the C++ reference's 27.8, and ``add_obj`` against the
   artifact's load, are timed; on both chunks the batched front-end
   (each level's ops once over all crops) is held bit for bit to the
   per-crop loop it replaced and both are profiled (device events and
   busy a chunk); on the 32-view chunk the native views are held to the
   numpy twin's, feature for feature;
5. times of each kernel and twin at the path's shapes, CUDA events
   around 20 back-to-back launches (3 for a twin; the kernels' ``ms``),
   and for each kernel also events around the replay of a CUDA graph of
   20 launches (``utils.profiling.graph_ms``: the device's time without the
   host's launch cost), K1 also on 1024 distinct templates; the launch
   floor (the graph time of a one-element in-place add); each kernel's bound
   (``ops/bounds.bound_ms``: the larger of its bytes over the card's
   memory rate and its operations over the f32 rate) and its share of it;
   warm per-frame times of Recognition, multi-object Recognition and a
   tracked frame, and the fixture bank's cold start through ``add_obj``
   and from an artifact.
6. the parallel layer (``fealess_tpu_torch.parallel``): first each kernel
   against its twin and timed at the shapes a 2-way split gives it (K1 on
   each 512-row half of the coarse table, K2 on each half-bank's own
   candidates, K3 on each 8192-query half against the 16384-row
   reference); 6a, in this process, a world-size-1 NCCL group: the
   sharded match on the fixture and two-instance scenes equal to
   ``_merge_matches`` of ``detector.match_bank`` (and its top-1 to
   match_bank's), both sharded ICP modes on phase 4 (b)'s 16384-pair
   clouds and ``recognize_batch_sharded`` on 4 frames (the fixture scene,
   the two-instance scene, pan frames 1 and 2; forced ICP) bitwise equal
   to the single-device functions; 6b, two spawned ranks on the one card
   in a gloo group over CUDA tensors (NCCL refuses two ranks on one GPU),
   the bank from a serving artifact that this process writes: their
   match bitwise equal to a one-process emulation (``match_from_planes``
   on each half-bank, merged in rank order), ICP within 1e-5 (rotation)
   and 1e-3 mm of the single-device ICP with equal iterations, the batch
   bitwise equal to 6a's, and on ``template_mesh(1)`` (a sub-mesh both
   ranks build) rank 0's match bitwise equal to ``_merge_matches`` of
   ``match_bank`` while rank 1 is refused; times of each against its
   single-device call (two processes sharing one card: not a scaling
   figure).

7. camera widths and frame input: ``ops/resize`` on the card bitwise
   equal to its CPU run on the common camera profiles (``RESIZE_SHAPES``);
   a 1280x960 camera (every pixel of the fixture scenes replicated 2x2, K
   doubled) served by ``recognition`` in both ICP settings and by
   ``recognition_multi`` on the two-instance scene, each bitwise equal to
   the native frame's result with the same K1/K2/K3 launches; a 1280x720
   camera (re-pinned processing dims 640x400) against the JAX package's
   result; the prepare stage at 640x480 and 1280x960, the upload of the
   larger frame and the resize on the card timed; ``read_png`` of a
   Paeth-filtered 640x480 RGB file with the C un-filter and with its
   numpy twin; ``recon --profile`` over a series of such frames through
   ``io.native.FrameLoader`` (its ``host-io(decode+wait)`` row against a
   decode on the main thread; the frames' launches are read before the
   device-stage table that ``--profile`` prints since phase 8 came, whose
   launches go on a path of their own).
7d. frame input (``io/imfile.read_image``: PNG, JPEG and BMP by content,
   as ``cv2.imread``): every file of ``tests/data/torch_frames`` decoded
   under the three flags to the sha256 of cv2's decode (recorded by
   ``tests/make_torch_frames.py``); ``acq --device cuda`` over a directory
   of two JPEG and two BMP frames with depth and clouds, its ``gray/`` and
   ``depth/`` bitwise and its clouds within ``CLOUD_TOL_MM`` of the same
   call on the CPU; ``recon`` in both ICP settings over the 640x480
   series whose ``gray/*.png`` hold JPEG data, its lines held to the JAX
   CLI's (similarity exact, pose within phase 4's tolerances) with K1 and
   K2 (and K3 under forced ICP) counted on the path, and each decoded
   frame's match to the JAX engine's; the host time to decode the fixture
   scene as baseline and progressive JPEG, as BMP and as PNG.  The files
   include JPEGs whose DHT segments are cut (libjpeg's standard tables).
7e. persistence: the JAX package's orbax checkpoint of the fixture bank
   (``tests/data/torch_ckpt``, written by ``tests/make_torch_ckpt.py``)
   through ``io/checkpoint.load_bank`` onto the card (OCDBT, zarr v2 and
   zstd read on the host), every leaf's sha256, dtype and shape equal to
   the recorded digests and bitwise equal to ``import_yaml`` on the card;
   ``pipeline.recognize_top1`` from that bank, with ``add_obj``'s model
   depths, equal to ``ObjReco.recognition`` in ICP settings (a) and (b),
   with K1/K2/K3 launched 1/1/0 and 1/1/9; ``save_bank`` then
   ``load_bank`` bitwise; host times of ``load_bank`` (orbax and
   ``arrays.npz``), ``import_yaml``, the serving artifact's load and
   ``save_bank``, and of the orbax load's host read with the zstd
   decodes inside it.  Then cv::FileStorage's other forms: the fixture
   bank written as XML and JSON by ``save_linemod``, each file's sha256
   equal to the JAX writer's (``tests/data/torch_ckpt/filestorage.json``);
   the XML as ``linemod_templates.yml`` served by ``ObjReco.add_obj``:
   bank and model depths bitwise equal to the YAML bank's, recognition
   equal to the YAML engine's in (a) and (b) with K1/K2/K3 1/1/0 and
   1/1/9; host times of ``load_linemod`` in the three forms.
7f. video files, image files and printf patterns (``io/video.
   VideoReader``, as ``cv2.VideoCapture`` reads them: AVI, MP4 and
   Matroska holding Motion JPEG, FFV1, raw I420, PNG, Huffyuv, MPEG-4
   Part 2, VP8, VP9, MPEG-2, H.263, Sorenson Spark, MS MPEG-4 v2 / v3,
   WMV7 or WMV8 frames, MOV holding MPEG-2, H.263, Sorenson Spark,
   MS MPEG-4, WMV7, WMV8 or raw RGBA; FLV, SWF, ASF and NUT;
   raw gray, NV12 and RGBA in AVI and Matroska; YUV4MPEG2; the MPEG video
   elementary stream; image2's single images and patterns; raw Motion
   JPEG and PNG pipes): every committed source of
   ``tests/data/torch_video``, ``torch_vp8``, ``torch_vp9``,
   ``torch_mpeg2``, ``torch_raw``, ``torch_demux``, ``torch_h263``,
   ``torch_msmpeg4`` and ``torch_wmv2`` decoded to the frame count and each
   frame's sha256 of cv2's (recorded by ``tests/make_torch_video.py``);
   ``acq --device cuda --clouds`` with the committed depth directory from
   the 640x480 Motion JPEG clip, the FFV1 MP4, the JPEG pattern, the mp4v
   AVI, the VP8 and VP9 WebM clips, the MPEG-2 MP4, and the YUV4MPEG2
   clip, the MPEG-TS, the Sorenson Spark FLV, the DIV3 AVI and the WMV8
   ``.wmv`` (two frames each, paired
   with the depth directory's first two), each
   package's ``gray/`` and ``depth/`` pixels equal to the JAX CLI's and its
   clouds within ``CLOUD_TOL_MM`` of the same call on the CPU; ``recon
   --device cuda`` on each package in both ICP settings, its lines held to
   the JAX CLI's (similarity exact, pose within phase 4's tolerances) with
   K1/K2/K3 at 1/1/0 a frame in (a) and 1/1/9 in (b); the host time to
   decode a 640x480 frame of each format, demux included, and of one
   MPEG-4 I-VOP and one P-VOP, a VP8 and a VP9 key and inter frame, an
   MPEG-2 I, P and B picture, a Sorenson Spark (640x480) and an H.263
   (704x576) I and P picture, a 640x480 MS MPEG-4 v3 I and P, WMV7 P and
   WMV8 I and P picture, and a frame of the YUV4MPEG2, the MPEG-2
   elementary stream, the Sorenson FLV, the DIV3 AVI and the WMV8
   ``.wmv`` readers.
8. the rest of the public surface: the CLI's device-stage table
   (``cli._profile_stages``: front-end, match and the full step as
   cumulative prefixes, each the device busy of warm calls under
   ``torch.profiler``) on the fixture engine in both ICP settings, every
   row positive and none below the one before by more than 0.01 ms, K1
   and K2 launched once and K3 ``EXPECT_NN`` times a call of the match
   and full rows, and the full row within 10% of ``profile_reco``'s device
   busy of whole recognitions in this process; ``recon --profile`` and
   ``track --profile`` on phase 4d's scan package print the three rows;
   ``ObjReco.compute_pose_epnp`` on the fixture's model depth at a known
   pose and at the match offset, and on JAX's planar case, against the
   JAX package's poses (``EXPECT_EPNP``); ``draw_response``, ``blit_template`` and
   ``save_ply`` (from CUDA tensors) against the sha256 of the JAX
   package's outputs (``EXPECT_VISUAL_SHA256``).

9. the kernel lab (``fealess_tpu_torch.apps.kernel_lab``, kernels L1-L4
   of ``ops/lab.py``, the counterparts of ``benchmarks/kernel_lab.py``'s
   Pallas calls): all seven of its runs on the lab's inputs (``coarse``,
   ``local2`` and ``nn``: each variant's graph time beside K1, K2 or K3 on
   the same inputs, and its bound; ``topk``, ``frontend``, ``local`` and
   ``local3``: the flat and per-row exact top-k, the front end at its
   working types, K2 behind the table gather and behind the real front
   end, each row's graph time, K2's rows with K2's bound), with
   ``score.local_scores`` required to launch in ``local`` and in
   ``local3``; the top-k on the lab's scores and on a tie-heavy input
   (integer scores, most -inf), the three front-end rows and K2 on the
   ``local`` and ``local3`` paths bitwise equal to the same functions on
   CPU copies of the inputs (K2 to its twin; the top-k also to numpy's
   stable argsort); then L1 (every mode) and L2 (both settings)
   bitwise equal to their twins on the lab's coarse inputs and edge cases
   (``lab_coarse_cases``: odd bucket counts, Wd = 37, Hd = 1,
   featureless templates, every feature at the largest offsets, 4096
   feature slots on u8 up to 255, 300 features a bucket on planes all
   255, misaligned planes), L3 (its four
   settings) on ``lab_local_cases`` (negative and border origins, Wd =
   125, misaligned planes, 4096 slots, K = 1 and 0), L4 against its twin
   and K3 by the lab's near-tie rule on ``lab_nn_cases`` (16384 x 16384,
   duplicates across every 2048-row tile whose first index must win,
   ragged counts, other tiles); L4's operand kernel bitwise equal to its
   twin (TF32 rounding edges included) and ``HGMMA`` (``wgmma``) in its
   kernel's SASS where ``cuobjdump`` is present; every exact L1/L2/L3 run
   bitwise equal to K1/K2 on the same inputs; and each L kernel, its twin
   and L4's library call (``torch.cdist`` and a min) timed, L4 also at
   longer reference chunks.

Each path of phases 4-4c, 6, 7 (7e and 7f included) and 8 runs with the
kernels' launch counters set to 0 just before it and read just after;
every kernel must have run on the paths that reach it; phase 9 counts the
lab's path on its own.
The line before the last is a JSON object with one entry per kernel
(``ops/_build.KERNELS``; K1-K3's launches summed over the paths of phases
4-8 and the 2-way shard case under ``cases``, K2's also the lab's K2 rows
under ``cases`` and its launches on the lab's path as ``lab_launches``;
L1-L4's launches from the lab's path and each variant's times under
``cases``); the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero without printing that line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
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

# Training and the CLI (phase 4d), from the JAX package on the CPU on the
# scan package of fixture.write_scan_package (4 panned fixture frames):
# the sha256 of the linemod_templates.yml that its ``train`` writes (the
# port's FileStorage writer gives the same bytes), and its ``recon`` JSON
# lines with default flags: per frame the similarity, t (mm) and ICP mean
# distance, rotation the identity.  Forced ICP on frame 0 is phase 4's (b).
TRAIN_FRAMES = 4
EXPECT_TRAIN_SHA256 = ("8c754bfc6dee4759eaa62d5e642a0709"
                       "5176e3ac8354f10a600c09fea6c8e979")
EXPECT_CLI = [(100.0, (-3.75623, -3.58265, -2.09906), 0.38305),
              (100.0, (2.47599, 2.45024, 0.29974), 0.44106),
              (100.0, (2.44607, 2.51570, -0.79999), 0.33400),
              (100.0, (8.64415, 2.46295, 0.10028), 0.33718)]
CLI_T_TOL_MM, CLI_DIST_TOL = 0.05, 1e-3
TRAIN_TIMED = 3        # timed add_templates_batched calls / artifact loads
# The single-core C++ reference's training rate (BASELINE.md:46-50: the
# reference's addTemplate loop over 30 rendered views).
CPP_TEMPLATES_PER_S = 27.8

# Phase 6 (the parallel layer): every process group's timeout, the
# parent's wait on its two spawned ranks, timed calls per path, and the
# sharded ICP's tolerance against the single-device ICP
# (tests/test_parallel.py:80-84).
PARALLEL_TIMEOUT_S = 60
CHILD_WAIT_S = 300
PARALLEL_REPS = 10
ICP_R_TOL, ICP_T_TOL_MM = 1e-5, 1e-3
MATCH_FIELDS = ("x", "y", "similarity", "template_slot", "class_idx",
                "template_idx", "valid")

# Phase 7 (camera widths and frame input): the shapes on which ops/resize
# on the card is held to its CPU run (camera profiles to the 640 width,
# other downscales, 2-D upscales); a 1280x720 camera resizes to 640x360
# and pads to these processing dims, where the JAX package on the CPU
# gives the native match (237, 157), similarity 100.0 and the native pose
# (default ICP, both the 2x2-replicated 1280x960 scene and its top 720
# rows); the Paeth-filtered series the CLI reads, and timed PNG reads.
RESIZE_SHAPES = [((1280, 960), (640, 480)), ((1280, 720), (640, 360)),
                 ((1920, 1080), (640, 360)), ((848, 480), (640, 362)),
                 ((1024, 768), (640, 480)), ((1000, 700), (640, 448)),
                 ((1280, 800), (640, 400)), ((640, 480), (480, 360)),
                 ((480, 270), (240, 135)), ((320, 240), (640, 480)),
                 ((300, 240), (641, 480)), ((320, 240), (641, 480))]
EXPECT_720_DIMS = (400, 640)
SERIES_FRAMES = 8
PNG_TIMED = 10
# Phase 7d (frame input): the committed JPEG/BMP files, their cv2 digests
# and the JAX CLI's recon lines (tests/make_torch_frames.py writes them
# with cv2 and the JAX package on the CPU), the acq clouds' limit against
# the CPU call, and timed decodes.
FRAMES_DIR = os.path.join(REPO, "tests", "data", "torch_frames")
# Phase 7e (persistence): the JAX package's save_bank of the fixture bank
# and its leaves' digests (tests/make_torch_ckpt.py writes them with JAX
# and orbax on the CPU).
CKPT_DIR = os.path.join(REPO, "tests", "data", "torch_ckpt", "fixture_1024")
# Phase 7e (cv::FileStorage forms): the sha256 of the JAX writer's XML and
# JSON of the fixture bank (tests/make_torch_ckpt.py records them with JAX
# and cv2 on the CPU); load_linemod is timed over FILESTORAGE_TIMED calls
FILESTORAGE_DIGESTS = os.path.join(REPO, "tests", "data", "torch_ckpt",
                                   "filestorage.json")
FILESTORAGE_TIMED = 3
VIDEO_DIR = os.path.join(REPO, "tests", "data", "torch_video")
VP8_DIR = os.path.join(REPO, "tests", "data", "torch_vp8")
VP9_DIR = os.path.join(REPO, "tests", "data", "torch_vp9")
MPEG2_DIR = os.path.join(REPO, "tests", "data", "torch_mpeg2")
RAW_DIR = os.path.join(REPO, "tests", "data", "torch_raw")
DEMUX_DIR = os.path.join(REPO, "tests", "data", "torch_demux")
H263_DIR = os.path.join(REPO, "tests", "data", "torch_h263")
MSMPEG4_DIR = os.path.join(REPO, "tests", "data", "torch_msmpeg4")
WMV2_DIR = os.path.join(REPO, "tests", "data", "torch_wmv2")
CLOUD_TOL_MM = 1e-3
DECODE_TIMED = 10

# Phase 8 (the rest of the public surface).  The device-stage table's rows
# are cumulative prefixes; device busy repeats within 0.01 ms (PERF.md §5),
# so no row may fall below the one before it by more; its "full" row (the
# step without the result's fetch) against profile_reco's device busy of
# whole recognitions over PROFILE_FRAMES frames in the same process.
STAGE_ROWS = ["frontend(quant+planes)", "match(front+score+topk+refine16)",
              "full(match+icp_refine)"]
STAGE_SLACK_MS = 0.01
PROFILE_FRAMES = 5
FULL_TOL = 0.10
# compute_pose_epnp on the fixture's model depth features/depth/0.png,
# (initial rotation, t, match offset): R = 0.3 rad about y at 700 mm with
# no offset, and the identity at 700 mm at the match offset (237, 157);
# and JAX's own planar case (tests/test_misc_parity.py: a tilted plane in
# a 240x160 box, identity pose, K 608 608 120 80), which JAX's test holds
# within 1e-2 of the identity and 5 mm; the JAX package's poses on the CPU
# (cv2 5.0.0), rows of the 3x4.
EPNP_CASES = {"known_pose": ([[0.955336489125606, 0.0, 0.29552020666134],
                              [0.0, 1.0, 0.0],
                              [-0.29552020666134, 0.0, 0.955336489125606]],
                             (0.0, 0.0, 700.0), (0, 0)),
              "match_offset": ([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                                [0.0, 0.0, 1.0]], (0.0, 0.0, 700.0),
                               (237, 157))}
EXPECT_EPNP = {
    "known_pose": [[0.9553365111351013, 1.0552165363719723e-08,
                    0.295520156621933, 2.9824454941262957e-06],
                   [-1.9771491110986972e-08, 1.0, 2.820877575970826e-08,
                    -1.95110919776198e-06],
                   [-0.295520156621933, -3.2791749760008315e-08,
                    0.9553365111351013, 700.0]],
    "planar": [[1.0, 0.0, 0.0, 2.4345231395273004e-06],
               [0.0, 1.0, 0.0, -1.3412757198238978e-06],
               [0.0, 0.0, 1.0, -2.497754621799686e-06]],
    "match_offset": [[0.9185789823532104, -0.06059134006500244,
                      0.3905654549598694, 273.93096923828125],
                     [-0.06186746433377266, 0.9539545774459839,
                      0.29350146651268005, 179.65245056152344],
                     [-0.3903653621673584, -0.2937675714492798,
                      0.8725339770317078, 717.9130249023438]]}
EPNP_ROT_TOL_DEG = 1e-3
EPNP_T_TOL_MM = 1e-3
# sha256 of the JAX package's visualize outputs on the CPU (cv2.circle):
# the fixture scene with template 0's features drawn, the template crop
# blitted, and save_ply of (u, v, depth) points of the scene's window
# [150:330, 230:440] (every 97th row NaN), plain and with colours and a
# depth > 0 mask (points written, sha256).
EXPECT_VISUAL_SHA256 = {
    "draw t5":
        "82ae5092b8545243d2ada8c76335e0f356648cf98231f7a36e2195525cda1097",
    "draw t8 level 1":
        "37fff75d95b1ed2f142b45c6719fdcc845fdce5b75502997e79e1d678f071fa0",
    "draw gray":
        "73bceb12f153e54b0934ce9ed117caa7dec36397f1a7f41f87a7f88302738c91",
    "blit":
        "41db2a88732da885eea384d5d4ccadb3645f6cb187246bdae010ebcbd75fab48",
    "ply": (37410, "30ba8aa6de6340f3fc7ed618f6fd278792ba3464f1f91a081be578"
                   "968ad3b150"),
    "ply colors valid": (37800, "d6f3a447f916568ae03fe86cd48ff3273151255db"
                                "6bdb3ccca4fb0f663bdea5b"),
}

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


def same_view(got, want) -> bool:
    import numpy as np
    if got is None:
        return False
    if ((got.width, got.height, got.offset_x, got.offset_y)
            != (want.width, want.height, want.offset_x, want.offset_y)
            or not np.array_equal(got.pose, want.pose)):
        return False
    return all(a.shape == b.shape and np.array_equal(a, b)
               for fa, fb in zip(got.features, want.features)
               for a, b in zip(fa, fb))


def run_cli(argv):
    """(return code, stdout lines) of one in-process CLI call."""
    import contextlib
    import io
    from fealess_tpu_torch.apps import cli
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue().splitlines()


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def nn_cases(model, ref):
    """K3's cases on one refine's clouds (queries ``model``, reference set
    ``ref``): the clouds as they are; a reference set with every row twice
    (exact ties half a set apart); the same rows with each chunk boundary b
    of the kernel's split straddled by a duplicate (row b = row b - 1, and
    a query there, whose first minimum b - 1 the twin is checked to give);
    ragged counts (queries not a multiple of the query tile, references not
    a multiple of the chunk, fewer references than one chunk, one
    reference, fewer queries than one tile); and PAD_COORD rows in both
    sets, a run of them across a chunk boundary."""
    import torch
    from fealess_tpu_torch import icp
    from fealess_tpu_torch.ops import nn
    nq, nr = model.shape[0], ref.shape[0]
    sms = torch.cuda.get_device_properties(ref.device).multi_processor_count
    nchunks, chunk = nn.chunk_plan(nq, nr, sms)
    check(nchunks > 1, f"K3 splits {nr} rows into {nchunks} chunk")
    half = nr // 2
    bounds = list(range(chunk, nr, chunk))
    straddle = ref.clone()
    for b in bounds:
        straddle[b] = straddle[b - 1]
    planted = model.clone()
    planted[:len(bounds)] = straddle[[b - 1 for b in bounds]]
    want = nn.nearest_neighbor_plain(planted, straddle)[0][:len(bounds)]
    check(want.tolist() == [b - 1 for b in bounds],
          "K3 straddle case: the twin's first minima are not b - 1")
    pad_ref, pad_q = ref.clone(), model.clone()
    pad_ref[bounds[0] - 300:bounds[0] + 200] = icp.PAD_COORD
    pad_ref[-100:] = icp.PAD_COORD
    pad_q[-300:] = icp.PAD_COORD
    ragged_q = model[:nq - 77].contiguous()
    cases = [(model, ref),
             (model, torch.cat([ref[:half], ref[:half]]).contiguous()),
             (planted, straddle),
             (ragged_q, ref[:nr - 333].contiguous()),
             (ragged_q, ref[:300].contiguous()),
             (model, ref[5:6].contiguous()),
             (model[:100].contiguous(), ref),
             (pad_q, pad_ref)]
    return [(nn.nearest_neighbor, nn.nearest_neighbor_plain, c)
            for c in cases]


def coarse_cases(planes, table):
    """K1's cases on one frame's coarse planes and the bank's coarse table
    (the path's own first): the table's features replaced by random ones
    (distinct templates, each reading its own plane rows, where the
    fixture's 1024 are identical), widths not a multiple of the 8
    positions a thread owns (Wd = 37), one row (Hd = 1), every third
    template with no valid feature, every feature at the largest offsets
    (rx = ry = NB - 1, the bottom and right edges), 4096 features a
    template on u8 values up to 255 (so the packed 16-bit lanes must be
    flushed), and planes that start 1, 2 and 3 bytes past a 4-byte
    boundary."""
    import torch
    from fealess_tpu_torch.ops import score
    c, hd, wd = planes.shape
    nb = table["bstart"].shape[1] - 1
    g = torch.Generator(device=planes.device).manual_seed(6)
    none = {k: v.clone() for k, v in table.items()}
    none["bstart"][::3] = 0
    edge = {k: v.clone() for k, v in table.items()}
    nvalid = edge["bstart"][:, -1:].clone()
    for key in ("ry", "rx"):
        edge[key][:] = nb - 1
    edge["bstart"][:] = 0
    edge["bstart"][:, -1:] = nvalid
    n, nf = 8, 4096

    def rand(high, size, dtype=torch.int32):
        return torch.randint(0, high, size, generator=g, dtype=dtype,
                             device=planes.device)

    wide = {"c": rand(c, (n, nf)), "ry": rand(nb, (n, nf)),
            "rx": rand(nb, (n, nf)),
            "bstart": torch.full((n, nb + 1), nf, dtype=torch.int32,
                                 device=planes.device)}
    loud = rand(256, planes.shape, torch.uint8)
    shape = table["c"].shape
    distinct = {"c": rand(c, shape), "ry": rand(nb, shape),
                "rx": rand(nb, shape), "bstart": table["bstart"]}
    flat = torch.cat([planes.new_zeros(3), planes.reshape(-1)])
    cases = [(planes, table), (planes, distinct),
             (planes[:, :, :37].contiguous(), table),
             (planes[:, :1].contiguous(), table), (planes, none),
             (planes, edge), (loud, wide)]
    cases += [(flat[k:k + planes.numel()].view(planes.shape), table)
              for k in (1, 2, 3)]
    return [(score.coarse_scores, score.coarse_scores_plain, a)
            for a in cases]


def local_cases(planes, table, tslot, x, y, width, height, nfeat, level, t,
                offset, size):
    """K2's cases on one refinement level's inputs (the path's own first):
    the fused entry (``score.local_refine``) on all-zero planes (every
    window ties, so the first maximum is cell 0), on 4096 features a row
    with u8 values up to 255 (the packed 16-bit lanes must be flushed), on
    planes 1, 2 and 3 bytes past a 4-byte boundary, on planes 125 columns
    wide (Wd not a multiple of 4, windows past it), for K = 1 and K = 0,
    and on positions whose clamp hits the border from below (x = y = 0),
    from above (x = y = 10**5) and from both sides (a slot whose template
    is wider and taller than the level, where the lower bound wins); then
    the same kernel with the origins given (``score.local_scores``) on the
    candidates' windows and on windows shifted 20 cells out of the
    plane."""
    import torch
    from fealess_tpu_torch.ops import score
    c, hd, wd = planes.shape
    dev = planes.device
    nb = table["bstart"].shape[1] - 1
    g = torch.Generator(device=dev).manual_seed(7)

    def rand(high, shape, dtype=torch.int32):
        return torch.randint(0, high, shape, generator=g, dtype=dtype,
                             device=dev)

    rest = (width, height, nfeat, level, t, offset, size)
    fused = lambda *a: (score.local_refine, score.local_refine_plain, a)
    n, nf = min(8, width.shape[0]), 4096
    wide = {"c": rand(c, (n, nf)), "ry": rand(nb, (n, nf)),
            "rx": rand(nb, (n, nf)),
            "bstart": torch.full((n, nb + 1), nf, dtype=torch.int32,
                                 device=dev)}
    flat = torch.cat([planes.new_zeros(3), planes.reshape(-1)])
    h, w = size
    k = tslot.shape[0]
    edge_x = (torch.arange(k, device=dev) % 2 * 10 ** 5).to(torch.int32)
    big = tslot[1::4]
    width_big, height_big = width.clone(), height.clone()
    width_big[big, level] = w
    height_big[big, level] = h
    cases = [fused(planes, table, tslot, x, y, *rest),
             fused(torch.zeros_like(planes), table, tslot, x, y, *rest),
             fused(rand(256, planes.shape, torch.uint8), wide, tslot % n, x,
                   y, width[:n].contiguous(), height[:n].contiguous(),
                   nfeat[:n].contiguous(), *rest[3:])]
    cases += [fused(flat[i:i + planes.numel()].view(planes.shape), table,
                    tslot, x, y, *rest) for i in (1, 2, 3)]
    cases += [fused(planes[:, :, :125].contiguous(), table, tslot, x, y,
                    *rest),
              fused(planes, table, tslot[:1], x[:1], y[:1], *rest),
              fused(planes, table, tslot[:0], x[:0], y[:0], *rest),
              fused(planes, table, tslot, edge_x, edge_x.flip(0), *rest),
              fused(planes, table, tslot, x, y, width_big, height_big,
                    *rest[2:])]
    table_k, px0, py0, _, _ = score.local_window_inputs(
        table, tslot, x, y, width, height, level, t, size)
    cases += [(score.local_scores, score.local_scores_plain,
               (planes, table_k, px0, py0)),
              (score.local_scores, score.local_scores_plain,
               (planes, table_k, px0 - 20, py0 - 20))]
    return cases


def same_coarse_candidates(eng, planes, tables, where: str) -> None:
    """``detector.coarse_candidates`` on the card (K1, the gates and the
    top-K) returns exactly what it returns on CPU copies of its inputs
    (the twin and the same gates and top-K on the CPU)."""
    import torch
    from fealess_tpu_torch import detector as td
    det = eng.cfg.detector
    thr = eng.cfg.matching_threshold
    got = td.coarse_candidates(eng.bank, planes, thr, det, tables)
    cpu = [(d.cpu(), hw) for d, hw in planes]
    cpu_tables = [None if t is None else {k: v.cpu() for k, v in t.items()}
                  for t in tables]
    want = td.coarse_candidates(eng.bank.to("cpu"), cpu, thr, det,
                                cpu_tables)
    for name, a, b in zip(("score", "slot", "x", "y"), got, want):
        check(torch.equal(a.cpu(), b), f"coarse_candidates ({where}): "
              f"{name} differs from the CPU's")
    live = int(torch.isfinite(want[0]).sum())
    print(f"coarse_candidates ({where}): score, slot, x, y equal to the "
          f"CPU's on {want[0].numel()} candidates ({live} live)")


def kernel_cases(eng, bgr_np, depth_np, cam):
    """Each kernel's cases at the shapes ``eng.recognition`` gives it on
    this frame, {name: [(kernel, twin, args)]}, and the refine's ICP pair
    count: K1 on the coarse level and the edge cases of
    :func:`coarse_cases`, K2 on the level-0 refinement of the top
    candidates and the edge cases of :func:`local_cases`, K3 on the best
    match's clouds and the edge cases of :func:`nn_cases`.  The first
    case of each kernel is the path's own.  On the way,
    :func:`same_coarse_candidates` holds the coarse stage on the card to
    the same stage on the CPU."""
    from fealess_tpu_torch import detector as td
    from fealess_tpu_torch import pipeline
    det = eng.cfg.detector
    bgr, depth, scene_k = eng._prepare_frame(bgr_np, depth_np, cam)
    planes = td.response_planes(td.quantized_pyramid(bgr, depth, det), det)
    tables = eng._kernels
    _, tslot, x, y = td.coarse_candidates(eng.bank, planes,
                                          eng.cfg.matching_threshold, det,
                                          tables)
    t0 = det.t_at_level[0]
    level0 = (planes[0][0], tables[0], tslot, x, y, eng.bank.width,
              eng.bank.height, eng.bank.num_features(), 0, t0,
              td._offset(t0), planes[0][1])
    matches = td.match_from_planes(eng.bank, planes,
                                   eng.cfg.matching_threshold, det, tables)
    cand = pipeline.candidate_inputs(eng.bank, eng._model_depth_dev,
                                     eng._origins_dev,
                                     matches.template_slot[0], eng.cfg)
    crop = eng.cfg.refine_crop
    ref, model, pair_mask, _, _ = pipeline.paired_clouds(
        depth, scene_k, *cand[:6], matches.x[0], matches.y[0], eng.cfg,
        crop, crop)
    same_coarse_candidates(eng, planes, tables,
                           f"{eng.bank.capacity}-slot bank")
    return {
        "coarse_scores": coarse_cases(planes[det.pyramid_levels - 1][0],
                                      tables[det.pyramid_levels - 1]),
        "local_refine": local_cases(*level0),
        "nearest_neighbor": nn_cases(model, ref),
    }, int(pair_mask.sum())


def hold_to_twins(cases, errs, where: str) -> None:
    """Every case's kernel against its twin, every output bitwise (K1's
    scores; K2's scores, x, y, best sum and feature count; K3's indices
    and d2); ``errs[name]`` keeps the largest |kernel - twin| over every
    call."""
    import torch

    def shapes(args):
        return [{k: tuple(v.shape) for k, v in a.items()}
                if isinstance(a, dict) else tuple(a.shape)
                for a in args if isinstance(a, (dict, torch.Tensor))]

    for name, runs in cases.items():
        errs.setdefault(name, 0.0)
        for i, (kernel, plain, args) in enumerate(runs):
            got = kernel(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for j, (a, b) in enumerate(zip(got, want)):
                where_j = (f"{name} ({where}) case {i} "
                           f"{kernel.__name__} output {j}")
                check(a.dtype == b.dtype and a.shape == b.shape,
                      f"{where_j}: {a.dtype}{tuple(a.shape)} vs "
                      f"{b.dtype}{tuple(b.shape)}")
                check(torch.equal(a, b), f"{where_j}: differs at "
                      f"{int((a != b).sum())} entries")
                if a.numel():
                    err = (a.double() - b.double()).abs().max().item()
                    errs[name] = max(errs[name], err)
        print(f"kernel {name} ({where}): equal to its twin on {len(runs)} "
              f"case(s), inputs " + ", ".join(
                  str(shapes(args)) for _, _, args in runs) +
              f", max_abs_err {errs[name]}")


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


# -- phase 6: the parallel layer ------------------------------------------


def _forced(icp, mode):
    """The engine's ICP config in ``mode`` with iterations forced (b)."""
    import dataclasses
    return dataclasses.replace(
        icp, mode=mode, dist_mean_threshold=FORCED["icp_dist_mean_threshold"],
        dist_diff_threshold=FORCED["icp_dist_diff_threshold"])


def parallel_inputs(eng, bgr_np, depth_np, cam):
    """Phase 6's frames and clouds on the card: the batch (the fixture
    scene, the two-instance scene and pan frames 1 and 2), K, and phase 4
    (b)'s ICP inputs (the best match's paired clouds with the plane mode's
    normals)."""
    import dataclasses

    import torch
    from fealess_tpu_torch import detector as td
    from fealess_tpu_torch import pipeline
    from fealess_tpu_torch.apps import fixture
    frames = [(bgr_np, depth_np),
              fixture.two_instance_scene(bgr_np, depth_np)]
    frames += fixture.pan(bgr_np, depth_np, 3)[1:]
    prepped = [eng._prepare_frame(b, d, cam) for b, d in frames]
    bgr_b = torch.stack([p[0] for p in prepped])
    depth_b = torch.stack([p[1] for p in prepped])
    scene_k = prepped[0][2]
    det = eng.cfg.detector
    m = td.match_bank(eng.bank, bgr_b[0], depth_b[0],
                      eng.cfg.matching_threshold, det, kernels=eng._kernels)
    cand = pipeline.candidate_inputs(eng.bank, eng._model_depth_dev,
                                     eng._origins_dev, m.template_slot[0],
                                     eng.cfg)
    plane = dataclasses.replace(eng.cfg, icp=_forced(eng.cfg.icp,
                                                     "point_to_plane"))
    crop = eng.cfg.refine_crop
    ref, model, mask, normals, _ = pipeline.paired_clouds(
        depth_b[0], scene_k, *cand[:6], m.x[0], m.y[0], plane, crop, crop)
    return bgr_b, depth_b, scene_k, {"ref": ref, "model": model,
                                     "mask": mask, "normals": normals}


def run_icp(sharded, clouds, icp, mesh=None):
    """One ICP of ``clouds``: the sharded entry on ``mesh`` or the
    single-device one, by ``icp.mode``."""
    from fealess_tpu_torch import icp as ticp
    from fealess_tpu_torch.parallel import sharded_icp
    c = clouds
    if icp.mode == "point_to_plane":
        if sharded:
            return sharded_icp.icp_plane_sharded(
                c["ref"], c["normals"], c["model"], c["mask"], icp, mesh)
        return ticp.icp_point_to_plane(c["ref"], c["normals"], c["model"],
                                       c["mask"], icp)
    if sharded:
        return sharded_icp.icp_sharded(c["ref"], c["model"], c["mask"], icp,
                                       mesh)
    return ticp.icp_point_to_point(c["ref"], c["model"], c["mask"], icp)


def flat(prefix, tree):
    """A dataclass tree's tensor leaves keyed by field path."""
    import dataclasses

    import torch
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if not dataclasses.is_dataclass(tree):
        return {}
    out = {}
    for f in dataclasses.fields(tree):
        out.update(flat(f"{prefix}.{f.name}", getattr(tree, f.name)))
    return out


def diff_flat(fa: dict, fb: dict) -> list:
    """The keys where two :func:`flat` dicts differ (dtype, shape or any
    bit, or a key missing on one side)."""
    import torch
    return [k for k in fa if k not in fb or fa[k].dtype != fb[k].dtype
            or not torch.equal(fa[k], fb[k].to(fa[k].device))] + sorted(
                set(fb) - set(fa))


def same_bits(a, b) -> list:
    """The field paths where two dataclass trees' tensors differ."""
    return diff_flat(flat("", a), flat("", b))


def icp_close(got, want) -> bool:
    """Rotation within ICP_R_TOL, translation within ICP_T_TOL_MM,
    iterations and ok equal (tests/test_parallel.py:80-84)."""
    return ((got.r - want.r).abs().max().item() <= ICP_R_TOL
            and (got.t - want.t).abs().max().item() <= ICP_T_TOL_MM
            and int(got.iterations) == int(want.iterations)
            and bool(got.ok) == bool(want.ok))


def sync(dev) -> None:
    """Wait for ``dev`` (phase 6 also runs on CPU tensors, rehearsed
    where there is no card)."""
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_ms(fns, reps: int, dev) -> list:
    """Mean host milliseconds per call of each of ``fns``, each call
    synchronised, after one warm-up each; the calls take turns (a, b, b,
    a, ...) so that the host's drift falls on both."""
    total = [0.0] * len(fns)
    for fn in fns:
        fn()
        sync(dev)
    for i in range(reps):
        for k in (range(len(fns)) if i % 2 == 0
                  else reversed(range(len(fns)))):
            t0 = time.perf_counter()
            fns[k]()
            sync(dev)
            total[k] += time.perf_counter() - t0
    return [t * 1e3 / reps for t in total]


def bank_halves(eng, bgr, depth):
    """The frame's response planes and each half of the bank as a 2-way
    split gives it to a rank: [(slot offset, bank slice, tables
    slice)]."""
    from fealess_tpu_torch import detector as td
    det = eng.cfg.detector
    planes = td.response_planes(td.quantized_pyramid(bgr, depth, det), det)
    half = eng.bank.capacity // 2
    return planes, [(lo, eng.bank.slots(lo, lo + half),
                     [{k: v[lo:lo + half].contiguous() for k, v in t.items()}
                      for t in eng._kernels]) for lo in (0, half)]


def emulate_two_shards(eng, bgr, depth):
    """The 2-rank sharded match in one process: ``match_from_planes`` on
    each half of the bank (slots re-offset), the two lists concatenated in
    rank order, then ``_merge_matches``."""
    import torch
    from fealess_tpu_torch import detector as td
    from fealess_tpu_torch.parallel import mesh as mesh_mod
    from fealess_tpu_torch.parallel.sharded_match import _merge_matches
    det = eng.cfg.detector
    planes, halves = bank_halves(eng, bgr, depth)
    lists = []
    for lo, part, tables in halves:
        m = td.match_from_planes(part, planes, eng.cfg.matching_threshold,
                                 det, tables)
        m.template_slot = m.template_slot + lo
        lists.append(m)
    both = mesh_mod.tree_map(lambda *xs: torch.cat(xs), *lists)
    return _merge_matches(both, det.max_candidates)


def shard_cases(eng, bgr, depth, clouds):
    """Each kernel's cases at the shapes a 2-way split gives it: K1 on
    each 512-row half of the coarse table, K2 on each half-bank's own
    candidates (its coarse top-K, level 0), K3 on each half of the
    queries against the whole reference set (8192 x 16384)."""
    from fealess_tpu_torch import detector as td
    from fealess_tpu_torch.ops import nn, score
    det = eng.cfg.detector
    planes, halves = bank_halves(eng, bgr, depth)
    lc = det.pyramid_levels - 1
    t0 = det.t_at_level[0]
    cases = {"coarse_scores": [], "local_refine": [], "nearest_neighbor": []}
    for _, part, tables in halves:
        cases["coarse_scores"].append(
            (score.coarse_scores, score.coarse_scores_plain,
             (planes[lc][0], tables[lc])))
        _, tslot, x, y = td.coarse_candidates(
            part, planes, eng.cfg.matching_threshold, det, tables)
        cases["local_refine"].append(
            (score.local_refine, score.local_refine_plain,
             (planes[0][0], tables[0], tslot, x, y, part.width, part.height,
              part.num_features(), 0, t0, td._offset(t0), planes[0][1])))
    n = clouds["model"].shape[0] // 2
    for lo in (0, n):
        cases["nearest_neighbor"].append(
            (nn.nearest_neighbor, nn.nearest_neighbor_plain,
             (clouds["model"][lo:lo + n].contiguous(), clouds["ref"])))
    return cases


def parallel_world1(eng, card, bgr_b, depth_b, scene_k, clouds, counts):
    """Phase 6a: every parallel entry point at world size 1 over NCCL (gloo
    for CPU tensors) in this process.  Returns the single-process
    references that 6b holds its two ranks to: (per-frame RecoSteps
    stacked, {mode: IcpResult})."""
    import dataclasses
    import datetime

    import torch
    import torch.distributed as dist
    from fealess_tpu_torch import detector as td
    from fealess_tpu_torch import pipeline
    from fealess_tpu_torch.parallel import batch_recon
    from fealess_tpu_torch.parallel import mesh as mesh_mod
    from fealess_tpu_torch.parallel import sharded_match
    zero_counts, read_counts, path_launches = counts
    det, thr = eng.cfg.detector, eng.cfg.matching_threshold
    dev = bgr_b.device
    tmp = tempfile.TemporaryDirectory()
    store = os.path.join(tmp.name, "store")
    cuda = dev.type == "cuda"
    dist.init_process_group(
        "nccl" if cuda else "gloo", init_method=f"file://{store}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=PARALLEL_TIMEOUT_S),
        **({"device_id": dev} if cuda else {}))
    try:
        mesh_t = mesh_mod.make_mesh([("t", 1)], device_type=dev.type)
        for i, name in ((0, "fixture"), (1, "two-instance")):
            zero_counts()
            got = sharded_match.match_bank_sharded(
                eng.bank, bgr_b[i], depth_b[i], thr, det, mesh_t,
                tables=eng._kernels)
            read_counts(f"sharded match, world 1, {name} scene")
            want = td.match_bank(eng.bank, bgr_b[i], depth_b[i], thr, det,
                                 kernels=eng._kernels)
            diff = same_bits(got, sharded_match._merge_matches(
                want, det.max_candidates))
            check(not diff, f"6a match ({name}): {diff} differ from the "
                  f"merged match_bank")
            check(all(getattr(got, f)[0] == getattr(want, f)[0]
                      for f in MATCH_FIELDS), f"6a match ({name}): top-1 "
                  f"differs from match_bank's")
            print(f"6a sharded match (world 1, {name} scene): equal to "
                  f"_merge_matches(match_bank) in every field, top-1 "
                  f"({int(got.x[0])}, {int(got.y[0])}) slot "
                  f"{int(got.template_slot[0])} equal to match_bank's; "
                  f"fields differing from match_bank itself (its "
                  f"duplicates keep their score, the merge scores them "
                  f"-inf): {same_bits(got, want)}")
        mesh_p = mesh_mod.make_mesh([("p", 1)], device_type=dev.type)
        want_icp = {}
        for mode in ("point_to_point", "point_to_plane"):
            icp = _forced(eng.cfg.icp, mode)
            zero_counts()
            got = run_icp(True, clouds, icp, mesh_p)
            read_counts(f"sharded ICP, world 1, {mode}")
            want_icp[mode] = run_icp(False, clouds, icp)
            diff = same_bits(got, want_icp[mode])
            check(not diff, f"6a ICP {mode}: {diff} differ")
            check(int(got.iterations) == EXPECT_ITERS["b"],
                  f"6a ICP {mode}: {int(got.iterations)} iterations")
            print(f"6a sharded ICP (world 1, {mode}, forced, "
                  f"{clouds['ref'].shape[0]} pairs): bitwise equal to the "
                  f"single-device ICP, {int(got.iterations)} iterations")
        mesh_d = mesh_mod.make_mesh([("d", 1)], device_type=dev.type)
        cfg_b = dataclasses.replace(eng.cfg, icp=_forced(eng.cfg.icp,
                                                         eng.cfg.icp.mode))
        args = (eng.bank, eng._model_depth_dev, eng._origins_dev, bgr_b,
                depth_b, scene_k, cfg_b)
        zero_counts()
        got = batch_recon.recognize_batch_sharded(*args, mesh_d,
                                                  kernels=eng._kernels)
        read_counts("sharded batch, world 1")
        want_batch = mesh_mod.stack_tree([pipeline.recognize_top1(
            eng.bank, eng._model_depth_dev, eng._origins_dev, bgr_b[i],
            depth_b[i], scene_k, cfg_b, kernels=eng._kernels)
            for i in range(bgr_b.shape[0])])
        diff = same_bits(got, want_batch)
        check(not diff, f"6a batch: {diff} differ")
        check(bool(got.valid.all()), f"6a batch: valid {got.valid}")
        xy = list(zip(got.match_x.tolist(), got.match_y.tolist()))
        print(f"6a recognize_batch_sharded (world 1, {bgr_b.shape[0]} "
              f"frames, forced ICP): bitwise equal to recognize_top1 frame "
              f"by frame; matches {xy}")
        n = bgr_b.shape[0]
        for name, want_n in (
                ("sharded match, world 1, fixture scene", [1, 1, 0]),
                ("sharded match, world 1, two-instance scene", [1, 1, 0]),
                ("sharded ICP, world 1, point_to_point", [0, 0, 9]),
                ("sharded ICP, world 1, point_to_plane", [0, 0, 9])):
            check(path_launches[name] == want_n,
                  f"{name}: launches {path_launches[name]}")
        got_n = path_launches["sharded batch, world 1"]
        check(got_n[:2] == [n, n] and got_n[2] > 0,
              f"sharded batch, world 1: launches {got_n}")
        # times: the sharded match and ICP against their single-device
        # functions, in turns (the collectives' and the merge's cost), the
        # batch's frames/s
        b0, d0 = bgr_b[0], depth_b[0]
        t_sh, t_one = host_ms([
            lambda: sharded_match.match_bank_sharded(
                eng.bank, b0, d0, thr, det, mesh_t, tables=eng._kernels),
            lambda: td.match_bank(eng.bank, b0, d0, thr, det,
                                  kernels=eng._kernels)], PARALLEL_REPS, dev)
        backend = dist.get_backend()
        print(f"time sharded match (world 1, {backend}): {t_sh:.3f} ms "
              f"against "
              f"match_bank {t_one:.3f} ms, {t_sh - t_one:+.3f} ms for the "
              f"all-gather and merge; mean of {PARALLEL_REPS} in turns "
              f"({card})")
        for mode in want_icp:
            icp = _forced(eng.cfg.icp, mode)
            t_sh, t_one = host_ms([
                lambda: run_icp(True, clouds, icp, mesh_p),
                lambda: run_icp(False, clouds, icp)], PARALLEL_REPS // 2,
                dev)
            print(f"time sharded ICP (world 1, {backend}, {mode}, forced): "
                  f"{t_sh:.3f} ms against the single-device ICP "
                  f"{t_one:.3f} ms, {t_sh - t_one:+.3f} ms for 10 "
                  f"iterations' all-reduces; mean of {PARALLEL_REPS // 2} "
                  f"in turns ({card})")
        flt = torch.zeros(16, device=dev)
        t_ar, = host_ms([lambda: dist.all_reduce(flt)], 5 * PARALLEL_REPS,
                        dev)
        print(f"time all_reduce (world 1, {backend}, 16 f32 on "
              f"{dev.type}): {t_ar:.4f} ms a call, synchronised; mean of "
              f"{5 * PARALLEL_REPS} ({card})")
        t_b, = host_ms([lambda: batch_recon.recognize_batch_sharded(
            *args, mesh_d, kernels=eng._kernels)], PARALLEL_REPS // 2, dev)
        print(f"time recognize_batch_sharded (world 1, {backend}, "
              f"{bgr_b.shape[0]} frames, forced ICP): {t_b:.3f} ms, "
              f"{bgr_b.shape[0] / t_b * 1e3:.3f} frames/s; mean of "
              f"{PARALLEL_REPS // 2} ({card})")
    finally:
        dist.destroy_process_group()
        tmp.cleanup()
    return want_batch, want_icp


def _two_rank_child(rank: int, tmp: str, device: str) -> None:
    """Phase 6b's rank ``rank`` of 2 (a spawned process): a gloo group
    over CUDA tensors on the one card, the bank from the parent's serving
    artifact; writes its results, launch counts and times to
    ``tmp/rank<rank>.pt``."""
    import dataclasses
    import datetime

    import torch
    import torch.distributed as dist
    sys.path.insert(0, REPO)
    from fealess_tpu_torch import config as cfg
    from fealess_tpu_torch import detector as td
    from fealess_tpu_torch.io.export import ServingArtifact
    from fealess_tpu_torch.ops import nn, score
    from fealess_tpu_torch.parallel import batch_recon
    from fealess_tpu_torch.parallel import mesh as mesh_mod
    from fealess_tpu_torch.parallel import sharded_match
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp}/store", rank=rank, world_size=2,
        timeout=datetime.timedelta(seconds=PARALLEL_TIMEOUT_S))
    counted = (score.coarse_scores, score.local_refine, nn.nearest_neighbor)
    out = {"launches": {}, "ms": {}}

    def counting(path, fn):
        for k in counted:
            k.launches = 0
        res = fn()
        sync(dev)
        out["launches"][path] = [k.launches for k in counted]
        return res

    def timed(path, fns, reps):
        dist.barrier()
        out["ms"][path] = host_ms(fns, reps, dev)

    try:
        eng = ServingArtifact(os.path.join(tmp, "artifact"), dev)
        inp = torch.load(os.path.join(tmp, "inputs.pt"))
        bgr_b, depth_b = inp["bgr"].to(dev), inp["depth"].to(dev)
        scene_k = inp["scene_k"].to(dev)
        clouds = {k: v.to(dev) for k, v in inp["clouds"].items()}
        det, thr = eng.cfg.detector, eng.cfg.matching_threshold
        mesh_t = mesh_mod.make_mesh([("t", 2)], device_type=dev.type)
        mesh_p = mesh_mod.make_mesh([("p", 2)], device_type=dev.type)
        mesh_d = mesh_mod.make_mesh([("d", 2)], device_type=dev.type)
        match = lambda: sharded_match.match_bank_sharded(  # noqa: E731
            eng.bank, bgr_b[0], depth_b[0], thr, det, mesh_t,
            tables=eng._kernels)
        out["match"] = flat("", counting("2-rank sharded match", match))
        for mode in ("point_to_point", "point_to_plane"):
            icp = cfg.IcpConfig(**inp["icp"][mode])
            res = counting(f"2-rank sharded ICP, {mode}",
                           lambda: run_icp(True, clouds, icp, mesh_p))
            out[f"icp_{mode}"] = flat("", res)
            timed(f"icp {mode}", [
                lambda: run_icp(True, clouds, icp, mesh_p),
                lambda: run_icp(False, clouds, icp)], PARALLEL_REPS // 2)
        cfg_b = dataclasses.replace(eng.cfg, icp=cfg.IcpConfig(
            **inp["icp"][eng.cfg.icp.mode]))
        batch = lambda: batch_recon.recognize_batch_sharded(  # noqa: E731
            eng.bank, eng._model_depth_dev, eng._origins_dev, bgr_b,
            depth_b, scene_k, cfg_b, mesh_d, kernels=eng._kernels)
        out["batch"] = flat("", counting("2-rank sharded batch", batch))
        # a sub-mesh of the first rank, which both ranks build: rank 0
        # matches on it alone, rank 1 is refused instead of waiting
        sub = mesh_mod.template_mesh(1, device_type=dev.type)
        try:
            out["submesh"] = flat("", sharded_match.match_bank_sharded(
                eng.bank, bgr_b[0], depth_b[0], thr, det, sub,
                tables=eng._kernels))
        except ValueError as e:
            out["submesh"] = str(e)
        timed("match", [match, lambda: td.match_bank(
            eng.bank, bgr_b[0], depth_b[0], thr, det,
            kernels=eng._kernels)], PARALLEL_REPS)
        timed("batch", [batch], PARALLEL_REPS // 2)
        flt = torch.zeros(16, device=dev)
        timed("all_reduce", [lambda: dist.all_reduce(flt)],
              5 * PARALLEL_REPS)
        out = mesh_mod.tree_map(lambda t: t.cpu(), out)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def parallel_two_ranks(eng, card, bgr_b, depth_b, scene_k, clouds,
                       want_batch, want_icp, path_launches) -> None:
    """Phase 6b: two spawned ranks share the card through a gloo group
    (NCCL refuses two ranks on one GPU); their kernels run on the card and
    only the collectives go through gloo.  The kernels were built in
    phase 2, so the children load the same library."""
    import dataclasses

    import torch
    import torch.multiprocessing as mp
    from fealess_tpu_torch import detector as td
    det = eng.cfg.detector
    with tempfile.TemporaryDirectory() as tmp:
        eng.export_artifact(os.path.join(tmp, "artifact"))
        torch.save({"bgr": bgr_b.cpu(), "depth": depth_b.cpu(),
                    "scene_k": scene_k.cpu(),
                    "clouds": {k: v.cpu() for k, v in clouds.items()},
                    "icp": {m: dataclasses.asdict(_forced(eng.cfg.icp, m))
                            for m in want_icp}},
                   os.path.join(tmp, "inputs.pt"))
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_two_rank_child,
                             args=(r, tmp, str(bgr_b.device)))
                 for r in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout=max(1.0, CHILD_WAIT_S
                                   - (time.perf_counter() - t0)))
        finally:
            hung = [p.pid for p in procs if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=30)
        check(not hung, f"6b: ranks {hung} still running after "
              f"{CHILD_WAIT_S} s")
        check(all(p.exitcode == 0 for p in procs),
              f"6b: exit codes {[p.exitcode for p in procs]}")
        print(f"6b: 2 spawned ranks (gloo over CUDA tensors, one card) "
              f"ran in {time.perf_counter() - t0:.1f} s")
        res = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
               for r in range(2)]
    dev = bgr_b.device
    want = flat("", emulate_two_shards(eng, bgr_b[0], depth_b[0]))
    from fealess_tpu_torch.parallel import sharded_match
    want_sub = flat("", sharded_match._merge_matches(td.match_bank(
        eng.bank, bgr_b[0], depth_b[0], eng.cfg.matching_threshold, det,
        kernels=eng._kernels), det.max_candidates))
    check(isinstance(res[0]["submesh"], dict)
          and not diff_flat(want_sub, res[0]["submesh"]),
          f"6b template_mesh(1): rank 0's match differs from the "
          f"single-device match: {res[0]['submesh']}")
    check("not in this mesh" in str(res[1]["submesh"]),
          f"6b template_mesh(1): rank 1 was not refused: "
          f"{res[1]['submesh']}")
    print(f"6b template_mesh(1) on 2 ranks: rank 0's sharded match "
          f"bitwise equal to _merge_matches(match_bank); rank 1 refused "
          f"({res[1]['submesh']})")
    single = flat("", td.match_bank(eng.bank, bgr_b[0], depth_b[0],
                                    eng.cfg.matching_threshold, det,
                                    kernels=eng._kernels))
    want_b = flat("", want_batch)
    for r, got in enumerate(res):
        g = got["match"]
        diff = diff_flat(want, g)
        check(not diff, f"6b rank {r} match: {diff} differ from the "
              f"one-process emulation")
        check(all(g[f".{f}"][0].item() == single[f".{f}"][0].item()
                  for f in MATCH_FIELDS), f"6b rank {r}: top-1 differs "
              f"from match_bank's")
        for mode, w in want_icp.items():
            i = {k: v.to(dev) for k, v in got[f"icp_{mode}"].items()}
            gi = type(w)(**{k[1:]: v for k, v in i.items()})
            check(icp_close(gi, w), f"6b rank {r} ICP {mode}: r "
                  f"{(gi.r - w.r).abs().max().item()} t "
                  f"{(gi.t - w.t).abs().max().item()} it "
                  f"{int(gi.iterations)}/{int(w.iterations)}")
        diff = diff_flat(want_b, got["batch"])
        check(not diff, f"6b rank {r} batch: {diff} differ from the "
              f"single-process batch")
        for path, n in got["launches"].items():
            path_launches[f"{path} (rank {r})"] = n
            print(f"launches on path {path} (rank {r}): K1/K2/K3 {n}")
        n = got["launches"]
        check(n["2-rank sharded match"] == [1, 1, 0]
              and all(n[f"2-rank sharded ICP, {m}"] == [0, 0, 9]
                      for m in want_icp)
              and n["2-rank sharded batch"][:2] == [2, 2]
              and n["2-rank sharded batch"][2] > 0,
              f"6b rank {r}: launches {n}")
    for mode, w in want_icp.items():
        g = res[0][f"icp_{mode}"]
        print(f"6b sharded ICP ({mode}, 2 ranks, {clouds['ref'].shape[0]} "
              f"pairs): |dr| {(g['.r'].to(dev) - w.r).abs().max().item():.3g}"
              f", |dt| {(g['.t'].to(dev) - w.t).abs().max().item():.3g} mm "
              f"from the single-device ICP, {int(g['.iterations'])} "
              f"iterations (equal)")
    print("6b sharded match (2 ranks): bitwise equal to the one-process "
          "emulation (match_from_planes on each half-bank, merged in rank "
          "order), top-1 equal to match_bank's; batch bitwise equal to the "
          "single-process batch on both ranks")
    n = bgr_b.shape[0]
    for r, got in enumerate(res):
        ms = got["ms"]
        print(f"time 2 ranks sharing one card (gloo collectives; not a "
              f"scaling figure), rank {r}, each against its own "
              f"single-device call in turns: sharded match "
              f"{ms['match'][0]:.3f} / match_bank {ms['match'][1]:.3f} ms, "
              f"sharded ICP point {ms['icp point_to_point'][0]:.3f} / "
              f"{ms['icp point_to_point'][1]:.3f} ms, plane "
              f"{ms['icp point_to_plane'][0]:.3f} / "
              f"{ms['icp point_to_plane'][1]:.3f} ms; "
              f"recognize_batch_sharded {ms['batch'][0]:.3f} ms for {n} "
              f"frames, {n / ms['batch'][0] * 1e3:.3f} frames/s; one gloo "
              f"all_reduce of 16 f32 on the card {ms['all_reduce'][0]:.4f} "
              f"ms, synchronised, mean of {5 * PARALLEL_REPS} ({card})")


def parallel_phase(eng, bgr_np, depth_np, cam, card, counts, errs):
    """Phase 6: the kernels at the shard shapes against their twins and
    timed; 6a at world size 1 (NCCL); 6b on two ranks sharing the card.
    Returns the shard cases' timing entries for the kernels line."""
    import torch
    from fealess_tpu_torch.ops.bounds import bound_ms
    from fealess_tpu_torch.utils.profiling import graph_ms
    bgr_b, depth_b, scene_k, clouds = parallel_inputs(eng, bgr_np, depth_np,
                                                      cam)
    cases = shard_cases(eng, bgr_b[0], depth_b[0], clouds)
    hold_to_twins(cases, errs, "2-way shards")
    timing = {}
    for name, runs in cases.items():
        kernel, plain, args = runs[0]
        ms, gms = cuda_ms(lambda: kernel(*args), 20), graph_ms(
            lambda: kernel(*args), 20)
        pms = cuda_ms(lambda: plain(*args), 3)
        bound, by = bound_ms(name, args)
        shapes = [tuple(a["c"].shape) if isinstance(a, dict)
                  else tuple(a.shape) for a in args[:3]
                  if isinstance(a, (dict, torch.Tensor))]
        timing[name] = {"case": f"2-way shard, inputs {shapes}", "ms": ms,
                        "graph_ms": gms, "plain_ms": pms, "bound_ms": bound,
                        "bound_by": by}
        print(f"time {name} (2-way shard, inputs {shapes}): kernel "
              f"{ms:.4f} ms (events), {gms:.4f} ms (graph), twin {pms:.4f} "
              f"ms, bound {bound:.6f} ms ({by}) ({card})")
    want_batch, want_icp = parallel_world1(eng, card, bgr_b, depth_b,
                                           scene_k, clouds, counts)
    parallel_two_ranks(eng, card, bgr_b, depth_b, scene_k, clouds,
                       want_batch, want_icp, counts[2])
    return timing


# -- phase 7: camera widths and frame input -------------------------------

def paeth_png(img) -> bytes:
    """PNG bytes of a u8 BGR (H, W, 3) image as 8-bit RGB with every row
    Paeth-filtered (libpng's adaptive writer picks Paeth and Average on
    camera images; io/png.py's own writer uses filter 0)."""
    import struct
    import zlib

    import numpy as np
    rgb = img[:, :, ::-1].reshape(img.shape[0], -1).astype(np.int16)
    h, stride = rgb.shape
    a, b, c = (np.zeros_like(rgb) for _ in range(3))
    a[:, 3:] = rgb[:, :-3]
    b[1:] = rgb[:-1]
    c[1:, 3:] = rgb[:-1, :-3]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    raw = np.concatenate([np.full((h, 1), 4, np.uint8),
                          ((rgb - pred) & 255).astype(np.uint8)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", img.shape[1], h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def same_results(got, want) -> bool:
    """Two lists of RecoResults equal bit for bit."""
    import numpy as np
    return len(got) == len(want) and all(
        (g.obj_tag, g.match_rect, g.similarity, g.icp_dist, g.inlier_ratio)
        == (w.obj_tag, w.match_rect, w.similarity, w.icp_dist,
            w.inlier_ratio)
        and np.array_equal(g.world2cam, w.world2cam)
        for g, w in zip(got, want))


def zoom_phase(eng, bgr_np, depth_np, cam, card, counts,
               default_icp) -> None:
    """Phase 7: the device resize against its CPU run; the zoomed serving
    paths against the native ones; the prepare stage, the upload, the PNG
    un-filter and the CLI's frame loader timed."""
    import contextlib
    import io

    import numpy as np
    import torch
    from fealess_tpu_torch.apps import cli, fixture
    from fealess_tpu_torch.ops import bounds
    from fealess_tpu_torch.utils.profiling import WARMUP, graph_ms, stage_ms
    from fealess_tpu_torch.engine import CamIntrinsics
    from fealess_tpu_torch.io import png
    from fealess_tpu_torch.ops import resize

    zero_counts, read_counts, path_launches, counted = counts
    dev = eng.device
    eng.set_advanced_param("icp_mode", default_icp.mode)

    # 7a. ops/resize on the card against its CPU run
    rng = np.random.default_rng(9)
    for (sw, sh), (dw, dh) in RESIZE_SHAPES:
        img = torch.from_numpy(rng.integers(0, 256, (sh, sw, 3),
                                            dtype=np.uint8))
        dep = torch.from_numpy(rng.integers(0, 65536, (sh, sw)).astype(
            np.int32))
        for fn, x in ((resize.resize_linear_u8, img),
                      (resize.resize_nearest, dep)):
            want = fn(x, (dw, dh))
            got = fn(x.to(dev), (dw, dh))
            check(got.device == dev and torch.equal(got.cpu(), want),
                  f"{fn.__name__} {sw}x{sh} -> {dw}x{dh}: the card differs "
                  f"from the CPU")
    shapes = ", ".join(f"{a[0]}x{a[1]}->{b[0]}x{b[1]}"
                       for a, b in RESIZE_SHAPES)
    print(f"resize: linear u8 and nearest on the card equal their CPU run "
          f"bitwise on {len(RESIZE_SHAPES)} shapes ({shapes})")

    # 7b. a 1280x960 camera: the fixture scenes with every pixel 2x2
    big_bgr, big_depth, cam2 = fixture.doubled(bgr_np, depth_np, cam)
    check(torch.equal(resize.resize_linear_u8(
        torch.from_numpy(big_bgr).to(dev), (cam.width, cam.height)).cpu(),
        torch.from_numpy(bgr_np)), "the 2x2 scene does not resize back")

    def native_counts(fn):
        zero_counts()
        out = fn()
        return out, [f.launches for f in counted]

    for setting in ("a", "b"):
        apply_setting(eng, setting, default_icp)
        native, n_counts = native_counts(
            lambda: eng.recognition(bgr_np, depth_np, cam))
        zero_counts()
        zoomed = eng.recognition(big_bgr, big_depth, cam2)
        read_counts(f"zoomed top-1 ({setting})")
        check(same_results(zoomed, native) and len(zoomed) == 1,
              f"zoomed top-1 ({setting}): {zoomed} vs native {native}")
        check(path_launches[f"zoomed top-1 ({setting})"] == n_counts,
              f"zoomed top-1 ({setting}): launches "
              f"{path_launches[f'zoomed top-1 ({setting})']} vs native "
              f"{n_counts}")
        print(f"zoomed top-1 ({setting}, {default_icp.mode}, 1280x960 -> "
              f"640x480): match {zoomed[0].match_rect[:2]} t "
              f"{[round(float(v), 5) for v in zoomed[0].world2cam[:3, 3]]}"
              f", bitwise equal to the native frame's, launches "
              f"{n_counts} as native")
    apply_setting(eng, "a", default_icp)
    two_bgr, two_depth = fixture.two_instance_scene(bgr_np, depth_np)
    native, n_counts = native_counts(
        lambda: eng.recognition_multi(two_bgr, two_depth, cam))
    zero_counts()
    zoomed = eng.recognition_multi(*fixture.doubled(two_bgr, two_depth,
                                                    cam))
    read_counts("zoomed recognition_multi")
    check(same_results(zoomed, native) and len(zoomed) == 2,
          f"zoomed multi: {zoomed} vs native {native}")
    check(path_launches["zoomed recognition_multi"] == n_counts,
          f"zoomed multi: launches {path_launches['zoomed recognition_multi']}"
          f" vs native {n_counts}")
    print(f"zoomed recognition_multi (two-instance scene at 1280x960): "
          f"{len(zoomed)} results bitwise equal to the native frame's, "
          f"launches {n_counts} as native")
    # a 1280x720 camera (the doubled scene's top 720 rows): 640x360,
    # padded to 640x400, re-pins the processing dims (the JAX package on
    # the CPU: the native match and pose)
    cam720 = CamIntrinsics(cam2.fx, cam2.fy, cam2.cx, cam2.cy, cam2.width,
                           720)
    zero_counts()
    res = eng.recognition(big_bgr[:720], big_depth[:720], cam720)
    read_counts("zoomed top-1 1280x720")
    dims = (eng.cfg.detector.image_height, eng.cfg.detector.image_width)
    check(dims == EXPECT_720_DIMS, f"1280x720: processing dims {dims}")
    check(len(res) == 1 and tuple(res[0].match_rect[:2]) == EXPECT_MATCH
          and res[0].similarity == 100.0
          and close(res[0].world2cam[:3, 3], EXPECT_T["a"], T_TOL_MM["a"]),
          f"1280x720: {res}")
    print(f"zoomed top-1 1280x720 -> 640x360 padded to {dims}: match "
          f"{res[0].match_rect[:2]} t "
          f"{[round(float(v), 5) for v in res[0].world2cam[:3, 3]]} (JAX: "
          f"{EXPECT_T['a']})")
    eng.recognition(bgr_np, depth_np, cam)
    check((eng.cfg.detector.image_height, eng.cfg.detector.image_width)
          == (cam.height, cam.width), "dims not re-pinned to 640x480")

    # 7c. times: the prepare stage at both widths, the upload and the
    # resize on the card
    prep = {name: stage_ms(lambda: eng._prepare_frame(b, d, k), 20)[0]
            for name, b, d, k in (("640x480", bgr_np, depth_np, cam),
                                  ("1280x960", big_bgr, big_depth, cam2))}
    big_depth_i32 = big_depth.astype(np.int32)

    def upload():
        return (torch.from_numpy(big_bgr).to(dev),
                torch.from_numpy(big_depth_i32).to(dev))

    up_ms = cuda_ms(upload, 10)
    bgr_d, depth_d = upload()

    def resize_both():
        return (resize.resize_linear_u8(bgr_d, (cam.width, cam.height)),
                resize.resize_nearest(depth_d, (cam.width, cam.height)))

    rs_events = cuda_ms(resize_both, 20)
    rs_graph = graph_ms(resize_both, 20)
    frame_bytes = big_bgr.nbytes + big_depth_i32.nbytes
    hbm = bounds.HBM_BYTES_PER_S
    out_bytes = bgr_np.nbytes + 4 * depth_np.size
    print(f"time prepare stage (host clock, synchronised, mean of 20): "
          f"640x480 {prep['640x480']:.4f} ms, 1280x960 "
          f"{prep['1280x960']:.4f} ms ({card})")
    print(f"time 1280x960 upload (colour u8 + depth int32, "
          f"{frame_bytes} bytes, pageable): {up_ms:.4f} ms (events); "
          f"resize on the card (linear + nearest to 640x480): "
          f"{rs_events:.4f} ms (events), {rs_graph:.4f} ms (graph), bytes "
          f"bound {(frame_bytes + out_bytes) / hbm * 1e3:.6f} "
          f"ms ({card})")

    # 7c (cont.). a Paeth-filtered 640x480 RGB PNG: the C un-filter and
    # its twin
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "paeth.png")
        with open(path, "wb") as f:
            f.write(paeth_png(bgr_np))
        png.read_png(path, color=True)
        t0 = time.perf_counter()
        for _ in range(PNG_TIMED):
            got = png.read_png(path, color=True)
        c_ms = (time.perf_counter() - t0) * 1e3 / PNG_TIMED
        check(np.array_equal(got, bgr_np), "Paeth PNG: C read differs")
        fast = png._unfilter
        png._unfilter = png._unfilter_plain
        try:
            t0 = time.perf_counter()
            got = png.read_png(path, color=True)
            plain_ms = (time.perf_counter() - t0) * 1e3
        finally:
            png._unfilter = fast
        check(np.array_equal(got, bgr_np), "Paeth PNG: twin read differs")
        print(f"time read_png (640x480 RGB, every row Paeth): C un-filter "
              f"{c_ms:.3f} ms (mean of {PNG_TIMED}), numpy twin "
              f"{plain_ms:.3f} ms (one call); both equal the scene (host, "
              f"{card})")

        # 7e. the CLI over a series of such frames (FrameLoader)
        series = os.path.join(tmp, "series")
        for sub in ("gray", "depth"):
            os.makedirs(os.path.join(series, sub))
        frames = fixture.pan(bgr_np, depth_np, SERIES_FRAMES)
        for i, (b, d) in enumerate(frames):
            with open(os.path.join(series, "gray", f"{i}.png"), "wb") as f:
                f.write(paeth_png(b))
            png.write_png(os.path.join(series, "depth", f"{i}.png"),
                          (d.astype(np.uint32) * 10).astype(np.uint16))
        t0 = time.perf_counter()
        for i in range(SERIES_FRAMES):
            png.read_png(os.path.join(series, "gray", f"{i}.png"),
                         color=True)
            png.read_png(os.path.join(series, "depth", f"{i}.png"))
        serial_ms = (time.perf_counter() - t0) * 1e3 / SERIES_FRAMES
        # the frames' launches are read before --profile's device-stage
        # table runs, and the table's on a path of their own
        out, err = io.StringIO(), io.StringIO()
        frames_path = "CLI recon, Paeth series"
        table_path = "CLI recon, Paeth series: device-stage table"
        table = cli._profile_stages
        real_stdout = sys.stdout

        def frames_then_table(*args):
            with contextlib.redirect_stdout(real_stdout):
                read_counts(frames_path)
            zero_counts()
            return table(*args)

        zero_counts()
        cli._profile_stages = frames_then_table
        try:
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = cli.main(["recon", os.path.join(fixture.FIXTURE,
                                                     "features"),
                               "--series", series, "--profile", "--device",
                               str(dev)])
        finally:
            cli._profile_stages = table
        check(frames_path in path_launches,
              "CLI recon --profile ran no device-stage table")
        read_counts(table_path)
        calls = WARMUP + cli.PROFILE_ITERS
        frames_n, table_n = path_launches[frames_path], \
            path_launches[table_path]
        # every frame launches K1 and K2 once; the table's match and full
        # rows launch them once a call, and K3 the same number of times in
        # each full call
        check(frames_n[:2] == [SERIES_FRAMES] * 2
              and table_n[:2] == [2 * calls] * 2 and table_n[2] % calls == 0,
              f"CLI recon --profile: launches {frames_n} on the frames, "
              f"{table_n} in the table ({calls} calls a row)")
        lines = [json.loads(ln) for ln in out.getvalue().splitlines()
                 if ln.startswith("{")]
        check(rc == 0 and [ln["frame"] for ln in lines]
              == list(range(SERIES_FRAMES))
              and all(len(ln["results"]) == 1
                      and ln["results"][0]["similarity"] == 100.0
                      for ln in lines),
              f"CLI recon on the Paeth series: rc {rc}, {lines}")
        rows = {ln.split()[1]: ln.split()[2:] for ln in
                err.getvalue().splitlines() if ln.startswith("# ")
                and len(ln.split()) == 5}
        io_row, reco_row = rows["host-io(decode+wait)"], \
            rows["recognition(+fetch)"]
        print(f"time CLI recon --profile ({SERIES_FRAMES} Paeth frames + "
              f"u16 depth, FrameLoader 4 threads): host-io(decode+wait) "
              f"{io_row[2]} ms mean ({io_row[1]} ms in all), "
              f"recognition(+fetch) {reco_row[2]} ms mean; decoding a "
              f"frame on the main thread takes {serial_ms:.3f} ms ({card})")


# -- phase 7d: frame input (JPEG, BMP, PNG by content) ----------------------

def bmp24(img) -> bytes:
    """A bottom-up 24-bit BMP of a u8 BGR (H, W, 3) image (rows padded to 4
    bytes, 40-byte header), as cv2.imwrite writes one."""
    import struct

    import numpy as np
    h, w = img.shape[:2]
    pitch = (3 * w + 3) & -4
    rows = np.zeros((h, pitch), np.uint8)
    rows[:, :3 * w] = img[::-1].reshape(h, -1)
    return (b"BM" + struct.pack("<IHHI", 54 + rows.size, 0, 0, 54)
            + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size,
                          2835, 2835, 0, 0) + rows.tobytes())


def host_mean_ms(fn, reps: int) -> float:
    """Mean host wall time of ``reps`` calls after one warm call."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def same_recon_line(got: dict, want: dict, setting: str) -> bool:
    """A port recon line against the JAX CLI's: the same frame and object,
    similarity exact, t within phase 4's T_TOL_MM, rotation within
    ROT_TOL_DEG, ICP distance within CLI_DIST_TOL."""
    import numpy as np
    if got["frame"] != want["frame"] or \
            len(got["results"]) != len(want["results"]):
        return False
    for g, w in zip(got["results"], want["results"]):
        pg, pw = np.asarray(g["pose"]), np.asarray(w["pose"])
        if (g["obj"] != w["obj"] or g["similarity"] != w["similarity"]
                or not close(pg[:3, 3], pw[:3, 3], T_TOL_MM[setting])
                or rotation_deg(pg[:3, :3] @ pw[:3, :3].T) > ROT_TOL_DEG
                or abs(g["icp_dist"] - w["icp_dist"]) > CLI_DIST_TOL):
            return False
    return True


def frame_input_phase(eng, bgr_np, depth_np, cam, card, counts,
                      default_icp) -> None:
    """Phase 7d: every committed file of ``tests/data/torch_frames``
    decoded to cv2's digests; ``acq`` on the card against its CPU call
    over a JPEG/BMP directory; ``recon`` (both ICP settings) over the
    640x480 series whose ``gray/*.png`` hold JPEG data against the JAX
    CLI's lines, K1/K2 (and K3 under forced ICP) counted behind the new
    reader; the match of each decoded frame against JAX's; decode times."""
    import contextlib
    import hashlib
    import io
    import shutil

    import numpy as np
    from fealess_tpu_torch.apps import acquire, cli, fixture
    from fealess_tpu_torch.io import png
    from fealess_tpu_torch.io.imfile import (IMREAD_COLOR, IMREAD_UNCHANGED,
                                             read_image)

    zero_counts, read_counts, path_launches, counted = counts
    dev = eng.device
    with open(os.path.join(FRAMES_DIR, "digests.json")) as f:
        digests = json.load(f)
    with open(os.path.join(FRAMES_DIR, "recon.json")) as f:
        expect = json.load(f)

    # every committed file under every flag: cv2's sha256 (recorded here
    # by tests/make_torch_frames.py, held to cv2 by the CPU tests)
    for name, flags in sorted(digests.items()):
        for flag, want in flags.items():
            img = read_image(os.path.join(FRAMES_DIR, name), int(flag))
            got = [list(img.shape), hashlib.sha256(img.tobytes()).hexdigest()]
            check(got == want, f"decode {name} flag {flag}: {got}, cv2 "
                               f"gives {want}")
    print(f"frame input: {len(digests)} committed files (JPEG: every "
          f"sampling factor, progressive, restart, gray, EXIF 6/8, odd "
          f"sizes, cut short, under a .png name, DHT cut; BMP 8/24/32-bit, "
          f"RLE4/8, top-down; the 640x480 series) x 3 flags: sha256 equal "
          f"to cv2.imread's")

    with tempfile.TemporaryDirectory() as tmp:
        # the 640x480 series: gray/<i>.png hold JPEG data (committed),
        # depth as the fixture writes it
        series = os.path.join(tmp, "series")
        for sub in ("gray", "depth"):
            os.makedirs(os.path.join(series, sub))
        pan = fixture.pan(bgr_np, depth_np, 3)
        depths = (pan[0][1], pan[0][1], pan[2][1])
        for i, d in enumerate(depths):
            shutil.copy(os.path.join(FRAMES_DIR, "series", "gray",
                                     f"{i}.png"),
                        os.path.join(series, "gray", f"{i}.png"))
            png.write_png(os.path.join(series, "depth", f"{i}.png"),
                          (d.astype(np.uint32) * 10).astype(np.uint16))

        # acq over a JPEG/BMP directory: on the card and on the CPU
        src, dep = os.path.join(tmp, "acq_src"), os.path.join(tmp, "acq_dep")
        os.makedirs(src)
        os.makedirs(dep)
        for i in range(2):
            shutil.copy(os.path.join(series, "gray", f"{i}.png"),
                        os.path.join(src, f"{i}.jpg"))
        with open(os.path.join(src, "2.bmp"), "wb") as f:
            f.write(bmp24(pan[2][0]))
        shutil.copy(os.path.join(FRAMES_DIR, "rle8.bmp"),
                    os.path.join(src, "3.bmp"))
        for i, d in enumerate(depths):
            png.write_png(os.path.join(dep, f"{i}.png"), d)
        outs = {}
        for device in (str(dev), "cpu"):
            outs[device] = os.path.join(tmp, f"acq_{device}")
            with contextlib.redirect_stdout(io.StringIO()):
                n = acquire.acquire_series(src, outs[device], depth_dir=dep,
                                           save_clouds=True, device=device)
            check(n == 4, f"acq on {device}: {n} frames")
        worst, points = 0.0, 0
        for sub in ("gray", "depth", "cloud"):
            names = sorted(os.listdir(os.path.join(outs["cpu"], sub)))
            check(names == sorted(os.listdir(os.path.join(outs[str(dev)],
                                                          sub)))
                  and len(names) == (4 if sub == "gray" else 3),
                  f"acq {sub}/: {names}")
            for name in names:
                a = os.path.join(outs[str(dev)], sub, name)
                b = os.path.join(outs["cpu"], sub, name)
                if sub != "cloud":
                    check(np.array_equal(read_image(a, IMREAD_UNCHANGED),
                                         read_image(b, IMREAD_UNCHANGED)),
                          f"acq {sub}/{name}: the card differs from the CPU")
                    continue
                pa, pb = np.loadtxt(a, ndmin=2), np.loadtxt(b, ndmin=2)
                check(pa.shape == pb.shape and pa.shape[0] > 0,
                      f"acq cloud/{name}: {pa.shape} vs {pb.shape} points")
                worst = max(worst, float(np.abs(pa - pb).max()))
                points += pa.shape[0]
        check(worst <= CLOUD_TOL_MM + 1e-9,
              f"acq clouds: {worst} mm from the CPU's")
        print(f"acq --device {dev} (2 JPEG + 2 BMP frames to 640x480, depth, "
              f"clouds): gray/ and depth/ bitwise equal to the CPU call, "
              f"{points} cloud points within {worst:.4f} mm of it (limit "
              f"{CLOUD_TOL_MM} mm)")

        # recon over the JPEG-content series in both ICP settings
        features = os.path.join(fixture.FIXTURE, "features")
        build = cli._engine_for
        for setting in ("a", "b"):
            def engine_for(args, width, height, setting=setting):
                served = build(args, width, height)
                apply_setting(served, setting, default_icp)
                return served

            path = f"CLI recon, JPEG-content series ({setting})"
            out = io.StringIO()
            cli._engine_for = engine_for
            zero_counts()
            try:
                with contextlib.redirect_stdout(out), \
                        contextlib.redirect_stderr(io.StringIO()):
                    rc = cli.main(["recon", features, "--series", series,
                                   "--device", str(dev)])
            finally:
                cli._engine_for = build
            read_counts(path)
            lines = [json.loads(ln) for ln in out.getvalue().splitlines()
                     if ln.startswith("{")]
            want = expect[setting]
            check(rc == 0 and len(lines) == len(want) == 3
                  and all(same_recon_line(g, w, setting)
                          for g, w in zip(lines, want)),
                  f"{path}: rc {rc}, {lines} vs JAX {want}")
            k1, k2, k3 = path_launches[path]
            check(k1 == k2 == 3 and (k3 > 0) == (setting == "b"),
                  f"{path}: launches {path_launches[path]}")
            t2 = [round(r[3], 5) for r in lines[2]["results"][0]["pose"][:3]]
            print(f"{path}: 3 lines equal to the JAX CLI's (similarity "
                  f"exact, t within {T_TOL_MM[setting]} mm, rotation within "
                  f"{ROT_TOL_DEG} deg, ICP distance within {CLI_DIST_TOL}); "
                  f"t of frame 2 {t2}")
        apply_setting(eng, "a", default_icp)
        path = "JPEG-content frames, recognition"
        zero_counts()
        for i, d in enumerate(depths):
            bgr = read_image(os.path.join(series, "gray", f"{i}.png"),
                             IMREAD_COLOR)
            res = eng.recognition(bgr, d, cam)
            check(len(res) == 1
                  and list(res[0].match_rect[:2]) == expect["match"][i]
                  and res[0].similarity == 100.0,
                  f"{path} {i}: {res}, JAX's match {expect['match'][i]}")
        read_counts(path)
        print(f"{path}: matches {expect['match']} as the JAX engine's on "
              f"cv2's decode, similarity 100.0")

        # decode times of the fixture scene, on the host
        scene_bmp, scene_png = (os.path.join(tmp, "scene.bmp"),
                                os.path.join(tmp, "scene.png"))
        with open(scene_bmp, "wb") as f:
            f.write(bmp24(bgr_np))
        png.write_png(scene_png, bgr_np)
        check(np.array_equal(read_image(scene_bmp), bgr_np)
              and np.array_equal(png.read_png(scene_png, color=True), bgr_np),
              "scene BMP/PNG decode differs from the scene")
        gray_dir = os.path.join(series, "gray")
        times = {
            "JPEG baseline 4:2:0 q95": host_mean_ms(
                lambda: read_image(os.path.join(gray_dir, "0.png")),
                DECODE_TIMED),
            "JPEG progressive 4:2:0 q95": host_mean_ms(
                lambda: read_image(os.path.join(gray_dir, "1.png")),
                DECODE_TIMED),
            "BMP 24-bit": host_mean_ms(lambda: read_image(scene_bmp),
                                       DECODE_TIMED),
            "read_png (filter 0)": host_mean_ms(
                lambda: png.read_png(scene_png, color=True), DECODE_TIMED)}
        print("time decode of the 640x480 fixture scene to BGR (host, mean "
              f"of {DECODE_TIMED} after a warm call): "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
              + f" ({card})")


# -- phase 7e: persistence ---------------------------------------------------


def persistence_phase(eng, bgr_np, depth_np, cam, card, counts,
                      default_icp) -> None:
    """Phase 7e: the JAX package's orbax checkpoint of the fixture bank
    (``tests/data/torch_ckpt``) loaded on the card to its digests and to
    ``import_yaml``'s leaves; ``pipeline.recognize_top1`` from that bank,
    with ``ObjReco.add_obj``'s model depths, equal to
    ``ObjReco.recognition`` in both ICP settings with K1/K2/K3 counted;
    ``save_bank`` then ``load_bank`` bitwise; host times of the loads, and
    of the orbax load's host read with its zstd decodes."""
    import hashlib
    import shutil

    import numpy as np
    import torch
    from fealess_tpu_torch import detector as det_mod, pipeline
    from fealess_tpu_torch.apps import fixture
    from fealess_tpu_torch.bank import bank_arrays
    from fealess_tpu_torch.io import checkpoint, zstd
    from fealess_tpu_torch.io.export import ServingArtifact

    zero_counts, read_counts, path_launches, counted = counts
    dev = eng.device
    yml = os.path.join(fixture.FIXTURE, "features", "linemod_templates.yml")
    with open(os.path.join(CKPT_DIR, "digests.json")) as f:
        digests = json.load(f)

    def leaves(bank) -> dict:
        return {k: np.ascontiguousarray(v) for k, v in
                bank_arrays(bank).items()}

    def same_leaves(a, b) -> bool:
        return all(getattr(a, k).dtype == getattr(b, k).dtype
                   and torch.equal(getattr(a, k), getattr(b, k))
                   for k in digests)

    bank, det = checkpoint.load_bank(CKPT_DIR, device=dev)
    got = {k: {"dtype": str(v.dtype), "shape": list(v.shape),
               "sha256": hashlib.sha256(v.tobytes()).hexdigest()}
           for k, v in leaves(bank).items()}
    check(got == digests and all(getattr(bank, k).device == dev
                                 for k in digests),
          f"load_bank of the JAX checkpoint: {got} vs {digests}")
    imported, det_y = checkpoint.import_yaml(yml, device=dev)
    check(det == det_y and same_leaves(bank, imported),
          "load_bank of the JAX checkpoint differs from import_yaml")
    check(same_leaves(bank, eng.bank),
          "load_bank of the JAX checkpoint differs from add_obj's bank")
    print(f"persistence: JAX's orbax checkpoint ({len(digests)} leaves, "
          f"{bank.num_templates} templates) loaded on {dev}: sha256, dtype "
          f"and shape of every leaf equal to digests.json, bitwise equal to "
          f"import_yaml on the card")

    tables = det_mod.build_match_tables(bank, eng.cfg.detector)
    for setting in ("a", "b"):
        apply_setting(eng, setting, default_icp)
        path = f"checkpoint bank, recognize_top1 ({setting})"
        frame = eng._prepare_frame(bgr_np, depth_np, cam)
        zero_counts()
        step = pipeline.recognize_top1(bank, eng._model_depth_dev,
                                       eng._origins_dev, *frame, eng.cfg,
                                       kernels=tables)
        res = eng._fetch_top1(step)[0]
        read_counts(path)
        want = eng.recognition(bgr_np, depth_np, cam)
        check(len(res) == len(want) == 1 and all(
            np.array_equal(g.world2cam, w.world2cam)
            and (g.obj_tag, g.similarity, g.icp_dist, g.inlier_ratio,
                 g.match_rect) == (w.obj_tag, w.similarity, w.icp_dist,
                                   w.inlier_ratio, w.match_rect)
            for g, w in zip(res, want)), f"{path}: {res} vs {want}")
        want_k = [1, 1, EXPECT_NN[setting]]
        check(path_launches[path] == want_k,
              f"{path}: launches {path_launches[path]}, expected {want_k}")
        print(f"{path}: equal to ObjReco.recognition (match "
              f"{res[0].match_rect[:2]}, similarity {res[0].similarity}, "
              f"pose bitwise), launches K1/K2/K3 {path_launches[path]}")
    apply_setting(eng, "a", default_icp)

    work = tempfile.mkdtemp()
    try:
        saved = os.path.join(work, "saved")
        checkpoint.save_bank(saved, bank, det)
        again, det_a = checkpoint.load_bank(saved, device=dev)
        check(det_a == det and same_leaves(again, bank)
              and again.class_names == bank.class_names
              and again.max_span == bank.max_span,
              "save_bank then load_bank on the card is not bitwise equal")
        npz = os.path.join(work, "npz")
        os.makedirs(npz)
        shutil.copy(os.path.join(saved, "bank_meta.json"), npz)
        np.savez(os.path.join(npz, "arrays.npz"), **leaves(bank))
        art = os.path.join(work, "artifact")
        eng.export_artifact(art)

        def synced(fn):
            def call():
                fn()
                torch.cuda.synchronize()
            return call

        times = {
            "load_bank (JAX's orbax checkpoint)": host_mean_ms(synced(
                lambda: checkpoint.load_bank(CKPT_DIR, device=dev)),
                DECODE_TIMED),
            "load_bank (arrays.npz)": host_mean_ms(synced(
                lambda: checkpoint.load_bank(npz, device=dev)),
                DECODE_TIMED),
            "import_yaml": host_mean_ms(synced(
                lambda: checkpoint.import_yaml(yml, device=dev)),
                DECODE_TIMED),
            "ServingArtifact load": host_mean_ms(synced(
                lambda: ServingArtifact(art, dev)), DECODE_TIMED),
            "save_bank (orbax layout)": host_mean_ms(
                lambda: checkpoint.save_bank(saved, bank, det),
                DECODE_TIMED)}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # where the orbax load's time goes: the arrays read on the host, and
    # the zstd decodes inside that read (every node body and chunk)
    decode, spent = zstd.decode, []

    def timed_decode(*args, **kw):
        t0 = time.perf_counter()
        try:
            return decode(*args, **kw)
        finally:
            spent.append(time.perf_counter() - t0)

    zstd.decode = timed_decode
    try:
        times["_read_orbax (host arrays)"] = host_mean_ms(
            lambda: checkpoint._read_orbax(os.path.join(CKPT_DIR, "arrays")),
            DECODE_TIMED)
    finally:
        zstd.decode = decode
    frames = len(spent) // (DECODE_TIMED + 1)
    times[f"of which zstd.decode ({frames} frames)"] = (
        sum(spent[frames:]) * 1e3 / DECODE_TIMED)
    print(f"persistence: save_bank then load_bank on {dev} bitwise equal; "
          f"time ({bank.num_templates} templates, host, mean of "
          f"{DECODE_TIMED} after a warm call, to the bank on the card): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
          + f" ({card})")


def filestorage_phase(eng, bgr_np, depth_np, cam, card, counts,
                      default_icp) -> None:
    """Phase 7e (cv::FileStorage): the fixture bank written as XML and as
    JSON by the port's ``save_linemod``, each file's sha256 equal to the
    JAX writer's (recorded on the CPU); a feature directory whose
    ``linemod_templates.yml`` holds that XML served by ``ObjReco.add_obj``
    on the card: its bank and model depths equal to the YAML bank's, its
    recognition equal to the YAML engine's in both ICP settings with
    K1/K2/K3 counted; ``load_linemod``'s host times for YAML, XML and
    JSON."""
    import hashlib
    import shutil

    import numpy as np
    import torch
    from fealess_tpu_torch.apps import fixture
    from fealess_tpu_torch.engine import ObjReco
    from fealess_tpu_torch.io import linemod_yaml

    zero_counts, read_counts, path_launches, counted = counts
    dev = eng.device
    feats = os.path.join(fixture.FIXTURE, "features")
    yml = os.path.join(feats, "linemod_templates.yml")
    with open(FILESTORAGE_DIGESTS) as f:
        digests = json.load(f)
    det, classes = linemod_yaml.load_linemod(yml)
    work = tempfile.mkdtemp()
    try:
        paths = {}
        for form in ("xml", "json"):
            paths[form] = os.path.join(work, f"bank.{form}")
            linemod_yaml.save_linemod(paths[form], det, classes)
            with open(paths[form], "rb") as f:
                got = hashlib.sha256(f.read()).hexdigest()
            check(got == digests[form], f"save_linemod to .{form}: sha256 "
                                        f"{got}, the JAX writer's "
                                        f"{digests[form]}")
        served = os.path.join(work, "features")
        os.makedirs(served)
        shutil.copy(paths["xml"], os.path.join(served,
                                               "linemod_templates.yml"))
        os.symlink(os.path.join(feats, "depth"), os.path.join(served,
                                                              "depth"))
        xml_eng = ObjReco.create("LmICP", device=dev)
        xml_eng.add_obj(served)
        check(all(torch.equal(getattr(xml_eng.bank, k),
                              getattr(eng.bank, k))
                  for k in ("feat_x", "feat_y", "feat_label", "feat_valid",
                            "width", "height", "offset_x", "offset_y",
                            "pose", "class_idx", "template_idx", "valid"))
              and torch.equal(xml_eng._model_depth_dev,
                              eng._model_depth_dev),
              "add_obj of the XML bank differs from the YAML bank's")
        print(f"cv::FileStorage: the fixture bank ({eng.bank.num_templates} "
              f"templates) written as XML and JSON on the host, sha256 equal "
              f"to the JAX writer's; add_obj of a linemod_templates.yml "
              f"holding the XML on {dev}: bank and model depths bitwise "
              f"equal to the YAML bank's")
        for setting in ("a", "b"):
            apply_setting(eng, setting, default_icp)
            apply_setting(xml_eng, setting, default_icp)
            path = f"XML bank, ObjReco.recognition ({setting})"
            zero_counts()
            res = xml_eng.recognition(bgr_np, depth_np, cam)
            read_counts(path)
            want = eng.recognition(bgr_np, depth_np, cam)
            check(len(res) == len(want) == 1 and all(
                np.array_equal(g.world2cam, w.world2cam)
                and (g.obj_tag, g.similarity, g.icp_dist, g.inlier_ratio,
                     g.match_rect) == (w.obj_tag, w.similarity, w.icp_dist,
                                       w.inlier_ratio, w.match_rect)
                for g, w in zip(res, want)), f"{path}: {res} vs {want}")
            want_k = [1, 1, EXPECT_NN[setting]]
            check(path_launches[path] == want_k,
                  f"{path}: launches {path_launches[path]}, expected "
                  f"{want_k}")
            print(f"{path}: equal to the YAML bank's (match "
                  f"{res[0].match_rect[:2]}, similarity {res[0].similarity},"
                  f" pose bitwise), launches K1/K2/K3 {path_launches[path]}")
        apply_setting(eng, "a", default_icp)
        times = {form: host_mean_ms(
            lambda p=p: linemod_yaml.load_linemod(p), FILESTORAGE_TIMED)
            for form, p in (("YAML", yml), ("XML", paths["xml"]),
                            ("JSON", paths["json"]))}
        sizes = {form: os.path.getsize(p) for form, p in
                 (("YAML", yml), ("XML", paths["xml"]),
                  ("JSON", paths["json"]))}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"time load_linemod ({eng.bank.num_templates} templates, host, "
          f"mean of {FILESTORAGE_TIMED} after a warm call): "
          + ", ".join(f"{k} {v:.3f} ms ({sizes[k]} bytes)"
                      for k, v in times.items()) + f" ({card})")


# -- phase 7f: video files ---------------------------------------------------

def avi_bytes(frames, width: int, height: int, fourcc: bytes,
              extradata: bytes = b"") -> bytes:
    """A one-stream video AVI of ``frames`` (bytes each) as ``00dc``
    chunks, no index (the demuxer walks ``movi``), ``extradata`` after
    strf's BITMAPINFOHEADER."""
    import struct

    def chunk(cid: bytes, data: bytes) -> bytes:
        return cid + struct.pack("<I", len(data)) + data + b"\0" * (
            len(data) & 1)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", fourcc, 0, 0, 0, 0,
                       1, 10, 0, len(frames), 0, 0xFFFFFFFF, 0, 0, 0, width,
                       height)
    strf = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 24, fourcc,
                       width * height * 3, 0, 0, 0, 0) + extradata
    avih = struct.pack("<14I", 100000, 0, 0, 0, len(frames), 0, 1, 0, width,
                       height, 0, 0, 0, 0)
    hdrl = chunk(b"LIST", b"hdrl" + chunk(b"avih", avih) + chunk(
        b"LIST", b"strl" + chunk(b"strh", strh) + chunk(b"strf", strf)))
    movi = chunk(b"LIST", b"movi" + b"".join(chunk(b"00dc", f)
                                             for f in frames))
    riff = b"AVI " + hdrl + movi
    return b"RIFF" + struct.pack("<I", len(riff)) + riff


def huffyuv_bytes(img, extradata: bytes) -> bytes:
    """A Huffyuv frame of BGR u8 ``img`` with the code lengths in
    ``extradata`` (version 2, RGB24, left prediction, decorrelated, each
    table giving all 256 symbols a code, as FFmpeg's encoder makes them):
    the first pixel of the bottom row as R, G, B and a zero byte, then each
    pixel, rows bottom up, as the codes of its G, B - G and R - G steps
    from the pixel before it; 32-bit little-endian words, each filled from
    its top bit."""
    import numpy as np

    bits = np.unpackbits(np.frombuffer(extradata[4:], np.uint8))
    at, tables = 0, []
    for _ in range(3):                # huffyuvdec's read_len_table
        lens = []
        while len(lens) < 256:
            rep = int(bits[at:at + 3] @ [4, 2, 1])
            val = int(bits[at + 3:at + 8] @ [16, 8, 4, 2, 1])
            at += 8
            if not rep:
                rep = int(bits[at:at + 8] @ (1 << np.arange(7, -1, -1)))
                at += 8
            lens += [val] * rep
        lens = np.asarray(lens)
        count = np.bincount(lens, minlength=33)
        nxt = [0] * 33                # generate_bits_table
        for n in range(32, 0, -1):
            nxt[n - 1] = (count[n] + nxt[n]) >> 1
        codes = np.zeros(256, np.uint32)
        for sym in range(256):
            codes[sym] = nxt[lens[sym]]
            nxt[lens[sym]] += 1
        tables.append((codes, lens))
    pix = img[::-1].reshape(-1, 3).astype(np.int16)         # B, G, R
    step = np.diff(pix, axis=0)
    syms = np.stack([step[:, 1], step[:, 0] - step[:, 1],
                     step[:, 2] - step[:, 1]], 1).astype(np.uint8)
    order = (1, 0, 2)                 # the tables of G, B - G, R - G
    code = np.stack([tables[t][0][syms[:, i]] for i, t in enumerate(order)],
                    1).reshape(-1)
    size = np.stack([tables[t][1][syms[:, i]] for i, t in enumerate(order)],
                    1).reshape(-1)
    r, g, b = (int(v) for v in pix[0, ::-1])
    head = np.array([r << 24 | g << 16 | b << 8], np.uint32)
    code = np.concatenate([head, code]).astype(">u4")
    size = np.concatenate([[32], size])
    word = np.unpackbits(code.view(np.uint8)).reshape(-1, 32)
    out = word[np.arange(32) >= 32 - size[:, None]]
    out = np.packbits(np.pad(out, (0, -len(out) % 32)))
    return out.view(">u4").astype("<u4").tobytes()


def acq_recon_source(eng, card, counts, default_icp, name: str,
                     n_frames: int, expect: dict, kind: str,
                     no_clouds: bool, directory: str = VIDEO_DIR) -> None:
    """``acq --device cuda --clouds`` from the committed source ``name`` in
    ``directory`` with the committed depth directory: its ``gray/`` and
    ``depth/`` pixels held to the JAX CLI's (``expect["acq"]``) and its
    clouds to the same call on the CPU; then ``recon --device cuda`` on the package in
    both ICP settings against the JAX CLI's lines, K1/K2/K3 counted.
    ``no_clouds`` times a third call without ``--clouds``."""
    import contextlib
    import hashlib
    import io

    import numpy as np
    from fealess_tpu_torch.apps import cli, fixture
    from fealess_tpu_torch.io.imfile import IMREAD_UNCHANGED, read_image

    zero_counts, read_counts, path_launches, counted = counts
    dev = eng.device
    source = os.path.join(directory, name)

    def sha(a) -> str:
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    calls = [(str(dev), ["--clouds"]), ("cpu", ["--clouds"])]
    if no_clouds:
        calls.append(("no-clouds", []))
    with tempfile.TemporaryDirectory() as tmp:
        outs, acq_ms = {}, {}
        for device, clouds in calls:
            outs[device] = os.path.join(tmp, f"acq_{device}")
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(io.StringIO()):
                rc = cli.main(["acq", source, outs[device], "--depth-dir",
                               os.path.join(VIDEO_DIR, "depth"), *clouds,
                               "--device", str(dev) if device == "no-clouds"
                               else device])
            acq_ms[device] = (time.perf_counter() - t0) * 1e3 / n_frames
            check(rc == 0 and f"saved {n_frames} frames" in out.getvalue(),
                  f"acq --device {device} from {name}: rc {rc}, "
                  f"{out.getvalue()!r}")
        pkg = outs[str(dev)]
        for sub, want in expect["acq"].items():
            got = {n: sha(read_image(os.path.join(pkg, sub, n),
                                     IMREAD_UNCHANGED))
                   for n in sorted(os.listdir(os.path.join(pkg, sub)))}
            check(got == want, f"acq {sub}/ from {name}: {got}, the JAX "
                               f"CLI's {want}")
        worst, points = 0.0, 0
        names = sorted(os.listdir(os.path.join(outs["cpu"], "cloud")))
        check(names == sorted(os.listdir(os.path.join(pkg, "cloud")))
              and len(names) == n_frames, f"acq cloud/ from {name}: {names}")
        for cloud in names:
            pa = np.loadtxt(os.path.join(pkg, "cloud", cloud), ndmin=2)
            pb = np.loadtxt(os.path.join(outs["cpu"], "cloud", cloud),
                            ndmin=2)
            check(pa.shape == pb.shape and pa.shape[0] > 0,
                  f"acq cloud/{cloud} from {name}: {pa.shape} vs "
                  f"{pb.shape} points")
            worst = max(worst, float(np.abs(pa - pb).max()))
            points += pa.shape[0]
        check(worst <= CLOUD_TOL_MM + 1e-9,
              f"acq clouds from {name}: {worst} mm from the CPU's")
        print(f"acq --device {dev} --clouds from {name} ({n_frames} {kind} "
              f"frames, 640x480, depth paired by position): gray/ and "
              f"depth/ pixels equal to the JAX CLI's, {points} cloud points "
              f"within {worst:.4f} mm of the CPU call (limit "
              f"{CLOUD_TOL_MM} mm)")
        print(f"time acq from {name} (host clock, one call, ms per frame): "
              f"--clouds on {dev} {acq_ms[str(dev)]:.3f}, --clouds on the "
              f"CPU {acq_ms['cpu']:.3f}"
              + (f", without --clouds {acq_ms['no-clouds']:.3f}"
                 if no_clouds else "") + f" ({card})")

        # recon on the package acq wrote, in both ICP settings
        features = os.path.join(fixture.FIXTURE, "features")
        build = cli._engine_for
        for setting in ("a", "b"):
            def engine_for(args, width, height, setting=setting):
                served = build(args, width, height)
                apply_setting(served, setting, default_icp)
                return served

            path = f"CLI recon, acq package from {name} ({setting})"
            out = io.StringIO()
            cli._engine_for = engine_for
            zero_counts()
            try:
                with contextlib.redirect_stdout(out), \
                        contextlib.redirect_stderr(io.StringIO()):
                    rc = cli.main(["recon", features, "--series", pkg,
                                   "--device", str(dev)])
            finally:
                cli._engine_for = build
            read_counts(path)
            lines = [json.loads(ln) for ln in out.getvalue().splitlines()
                     if ln.startswith("{")]
            want = expect[setting]
            check(rc == 0 and len(lines) == len(want) == n_frames
                  and all(same_recon_line(g, w, setting)
                          for g, w in zip(lines, want)),
                  f"{path}: rc {rc}, {lines} vs JAX {want}")
            want_k = [n_frames, n_frames, n_frames * EXPECT_NN[setting]]
            check(path_launches[path] == want_k,
                  f"{path}: launches {path_launches[path]}, expected "
                  f"{want_k}")
            t = [round(r[3], 5)
                 for r in lines[-1]["results"][0]["pose"][:3]]
            print(f"{path}: {n_frames} lines equal to the JAX CLI's "
                  f"(similarity exact, t within {T_TOL_MM[setting]} mm, "
                  f"rotation within {ROT_TOL_DEG} deg, ICP distance within "
                  f"{CLI_DIST_TOL}); launches K1/K2/K3 "
                  f"{path_launches[path]}; t of the last frame {t}")
    apply_setting(eng, "a", default_icp)


def video_phase(eng, card, counts, default_icp) -> None:
    """Phase 7f: every committed source of ``tests/data/torch_video`` (AVI,
    MP4 and Matroska files, image files, printf patterns) decoded by
    ``io/video.VideoReader`` to cv2's digests; ``acq --device cuda
    --clouds`` from the committed Motion JPEG clip, the FFV1 MP4, the
    JPEG pattern and the mp4v AVI with the depth directory, each package
    held to the JAX CLI's pixels and clouds to the same call on the CPU,
    and ``recon --device cuda`` on it in both ICP settings against the JAX
    CLI's lines, K1/K2/K3 counted; host decode times per 640x480 frame;
    then the VP8 and VP9 sources (``vp8_sources``, ``vp9_sources``)."""
    import hashlib

    import numpy as np
    from fealess_tpu_torch.io import png, rawvideo
    from fealess_tpu_torch.io.avi import AviFile
    from fealess_tpu_torch.io.video import VideoReader

    with open(os.path.join(VIDEO_DIR, "digests.json")) as f:
        digests = json.load(f)
    with open(os.path.join(VIDEO_DIR, "recon.json")) as f:
        expect = json.load(f)

    def sha(a) -> str:
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    # every committed source: cv2.VideoCapture's frame count and each
    # frame's shape and sha256 (recorded by tests/make_torch_video.py, held
    # to cv2 by the CPU tests)
    for name, want in sorted(digests.items()):
        with VideoReader(os.path.join(VIDEO_DIR, name)) as reader:
            frames = list(reader)
        got = {"frames": len(frames),
               "shapes": [list(f.shape) for f in frames],
               "sha256": [sha(f) for f in frames]}
        check(got == want, f"video {name}: {got}, cv2 gives {want}")
    print(f"video input: {len(digests)} committed sources ("
          f"{sum(d['frames'] for d in digests.values())} frames: Motion "
          f"JPEG from cv2.VideoWriter and hand-muxed at 4:2:0, 4:2:2 without "
          f"DHT, 4:4:4, gray, restart, progressive, 17x33, 64x47, 1x1, "
          f"OpenDML with AVIX; FFV1 at 96x64 and 640x480; raw I420 from "
          f"fourcc 0 and IYUV at 17x33; PNG video in AVI, MP4 and Matroska; "
          f"Huffyuv in AVI; "
          f"FFV1 and Motion JPEG in MP4 and Matroska; I420 in Matroska; "
          f"FFV1 in MP4 at 640x480; JPEG, BMP and 16-bit gray PNG images; "
          f"printf patterns of PNGs and of 640x480 JPEGs; MPEG-4 Part 2 "
          f"from cv2.VideoWriter for every fourcc in AVI, in MP4 and "
          f"Matroska, QP 3 to 31, a scene cut, motion past the edge, an odd "
          f"width, a VOP not coded, and at 640x480): frame counts and "
          f"every frame's sha256 equal to cv2.VideoCapture's")

    acq_recon_source(eng, card, counts, default_icp, "clip.avi",
                     digests["clip.avi"]["frames"], expect, "Motion JPEG",
                     True)
    for name, kind in (("pan_ffv1.mp4", "FFV1 in MP4"),
                       ("pan/%d.jpg", "JPEG pattern"),
                       ("pan_mp4v.avi", "MPEG-4 Part 2 (mp4v) in AVI")):
        acq_recon_source(eng, card, counts, default_icp, name,
                         digests[name]["frames"], expect["sources"][name],
                         kind, False)

    # host decode times per 640x480 frame (demux included); the raw I420,
    # PNG and Huffyuv video and the PNG pattern are written here from the
    # clip's frames (the clip's FFV1 frame 0 and the pan's JPEGs are
    # committed)
    bgr = [f for f in VideoReader(os.path.join(VIDEO_DIR, "ffv1_640.avi"))]
    bgr += [np.roll(bgr[0], 2 * i, 1) for i in range(1, 4)]
    with tempfile.TemporaryDirectory() as tmp:
        pngs = []
        for i, img in enumerate(bgr):
            path = os.path.join(tmp, f"p_{i}.png")
            png.write_png(path, img)
            with open(path, "rb") as f:
                pngs.append(f.read())
        # I420 planes from the frame (only the decode's cost matters)
        planes = [img[:, :, 1].tobytes() + img[::2, ::2, 0].tobytes()
                  + img[::2, ::2, 2].tobytes() for img in bgr]
        assert len(planes[0]) == rawvideo.frame_size(640, 480)
        # Huffyuv with the committed clip's tables (lossless: the frames)
        with AviFile(os.path.join(VIDEO_DIR, "hfyu.avi")) as avi:
            hfyu_tables = avi.stream.extradata
        hfyus = [huffyuv_bytes(img, hfyu_tables) for img in bgr]
        for name, frames, fourcc, extra in (
                ("i420.avi", planes, b"I420", b""),
                ("mpng.avi", pngs, b"MPNG", b""),
                ("hfyu.avi", hfyus, b"HFYU", hfyu_tables)):
            with open(os.path.join(tmp, name), "wb") as f:
                f.write(avi_bytes(frames, 640, 480, fourcc, extra))
        check([len(list(VideoReader(os.path.join(tmp, n))))
               for n in ("i420.avi", "mpng.avi", "p_%d.png")] == [4, 4, 4],
              "the timing sources do not decode to 4 frames each")
        got = list(VideoReader(os.path.join(tmp, "hfyu.avi")))
        check(len(got) == 4 and all(np.array_equal(g, w)
                                    for g, w in zip(got, bgr)),
              "the 640x480 Huffyuv clip does not decode to its frames")
        sources = {
            "Motion JPEG 4:2:0 (cv2.VideoWriter, clip.avi)":
                (os.path.join(VIDEO_DIR, "clip.avi"), 4),
            "FFV1 (cv2.VideoWriter, ffv1_640.avi)":
                (os.path.join(VIDEO_DIR, "ffv1_640.avi"), 1),
            "FFV1 in MP4 (cv2.VideoWriter, pan_ffv1.mp4)":
                (os.path.join(VIDEO_DIR, "pan_ffv1.mp4"), 2),
            "raw I420 in AVI": (os.path.join(tmp, "i420.avi"), 4),
            "PNG video (MPNG) in AVI": (os.path.join(tmp, "mpng.avi"), 4),
            "Huffyuv in AVI (the tables of hfyu.avi)":
                (os.path.join(tmp, "hfyu.avi"), 4),
            "image2 PNG pattern": (os.path.join(tmp, "p_%d.png"), 4),
            "image2 JPEG pattern (pan/%d.jpg)":
                (os.path.join(VIDEO_DIR, "pan", "%d.jpg"), 4)}
        times = {k: host_mean_ms(lambda p=p: list(VideoReader(p)),
                                 DECODE_TIMED) / n
                 for k, (p, n) in sources.items()}
        times["MPEG-4 Part 2 (mp4v) in AVI (cv2.VideoWriter, pan_mp4v.avi)"] \
            = host_mean_ms(lambda: list(VideoReader(os.path.join(
                VIDEO_DIR, "pan_mp4v.avi"))), DECODE_TIMED) / 4
    print("time video decode to BGR (host, demux included, ms per 640x480 "
          f"frame, mean of {DECODE_TIMED} passes after a warm one): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
          + f" ({card})")
    mpeg4_frame_times(card)
    vp8_sources(eng, card, counts, default_icp)
    vp9_sources(eng, card, counts, default_icp)
    mpeg2_sources(eng, card, counts, default_icp)
    raw_sources(eng, card, counts, default_icp)
    demux_sources(eng, card, counts, default_icp)
    h263_sources(eng, card, counts, default_icp)
    msmpeg4_sources(eng, card, counts, default_icp)
    wmv2_sources(eng, card, counts, default_icp)


def mpeg4_frame_times(card) -> None:
    """Host time of one 640x480 MPEG-4 Part 2 I-VOP and one P-VOP of
    ``pan_mp4v.avi`` (decode to BGR, no demux), mean of DECODE_TIMED
    calls after a warm one; the P-VOP decodes each time against the
    picture the call before left."""
    from fealess_tpu_torch.io.avi import AviFile
    from fealess_tpu_torch.io.mpeg4 import Mpeg4Decoder

    with AviFile(os.path.join(VIDEO_DIR, "pan_mp4v.avi")) as avi:
        packets = list(avi.frames())
        fourcc = avi.stream.compression
    kinds = [(p[p.index(b"\x00\x00\x01\xb6") + 4] >> 6) for p in packets]
    check(kinds[:2] == [0, 1], f"pan_mp4v.avi: VOP types {kinds}, expected "
                               f"an I-VOP then P-VOPs")
    dec = Mpeg4Decoder(b"", fourcc)
    times = {"I-VOP": host_mean_ms(lambda: dec.decode(packets[0]),
                                   DECODE_TIMED),
             "P-VOP": host_mean_ms(lambda: dec.decode(packets[1]),
                                   DECODE_TIMED)}
    dec.close()
    print(f"time MPEG-4 Part 2 decode to BGR (host, 640x480, "
          f"{len(packets[0])}-byte I-VOP, {len(packets[1])}-byte P-VOP, mean "
          f"of {DECODE_TIMED} after a warm call): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
          + f" ({card})")


def vp8_sources(eng, card, counts, default_icp) -> None:
    """Phase 7f's VP8 part: every committed source of ``tests/data/
    torch_vp8`` (``cv2.VideoWriter``'s VP80 in AVI, Matroska and WebM, and
    streams re-encoded with header fields changed) decoded by
    ``VideoReader`` to cv2's digests; ``acq --device cuda --clouds`` from
    the 640x480 WebM clip and ``recon`` on its package in both ICP
    settings (``acq_recon_source``); host times of a 640x480 key frame,
    an inter frame and ``VideoReader`` a frame."""
    import hashlib

    import numpy as np
    from fealess_tpu_torch.io.video import VideoReader
    from fealess_tpu_torch.io.vp8 import Vp8Decoder

    with open(os.path.join(VP8_DIR, "digests.json")) as f:
        digests = json.load(f)
    with open(os.path.join(VP8_DIR, "recon.json")) as f:
        expect = json.load(f)

    def sha(a) -> str:
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    for name, want in sorted(digests.items()):
        with VideoReader(os.path.join(VP8_DIR, name)) as reader:
            frames = list(reader)
        got = {"frames": len(frames),
               "shapes": [list(f.shape) for f in frames],
               "sha256": [sha(f) for f in frames]}
        check(got == want, f"video {name}: {got}, cv2 gives {want}")
    print(f"VP8 input: {len(digests)} committed sources ("
          f"{sum(d['frames'] for d in digests.values())} frames: "
          f"cv2.VideoWriter's VP80 in AVI, Matroska and WebM at 640x480 "
          f"(golden refreshes, a scene cut), 96x64, 94x62 and 16x16, motion "
          f"past the edge, 2 and 60 fps; re-encoded with a hidden frame, "
          f"versions 1-3, reference copies and sign biases, kept "
          f"probabilities, the simple filter and sharpness, 2-8 token "
          f"partitions, no skip flags; scale bits and 93x61 in the key "
          f"frames): frame counts and every frame's sha256 equal to "
          f"cv2.VideoCapture's")
    name = "pan_vp8.webm"
    acq_recon_source(eng, card, counts, default_icp, name,
                     digests[name]["frames"], expect["sources"][name],
                     "VP8 in WebM", False, VP8_DIR)

    # a key frame and an inter frame decoded to BGR (no demux); the inter
    # frame decodes each time against the references the call before left
    with VideoReader(os.path.join(VP8_DIR, name)) as reader:
        packets = list(reader._packets())
    check([not p[0] & 1 for p in packets[:2]] == [True, False],
          f"{name}: frame types {[p[0] & 1 for p in packets]}, expected a "
          f"key frame then inter frames")
    dec = Vp8Decoder(name, "Matroska")
    times = {"key frame": host_mean_ms(lambda: dec.decode(packets[0]),
                                       DECODE_TIMED),
             "inter frame": host_mean_ms(lambda: dec.decode(packets[1]),
                                         DECODE_TIMED)}
    dec.close()
    times["VideoReader a frame (demux included)"] = host_mean_ms(
        lambda: list(VideoReader(os.path.join(VP8_DIR, name))),
        DECODE_TIMED) / len(packets)
    print(f"time VP8 decode to BGR (host, 640x480, {len(packets[0])}-byte "
          f"key frame, {len(packets[1])}-byte inter frame, mean of "
          f"{DECODE_TIMED} after a warm call): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
          + f" ({card})")


def vp9_sources(eng, card, counts, default_icp) -> None:
    """Phase 7f's VP9 part: every committed source of ``tests/data/
    torch_vp9`` (``cv2.VideoWriter``'s VP90 in AVI, MP4, Matroska and WebM,
    and streams re-encoded with header fields changed or hand-built)
    decoded by ``VideoReader`` to cv2's digests; ``acq --device cuda
    --clouds`` from the 640x480 WebM clip and ``recon`` on its package in
    both ICP settings (``acq_recon_source``); host times of a 640x480 key
    frame, an inter frame and ``VideoReader`` a frame, on that clip and on
    the 640x480 pan of noise (``vp9_pan640.webm``)."""
    import hashlib

    import numpy as np
    from fealess_tpu_torch.io.video import VideoReader
    from fealess_tpu_torch.io.vp9 import Vp9Decoder

    with open(os.path.join(VP9_DIR, "digests.json")) as f:
        digests = json.load(f)
    with open(os.path.join(VP9_DIR, "recon.json")) as f:
        expect = json.load(f)

    def sha(a) -> str:
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    for name, want in sorted(digests.items()):
        with VideoReader(os.path.join(VP9_DIR, name)) as reader:
            frames = list(reader)
        got = {"frames": len(frames),
               "shapes": [list(f.shape) for f in frames],
               "sha256": [sha(f) for f in frames]}
        check(got == want, f"video {name}: {got}, cv2 gives {want}")
    print(f"VP9 input: {len(digests)} committed sources ("
          f"{sum(d['frames'] for d in digests.values())} frames: "
          f"cv2.VideoWriter's VP90 in AVI, MP4, Matroska and WebM at "
          f"1280x720 (four tile columns, then two), 640x480, 96x64, 94x62 "
          f"and 16x16, motion past the edge, 2 and 60 fps; re-encoded with "
          f"backward adaptation, probability contexts, error resilience, "
          f"fixed and bilinear filters, altref blocks, loop-filter and "
          f"quantiser settings, tile rows; full range; superframes, a "
          f"hidden frame, show_existing_frame): frame counts and every "
          f"frame's sha256 equal to cv2.VideoCapture's")
    name = "pan_vp9.webm"
    acq_recon_source(eng, card, counts, default_icp, name,
                     digests[name]["frames"], expect["sources"][name],
                     "VP9 in WebM", False, VP9_DIR)

    # a key frame and an inter frame decoded to BGR (no demux); the inter
    # frame decodes each time in a new decoder after the key frame (its
    # probability contexts and MVs differ once it has decoded itself)
    for clip in (name, "vp9_pan640.webm"):
        with VideoReader(os.path.join(VP9_DIR, clip)) as reader:
            packets = list(reader._packets())
        check([p[0] & 0x04 for p in packets[:2]] == [0, 4],
              f"{clip}: frame types {[p[0] & 0x04 for p in packets]}, "
              f"expected a key frame then inter frames")
        inter = []
        for _ in range(DECODE_TIMED + 1):
            dec = Vp9Decoder(clip, "Matroska")
            dec.decode(packets[0])
            t0 = time.perf_counter()
            frames = dec.decode(packets[1])
            inter.append((time.perf_counter() - t0) * 1e3)
            check(len(frames) == 1, f"{clip}: inter frame gave {frames}")
            dec.close()
        dec = Vp9Decoder(clip, "Matroska")
        times = {"key frame": host_mean_ms(lambda: dec.decode(packets[0]),
                                           DECODE_TIMED),
                 "inter frame": sum(inter[1:]) / DECODE_TIMED}
        dec.close()
        times["VideoReader a frame (demux included)"] = host_mean_ms(
            lambda: list(VideoReader(os.path.join(VP9_DIR, clip))),
            DECODE_TIMED) / len(packets)
        print(f"time VP9 decode to BGR (host, {clip}, 640x480, "
              f"{len(packets[0])}-byte key frame, {len(packets[1])}-byte "
              f"inter frame, mean of {DECODE_TIMED} after a warm call): "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
              + f" ({card})")


def mpeg2_sources(eng, card, counts, default_icp) -> None:
    """Phase 7f's MPEG-2 part: every committed source of ``tests/data/
    torch_mpeg2`` (``cv2.VideoWriter``'s MPG2 in AVI, MP4, MOV and
    Matroska, and streams edited at their start codes and header bits)
    decoded by ``VideoReader`` to cv2's digests; ``acq --device cuda
    --clouds`` from the 640x480 MP4 clip and ``recon`` on its package in
    both ICP settings (``acq_recon_source``); host times of a 640x480 I, P
    and B picture and of ``VideoReader`` a frame on the 16-frame pan."""
    import hashlib

    import numpy as np
    from fealess_tpu_torch.io.mpeg2 import Mpeg2Decoder
    from fealess_tpu_torch.io.video import VideoReader

    with open(os.path.join(MPEG2_DIR, "digests.json")) as f:
        digests = json.load(f)
    with open(os.path.join(MPEG2_DIR, "recon.json")) as f:
        expect = json.load(f)

    def sha(a) -> str:
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    for name, want in sorted(digests.items()):
        with VideoReader(os.path.join(MPEG2_DIR, name)) as reader:
            frames = list(reader)
        got = {"frames": len(frames),
               "shapes": [list(f.shape) for f in frames],
               "sha256": [sha(f) for f in frames]}
        check(got == want, f"video {name}: {got}, cv2 gives {want}")
    print(f"MPEG-2 input: {len(digests)} committed sources ("
          f"{sum(d['frames'] for d in digests.values())} frames: "
          f"cv2.VideoWriter's MPG2 in AVI, MP4, MOV and Matroska at "
          f"1280x720, 640x480 (a closed and an open GOP; noise of I and B "
          f"pictures), 96x64, 94x62 and 16x16, f_code 2 and up, 2 and 60 "
          f"fps; edited with loaded matrices, extensions, user data, "
          f"broken_link, sequence end codes, cuts before an open GOP, "
          f"low_delay, fine and coarse quantisers, a B picture's intra "
          f"macroblock, an odd width, extradata): frame counts and every "
          f"frame's sha256 equal to cv2.VideoCapture's")
    name = "pan_mpeg2.mp4"
    acq_recon_source(eng, card, counts, default_icp, name,
                     digests[name]["frames"], expect["sources"][name],
                     "MPEG-2 in MP4", False, MPEG2_DIR)

    # an I, a P and a B picture decoded to BGR (no demux), each timed in a
    # new decoder after the packets before it (an anchor moves the
    # references along, so it is not decoded twice in one decoder)
    clip = "mpeg2_pan.mp4"
    with VideoReader(os.path.join(MPEG2_DIR, clip)) as reader:
        packets = list(reader._packets())
    kinds = []
    for p in packets[:3]:
        at = p.index(b"\x00\x00\x01\x00") + 5
        kinds.append((p[at] >> 3) & 7)
    check(kinds == [1, 2, 3], f"{clip}: picture types {kinds}, expected "
                              f"I, P, B")
    times = {}
    for k, kind in enumerate(("I picture", "P picture", "B picture")):
        runs = []
        for _ in range(DECODE_TIMED + 1):
            dec = Mpeg2Decoder(b"", clip, "MP4")
            for p in packets[:k]:
                dec.decode(p)
            t0 = time.perf_counter()
            frames = dec.decode(packets[k])
            runs.append((time.perf_counter() - t0) * 1e3)
            check(len(frames) == (k > 0), f"{clip}: packet {k} gave "
                                          f"{len(frames)} frames")
            dec.close()
        times[kind] = sum(runs[1:]) / DECODE_TIMED
    times["VideoReader a frame (demux included)"] = host_mean_ms(
        lambda: list(VideoReader(os.path.join(MPEG2_DIR, clip))),
        DECODE_TIMED) / len(packets)
    print(f"time MPEG-2 decode to BGR (host, {clip}, 640x480, "
          f"{len(packets[0])}-byte I, {len(packets[1])}-byte P, "
          f"{len(packets[2])}-byte B picture, mean of {DECODE_TIMED} after a "
          f"warm call): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
          + f" ({card})")


def raw_sources(eng, card, counts, default_icp) -> None:
    """Phase 7f's part for the sources read with no new decoder: every
    committed source of ``tests/data/torch_raw`` (YUV4MPEG2, the MPEG
    video elementary stream, raw gray / NV12 / RGBA in AVI, Matroska and
    MOV, AVI's jpeg / LJPG / GEOX, MOV's MPEG-2 tags, raw Motion JPEG, a
    PNG pipe, a PAM image that gives no frame) decoded by ``VideoReader``
    to cv2's digests; ``acq --device cuda --clouds`` from the 640x480
    YUV4MPEG2 clip and ``recon`` on its package in both ICP settings
    (``acq_recon_source``); host times a 640x480 frame of the YUV4MPEG2
    reader and of the elementary stream reader (on ``tests/data/
    torch_mpeg2/mpeg2_pan.avi``'s packets joined into a stream, whose
    frames must be the AVI's)."""
    import hashlib

    import numpy as np
    from fealess_tpu_torch.io import mpegvideo
    from fealess_tpu_torch.io.avi import AviFile
    from fealess_tpu_torch.io.video import VideoReader

    t_part = time.perf_counter()
    with open(os.path.join(RAW_DIR, "digests.json")) as f:
        digests = json.load(f)
    with open(os.path.join(RAW_DIR, "recon.json")) as f:
        expect = json.load(f)

    def sha(a) -> str:
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    for name, want in sorted(digests.items()):
        with VideoReader(os.path.join(RAW_DIR, name)) as reader:
            frames = list(reader)
        got = {"frames": len(frames),
               "shapes": [list(f.shape) for f in frames],
               "sha256": [sha(f) for f in frames]}
        check(got == want, f"video {name}: {got}, cv2 gives {want}")
    print(f"raw and demuxed input: {len(digests)} committed sources ("
          f"{sum(d['frames'] for d in digests.values())} frames: "
          f"cv2.VideoWriter's YUV4MPEG2 (I420, Y800, YUY2), AVI jpeg, LJPG, "
          f"GEOX, Y800, GREY, Y8, NV12 and RGBA, Matroska Y800, NV12 and "
          f"RGBA, MOV RGBA, xd5b and mp2v, raw Motion JPEG, an MPEG-2 "
          f"elementary stream (and two streams joined, a last picture cut "
          f"in its headers), 640x480 YUV4MPEG2; hand-made YUV4MPEG2 at "
          f"17x33, gray, full range, FRAME parameters, C420mpeg2, cut "
          f"short; raw AVIs at odd widths with padded rows; a PNG pipe; a "
          f"PAM image of no frame): frame counts and every frame's sha256 "
          f"equal to cv2.VideoCapture's")
    name = "pan_y4m.y4m"
    acq_recon_source(eng, card, counts, default_icp, name,
                     digests[name]["frames"], expect["sources"][name],
                     "YUV4MPEG2 (I420)", False, RAW_DIR)

    # host time a 640x480 frame, demux included
    clip = os.path.join(MPEG2_DIR, "mpeg2_pan.avi")
    with AviFile(clip) as avi:
        packets = list(avi.frames())
    with tempfile.TemporaryDirectory() as tmp:
        m2v = os.path.join(tmp, "pan.m2v")
        with open(m2v, "wb") as f:
            f.write(b"".join(packets))
        with open(m2v, "rb") as f:
            check(mpegvideo.packets(f.read()) == packets,
                  "the parser does not cut the joined stream at the AVI's "
                  "packets")
        got = list(VideoReader(m2v))
        want = list(VideoReader(clip))
        check(len(got) == len(want) == len(packets) and all(
            np.array_equal(a, b) for a, b in zip(got, want)),
            "the elementary stream does not decode to the AVI's frames")
        y4m = os.path.join(RAW_DIR, name)
        n_y4m = digests[name]["frames"]
        times = {
            f"YUV4MPEG2 ({name}, {n_y4m} frames)": host_mean_ms(
                lambda: list(VideoReader(y4m)), DECODE_TIMED) / n_y4m,
            f"MPEG-2 elementary stream (mpeg2_pan.avi's {len(packets)} "
            f"packets joined)": host_mean_ms(
                lambda: list(VideoReader(m2v)), DECODE_TIMED) / len(packets)}
    print("time raw and elementary stream input to BGR (host, demux "
          f"included, ms per 640x480 frame, mean of {DECODE_TIMED} passes "
          "after a warm one): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
          + f" ({card})")
    print(f"time phase 7f raw and demuxed part: "
          f"{time.perf_counter() - t_part:.1f} s ({card})")


def demux_640(tmp: str):
    """(container name, its file, the same codec's packets in AVI, frames)
    for each container of ``demux_sources``' host times, muxed in ``tmp``
    by ``tests/stream_mux.py`` from the committed 640x480 clips' packets:
    MPEG-2 (``mpeg2_pan.avi``'s first 8) in program and transport streams,
    Motion JPEG (``clip.avi``) in fragmented MP4 and ASF, VP8
    (``pan_vp8.webm``) in Ogg, VP9 (``pan_vp9.webm``) in FLV, MPEG-4 Part
    2 (``pan_mp4v.avi``) in NUT."""
    import struct

    import importlib.util

    from fealess_tpu_torch.io.avi import AviFile
    from fealess_tpu_torch.io.matroska import MkvFile

    def repo_module(name):
        # by path: an installed package named "tests" would shadow the
        # repo's directory, which has no __init__.py
        spec = importlib.util.spec_from_file_location(
            f"_chip_smoke_{name}", os.path.join(REPO, "tests", f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
    sm = repo_module("stream_mux")
    mux_avi = repo_module("make_torch_video").mux_avi

    def avi_packets(path, n=None):
        with AviFile(path) as avi:
            return list(avi.frames())[:n]

    def mkv_packets(path):
        with MkvFile(path) as mkv:
            return list(mkv.frames())

    def write(name, data):
        path = os.path.join(tmp, name)
        with open(path, "wb") as f:
            f.write(data)
        return path

    mpeg2 = avi_packets(os.path.join(MPEG2_DIR, "mpeg2_pan.avi"), 8)
    mpeg2_avi = write("mpeg2.avi", mux_avi(mpeg2, 640, 480, b"mpg2"))
    clip = os.path.join(VIDEO_DIR, "clip.avi")
    mjpeg = avi_packets(clip)
    mp4v_avi = os.path.join(VIDEO_DIR, "pan_mp4v.avi")
    vp8 = mkv_packets(os.path.join(VP8_DIR, "pan_vp8.webm"))
    vp9 = mkv_packets(os.path.join(VP9_DIR, "pan_vp9.webm"))
    with open(os.path.join(DEMUX_DIR, "ismv_MJPG.ismv"), "rb") as f:
        ismv = f.read()
    with open(os.path.join(DEMUX_DIR, "asf_MJPG.asf"), "rb") as f:
        asf = f.read()
    info = b"OVP80\x01\x01\x00" + struct.pack(">HH", 640, 480) + \
        (1).to_bytes(3, "big") * 2 + struct.pack(">II", 10, 1)
    comments = b"OVP80\x02 " + bytes(8)
    flv = [(9, 0, b"\x90vp09" + b"vpcC" + bytes(8))] + \
        [(9, 100 * k, (b"\x91" if k == 0 else b"\xa1") + b"vp09" + p)
         for k, p in enumerate(vp9)]
    return [
        ("MPEG program stream (MPEG-2)", write("a.mpg", sm.mux_ps(
            [b"".join(mpeg2)], "mpeg2", "mpeg2", 2000)), mpeg2_avi, 8),
        ("MPEG transport stream (MPEG-2)", write("a.ts", sm.mux_ts(
            mpeg2, 0x02)), mpeg2_avi, 8),
        ("BDAV MPEG transport stream (MPEG-2)", write("a.m2ts", sm.mux_ts(
            mpeg2, 0x02, bdav=True)), mpeg2_avi, 8),
        ("fragmented MP4 (Motion JPEG)", write("a.ismv", sm.mux_fmp4(
            ismv[:ismv.index(b"moof") - 4], mjpeg,
            [{"n": 1, "size": "trun", "base": "none"}] * len(mjpeg))),
         clip, len(mjpeg)),
        ("Ogg (VP8)", write("a.ogv", sm.mux_ogg([info, comments] + vp8)),
         write("vp8.avi", mux_avi(vp8, 640, 480, b"VP80")), len(vp8)),
        ("FLV (VP9)", write("a.flv", sm.mux_flv(flv)),
         write("vp9.avi", mux_avi(vp9, 640, 480, b"VP90")), len(vp9)),
        ("ASF (Motion JPEG)", write("a.asf", sm.mux_asf(
            asf[:struct.unpack_from("<Q", asf, 16)[0]], mjpeg, 3200)),
         clip, len(mjpeg)),
        ("NUT (MPEG-4 Part 2)", write("a.nut", sm.mux_nut(
            avi_packets(mp4v_avi), b"mp4v", 640, 480)), mp4v_avi, 4)]


def demux_sources(eng, card, counts, default_icp) -> None:
    """Phase 7f's part for the containers demuxed for codecs the port
    already decodes: every committed source of ``tests/data/torch_demux``
    (MPEG program and transport streams, BDAV, fragmented MP4, Ogg, FLV,
    ASF, NUT; the writer's and hand-muxed) decoded by ``VideoReader`` to
    cv2's digests; ``acq --device cuda --clouds`` from the 640x480 MPEG-TS
    and ``recon`` on its package in both ICP settings
    (``acq_recon_source``); host times a 640x480 frame of each container,
    demux included, beside the same packets read from AVI
    (``demux_640``), whose frames must be the container's."""
    import hashlib

    import numpy as np
    from fealess_tpu_torch.io.video import VideoReader

    t_part = time.perf_counter()
    with open(os.path.join(DEMUX_DIR, "digests.json")) as f:
        digests = json.load(f)
    with open(os.path.join(DEMUX_DIR, "recon.json")) as f:
        expect = json.load(f)

    def sha(a) -> str:
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    for name, want in sorted(digests.items()):
        with VideoReader(os.path.join(DEMUX_DIR, name)) as reader:
            frames = list(reader)
        got = {"frames": len(frames),
               "shapes": [list(f.shape) for f in frames],
               "sha256": [sha(f) for f in frames]}
        check(got == want, f"video {name}: {got}, cv2 gives {want}")
    print(f"demuxed input: {len(digests)} committed sources ("
          f"{sum(d['frames'] for d in digests.values())} frames: "
          f"cv2.VideoWriter's MPEG program streams (.mpg, .vob), transport "
          f"streams (.ts, BDAV .m2ts), fragmented MP4 (.ismv), Ogg, FLV, "
          f"ASF (.asf, .wmv) and NUT of MPEG-2, MPEG-4 Part 2, VP8, VP9, "
          f"Motion JPEG, FFV1, I420, PNG and Huffyuv, 640x480 MPEG-TS; "
          f"hand-muxed pack and PES forms, adaptation stuffing, BDAV null "
          f"packets, fragment defaults, Ogg packets over pages and a bad "
          f"CRC, FLV metadata, ASF fragments, NUT syncpoints and elision, "
          f"each cut short): frame counts and every frame's sha256 equal "
          f"to cv2.VideoCapture's")
    name = "pan_ts.ts"
    acq_recon_source(eng, card, counts, default_icp, name,
                     digests[name]["frames"], expect["sources"][name],
                     "MPEG-TS (MPEG-2)", False, DEMUX_DIR)

    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        for kind, path, avi, n in demux_640(tmp):
            got, want = list(VideoReader(path)), list(VideoReader(avi))
            check(len(got) == len(want) == n and all(
                np.array_equal(a, b) for a, b in zip(got, want)),
                f"{kind} does not decode to the same packets' frames in "
                f"AVI ({len(got)} and {len(want)} frames)")
            times[kind] = (
                host_mean_ms(lambda p=path: list(VideoReader(p)),
                             DECODE_TIMED) / n,
                host_mean_ms(lambda p=avi: list(VideoReader(p)),
                             DECODE_TIMED) / n)
    print("time demuxed input to BGR (host, demux included, ms per 640x480 "
          f"frame, mean of {DECODE_TIMED} passes after a warm one; the same "
          "packets in AVI beside): " + ", ".join(
              f"{k} {c:.3f} ms (AVI {a:.3f} ms)"
              for k, (c, a) in times.items()) + f" ({card})")
    print(f"time phase 7f demuxed part: {time.perf_counter() - t_part:.1f} s "
          f"({card})")


def h263_sources(eng, card, counts, default_icp) -> None:
    """Phase 7f's H.263 and Sorenson Spark part: every committed source of
    ``tests/data/torch_h263`` (``cv2.VideoWriter``'s H.263 at its five
    sizes in AVI, MOV, 3GP, 3G2, Matroska, ASF and NUT; its Sorenson Spark
    in FLV, SWF, AVI, MOV, Matroska, ASF and NUT at 1280x720 down to
    16x16; hand edits of the Sorenson headers) decoded by ``VideoReader``
    to cv2's digests; ``acq --device cuda --clouds`` from the 640x480
    Sorenson FLV and ``recon`` on its package in both ICP settings
    (``acq_recon_source``); host times of a 640x480 Sorenson and a 704x576
    H.263 I and P picture (each P in a new decoder after its I) and of
    ``VideoReader`` a frame on the 640x480 FLV."""
    import hashlib

    import numpy as np
    from fealess_tpu_torch.io.h263 import H263Decoder
    from fealess_tpu_torch.io.video import VideoReader

    t_part = time.perf_counter()
    with open(os.path.join(H263_DIR, "digests.json")) as f:
        digests = json.load(f)
    with open(os.path.join(H263_DIR, "recon.json")) as f:
        expect = json.load(f)

    def sha(a) -> str:
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    for name, want in sorted(digests.items()):
        with VideoReader(os.path.join(H263_DIR, name)) as reader:
            frames = list(reader)
        got = {"frames": len(frames),
               "shapes": [list(f.shape) for f in frames],
               "sha256": [sha(f) for f in frames]}
        check(got == want, f"video {name}: {got}, cv2 gives {want}")
    print(f"H.263 and Sorenson Spark input: {len(digests)} committed sources "
          f"({sum(d['frames'] for d in digests.values())} frames: "
          f"cv2.VideoWriter's H.263 at 128x96, 176x144, 352x288, 704x576 "
          f"and 1408x1152 in AVI (H263, U263), MOV, 3GP, 3G2, Matroska, ASF "
          f"and NUT; its Sorenson Spark in FLV, SWF, AVI (FLV1, s263), MOV, "
          f"Matroska, ASF and NUT at 1280x720, 640x480, 128x96, 96x64, "
          f"94x62, 16x14 and 16x16, checkerboards (11-bit escapes), fast "
          f"motion; edited to version 0, disposable P pictures, deblocking "
          f"0, PSPARE bytes and 95x63): frame counts and every frame's "
          f"sha256 equal to cv2.VideoCapture's")
    name = "pan_flv1.flv"
    acq_recon_source(eng, card, counts, default_icp, name,
                     digests[name]["frames"], expect["sources"][name],
                     "Sorenson Spark in FLV", False, H263_DIR)

    times = {}
    for clip, flavour, label in (("pan_flv1.flv", "sorenson",
                                  "640x480 Sorenson"),
                                 ("h263_704x576.avi", "h263",
                                  "704x576 H.263")):
        with VideoReader(os.path.join(H263_DIR, clip)) as reader:
            packets = list(reader._packets())
        for k, kind in enumerate(("I", "P")):
            runs = []
            for _ in range(DECODE_TIMED + 1):
                dec = H263Decoder(b"", b"", clip, "", flavour)
                for p in packets[:k]:
                    dec.decode(p)
                t0 = time.perf_counter()
                frame = dec.decode(packets[k])
                runs.append((time.perf_counter() - t0) * 1e3)
                check(frame.shape[:2] == tuple(digests[clip]["shapes"][k][:2]),
                      f"{clip}: packet {k} gave a {frame.shape} frame")
                dec.close()
            times[f"{label} {kind} ({len(packets[k])} bytes)"] = \
                sum(runs[1:]) / DECODE_TIMED
    clip = os.path.join(H263_DIR, "pan_flv1.flv")
    times["VideoReader a 640x480 Sorenson frame (demux included)"] = \
        host_mean_ms(lambda: list(VideoReader(clip)), DECODE_TIMED) / \
        digests["pan_flv1.flv"]["frames"]
    print(f"time H.263 and Sorenson Spark decode to BGR (host, mean of "
          f"{DECODE_TIMED} after a warm call): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
          + f" ({card})")
    print(f"time phase 7f H.263 part: {time.perf_counter() - t_part:.1f} s "
          f"({card})")


def msmpeg4_sources(eng, card, counts, default_icp) -> None:
    """Phase 7f's MS MPEG-4 v2 / v3 and WMV7 part: every committed source
    of ``tests/data/torch_msmpeg4`` (``cv2.VideoWriter``'s three codecs
    under each of their fourccs in AVI and in MOV, Matroska, ASF, WMV and
    NUT, at 640x480 down to 96x64, and its packets under a 95x63 AVI
    header) decoded by ``VideoReader`` to cv2's digests; ``acq --device
    cuda --clouds`` from the 640x480 DIV3 AVI and ``recon`` on its package
    in both ICP settings (``acq_recon_source``); host times of a 640x480
    MS MPEG-4 v3 I and P picture and a WMV7 P picture (each P in a new
    decoder after its I) and of ``VideoReader`` a frame on the DIV3 AVI."""
    import hashlib

    import numpy as np
    from fealess_tpu_torch.io.msmpeg4 import MSMPEG4Decoder
    from fealess_tpu_torch.io.video import VideoReader

    t_part = time.perf_counter()
    with open(os.path.join(MSMPEG4_DIR, "digests.json")) as f:
        digests = json.load(f)
    with open(os.path.join(MSMPEG4_DIR, "recon.json")) as f:
        expect = json.load(f)

    def sha(a) -> str:
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    for name, want in sorted(digests.items()):
        with VideoReader(os.path.join(MSMPEG4_DIR, name)) as reader:
            frames = list(reader)
        got = {"frames": len(frames),
               "shapes": [list(f.shape) for f in frames],
               "sha256": [sha(f) for f in frames]}
        check(got == want, f"video {name}: {got}, cv2 gives {want}")
    print(f"MS MPEG-4 v2 / v3 and WMV7 input: {len(digests)} committed "
          f"sources ({sum(d['frames'] for d in digests.values())} frames: "
          f"cv2.VideoWriter's MS MPEG-4 v2 (MP42, DIV2), v3 (DIV3, MP43, "
          f"DIV4, DIV5, DIV6, MPG3, AP41, COL1, COL0, 3IVD) and WMV7 (WMV1) "
          f"in AVI, each codec in MOV, Matroska, ASF, WMV and NUT, at "
          f"640x480, 128x96 (30 fps), 96x64 and 95x63, checkerboards, "
          f"halves moving apart, appearing squares, black and white "
          f"halves): frame counts and every frame's sha256 equal to "
          f"cv2.VideoCapture's")
    name = "pan_div3.avi"
    acq_recon_source(eng, card, counts, default_icp, name,
                     digests[name]["frames"], expect["sources"][name],
                     "MS MPEG-4 v3 in AVI", False, MSMPEG4_DIR)

    times = {}
    for clip, version, label, kinds in (
            ("pan_div3.avi", "msmpeg4v3", "640x480 MS MPEG-4 v3",
             ("I", "P")),
            ("wmv1_640x480.avi", "wmv1", "640x480 WMV7", ("P",))):
        with VideoReader(os.path.join(MSMPEG4_DIR, clip)) as reader:
            packets = list(reader._packets())
        for kind in kinds:
            k = ("I", "P").index(kind)
            runs = []
            for _ in range(DECODE_TIMED + 1):
                dec = MSMPEG4Decoder(version, 640, 480)
                for p in packets[:k]:
                    dec.decode(p)
                t0 = time.perf_counter()
                frame = dec.decode(packets[k])
                runs.append((time.perf_counter() - t0) * 1e3)
                check(frame.shape == tuple(digests[clip]["shapes"][k]),
                      f"{clip}: packet {k} gave a {frame.shape} frame")
                dec.close()
            times[f"{label} {kind} ({len(packets[k])} bytes)"] = \
                sum(runs[1:]) / DECODE_TIMED
    clip = os.path.join(MSMPEG4_DIR, "pan_div3.avi")
    times["VideoReader a 640x480 DIV3 frame (demux included)"] = \
        host_mean_ms(lambda: list(VideoReader(clip)), DECODE_TIMED) / \
        digests["pan_div3.avi"]["frames"]
    print(f"time MS MPEG-4 and WMV7 decode to BGR (host, mean of "
          f"{DECODE_TIMED} after a warm call): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
          + f" ({card})")
    print(f"time phase 7f MS MPEG-4 part: {time.perf_counter() - t_part:.1f} "
          f"s ({card})")


def wmv2_sources(eng, card, counts, default_icp) -> None:
    """Phase 7f's WMV8 part: every committed source of
    ``tests/data/torch_wmv2`` (``cv2.VideoWriter``'s WMV2 in AVI, MOV,
    Matroska, ASF, WMV and NUT, at 640x480 down to 94x62, P pictures in
    each qscale band, re-encoded with the other run/level and CBP tables,
    and its packets under a 95x63 AVI header) decoded by
    ``VideoReader`` to cv2's digests; ``acq --device cuda --clouds`` from
    the 640x480 ``.wmv`` and ``recon`` on its package in both ICP settings
    (``acq_recon_source``); host times of a 640x480 WMV8 I and P picture
    (the P in a new decoder after its I) and of ``VideoReader`` a frame
    on the ``.wmv``."""
    import hashlib

    import numpy as np
    from fealess_tpu_torch.io.video import VideoReader
    from fealess_tpu_torch.io.wmv2 import WMV2Decoder

    t_part = time.perf_counter()
    with open(os.path.join(WMV2_DIR, "digests.json")) as f:
        digests = json.load(f)
    with open(os.path.join(WMV2_DIR, "recon.json")) as f:
        expect = json.load(f)

    def sha(a) -> str:
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    for name, want in sorted(digests.items()):
        with VideoReader(os.path.join(WMV2_DIR, name)) as reader:
            frames = list(reader)
        got = {"frames": len(frames),
               "shapes": [list(f.shape) for f in frames],
               "sha256": [sha(f) for f in frames]}
        check(got == want, f"video {name}: {got}, cv2 gives {want}")
    print(f"WMV8 input: {len(digests)} committed sources "
          f"({sum(d['frames'] for d in digests.values())} frames: "
          f"cv2.VideoWriter's WMV2 in AVI, MOV, Matroska, ASF, WMV and NUT, "
          f"at 640x480, 128x96 (30 fps), 96x64, 95x63 and 94x62, "
          f"checkerboards, halves moving apart, appearing squares, black "
          f"and white halves, noise whose P pictures use the three CBP "
          f"tables, and that noise re-encoded with run/level tables 1 and "
          f"2 and cbp_index 1 and 2): frame counts and every frame's "
          f"sha256 equal to cv2.VideoCapture's")
    name = "pan_wmv2.wmv"
    acq_recon_source(eng, card, counts, default_icp, name,
                     digests[name]["frames"], expect["sources"][name],
                     "WMV8 in ASF (.wmv)", False, WMV2_DIR)

    times = {}
    with VideoReader(os.path.join(WMV2_DIR, name)) as reader:
        packets, extradata = list(reader._packets()), reader.extradata
    for k, kind in enumerate(("I", "P")):
        runs = []
        for _ in range(DECODE_TIMED + 1):
            dec = WMV2Decoder(extradata, 640, 480)
            for p in packets[:k]:
                dec.decode(p)
            t0 = time.perf_counter()
            frame = dec.decode(packets[k])
            runs.append((time.perf_counter() - t0) * 1e3)
            check(frame.shape == tuple(digests[name]["shapes"][k]),
                  f"{name}: packet {k} gave a {frame.shape} frame")
            dec.close()
        times[f"640x480 WMV8 {kind} ({len(packets[k])} bytes)"] = \
            sum(runs[1:]) / DECODE_TIMED
    clip = os.path.join(WMV2_DIR, name)
    times["VideoReader a 640x480 WMV8 frame (ASF demux included)"] = \
        host_mean_ms(lambda: list(VideoReader(clip)), DECODE_TIMED) / \
        digests[name]["frames"]
    print(f"time WMV8 decode to BGR (host, mean of {DECODE_TIMED} after a "
          f"warm call): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
          + f" ({card})")
    print(f"time phase 7f WMV8 part: {time.perf_counter() - t_part:.1f} s "
          f"({card})")


# -- phase 8: the rest of the public surface --------------------------------

def stage_rows(err: str):
    """[(name, ms)] of a ``--profile`` device-stage table in ``err``."""
    lines = err.splitlines()
    heads = [i for i, ln in enumerate(lines)
             if ln.startswith("# device stages (")]
    check(len(heads) == 1, f"--profile printed {len(heads)} device tables")
    rows = [(ln[2:38].strip(), float(ln[38:].split()[0]))
            for ln in lines[heads[0] + 1:heads[0] + 4]]
    check([name for name, _ in rows] == STAGE_ROWS,
          f"device-stage rows {rows}")
    return rows


def rows_ok(rows, what: str) -> None:
    """Every row positive, none below the row before by more than
    STAGE_SLACK_MS (the rows are cumulative prefixes)."""
    ms = [v for _, v in rows]
    check(all(0 < v < float("inf") for v in ms), f"{what}: rows {rows}")
    check(all(b >= a - STAGE_SLACK_MS for a, b in zip(ms, ms[1:])),
          f"{what}: a row below the one before it: {rows}")


def surface_phase(eng, bgr_np, depth_np, cam, card, counts, default_icp,
                  pkg: str) -> None:
    """Phase 8: the device-stage table on the fixture engine beside
    ``profile_reco``'s device busy, ``recon --profile`` and ``track
    --profile`` on phase 4d's package, EPnP on the fixture's model depth
    and the overlays and PLY dump against the JAX package's outputs."""
    import contextlib
    import hashlib
    import io

    import numpy as np
    import torch
    from fealess_tpu_torch.apps import cli, fixture, visualize
    from fealess_tpu_torch.apps.profile_reco import profile_frames
    from fealess_tpu_torch.engine import CamIntrinsics
    from fealess_tpu_torch.io.png import read_png
    from fealess_tpu_torch.utils.profiling import WARMUP

    zero_counts, read_counts, path_launches, counted = counts
    eng.set_advanced_param("icp_mode", default_icp.mode)
    calls = WARMUP + cli.PROFILE_ITERS

    # 8a. the device-stage table (front-end, match, full step) against the
    # device busy of whole recognitions, per ICP setting
    for setting in ("a", "b"):
        apply_setting(eng, setting, default_icp)
        zero_counts()
        t0 = time.perf_counter()
        rows = cli._profile_stages(eng, bgr_np, depth_np, cam)
        table_s = time.perf_counter() - t0
        path = f"device-stage table ({setting})"
        read_counts(path)
        rows = [(name, secs * 1e3) for name, secs in rows]
        rows_ok(rows, path)
        # front: no kernel; match: K1 and K2 once a call; full: K1, K2 and
        # K3 EXPECT_NN times a call
        want = [2 * calls, 2 * calls, EXPECT_NN[setting] * calls]
        check(path_launches[path] == want,
              f"{path}: launches {path_launches[path]}, expected {want} "
              f"({calls} calls a row)")
        busy = profile_frames(f"top1 setting {setting} ({eng.cfg.icp.mode})",
                              lambda: eng.recognition(bgr_np, depth_np, cam),
                              PROFILE_FRAMES, None)
        full = rows[-1][1]
        check(abs(full - busy) <= FULL_TOL * busy,
              f"{path}: full {full:.4f} ms against profile_reco's device "
              f"busy {busy:.4f} ms")
        print(f"device stages top1 ({setting}, {eng.cfg.icp.mode}): "
              + ", ".join(f"{name} {ms:.4f}" for name, ms in rows)
              + f" ms/frame; profile_reco device busy {busy:.4f} ms/frame "
              f"(full / busy {full / busy:.4f}); launches K1/K2/K3 "
              f"{path_launches[path]} over {calls} calls a row; the table "
              f"took {table_s:.1f} s ({card})")
    apply_setting(eng, "a", default_icp)

    # 8b. recon --profile and track --profile on phase 4d's package
    for action in ("recon", "track"):
        out, err = io.StringIO(), io.StringIO()
        zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main([action, pkg, "--profile", "--device", "cuda"])
        cli_s = time.perf_counter() - t0
        read_counts(f"CLI {action} --profile")
        lines = [ln for ln in out.getvalue().splitlines()
                 if ln.startswith("{")]
        check(rc == 0 and len(lines) == TRAIN_FRAMES,
              f"CLI {action} --profile: rc {rc}, {len(lines)} lines")
        rows = stage_rows(err.getvalue())
        rows_ok(rows, f"CLI {action} --profile")
        print(f"CLI {action} --profile ({TRAIN_FRAMES}-template package): "
              + ", ".join(f"{name} {ms:.4f}" for name, ms in rows)
              + f" ms/frame; the command took {cli_s:.1f} s ({card})")

    # 8c. EPnP on the fixture's model depth (host float64, as the JAX
    # package runs cv2 on the host)
    raw = read_png(os.path.join(fixture.FIXTURE, "features", "depth",
                                "0.png"))
    k_cam = CamIntrinsics(cam.fx, cam.fy, cam.cx, cam.cy, 640, 480)
    plane = np.full((160, 240), 12000, np.uint16)
    yy, xx = np.mgrid[40:120, 60:180]
    plane[40:120, 60:180] = (7000 + 4 * (xx - 60) + 2 * (yy - 40)).astype(
        np.uint16)
    cases = {name: (raw, k_cam) + case for name, case in EPNP_CASES.items()}
    cases["planar"] = (plane, CamIntrinsics(608.0, 608.0, 120.0, 80.0, 240,
                                            160), np.eye(3).tolist(),
                       (0.0, 0.0, 0.0), (0, 0))
    for name, (depth_raw, k_case, rot, t, offset) in cases.items():
        init = np.eye(4, dtype=np.float32)
        init[:3, :3] = rot
        init[:3, 3] = t
        t0 = time.perf_counter()
        pose = eng.compute_pose_epnp(depth_raw, *offset, init, k_case)
        ms = (time.perf_counter() - t0) * 1e3
        want = np.asarray(EXPECT_EPNP[name], np.float64)
        check(pose is not None and pose.shape == (4, 4)
              and bool(np.isfinite(pose).all()), f"EPnP {name}: {pose}")
        d_rot = rotation_deg(pose[:3, :3].astype(np.float64).T
                             @ want[:, :3])
        d_t = float(np.abs(pose[:3, 3] - want[:, 3]).max())
        check(d_rot <= EPNP_ROT_TOL_DEG and d_t <= EPNP_T_TOL_MM,
              f"EPnP {name}: {pose[:3].tolist()} vs JAX's {want.tolist()}")
        print(f"EPnP {name}: t {[round(float(v), 4) for v in pose[:3, 3]]} "
              f"mm, {d_rot:.2e} deg / {d_t:.2e} mm from the JAX package's; "
              f"{ms:.1f} ms on the host ({card})")

    # 8d. draw_response, blit_template and save_ply against the sha256 of
    # the JAX package's outputs (cv2.circle) on the same inputs
    bank = eng.bank
    t0 = time.perf_counter()
    got = {"draw t5": visualize.draw_response(bgr_np.copy(), bank, 0,
                                              (237, 157), level=0, t=5),
           "draw t8 level 1": visualize.draw_response(
               bgr_np.copy(), bank, 0, (-20, 380), level=1, t=8),
           "draw gray": visualize.draw_response(
               np.ascontiguousarray(bgr_np[..., 1]), bank, 0, (560, -40),
               t=8),
           "blit": visualize.blit_template(
               bgr_np.copy(), np.ascontiguousarray(bgr_np[157:316, 237:428,
                                                          1]), (500, 400))}
    draw_ms = (time.perf_counter() - t0) * 1e3
    vv, uu = np.mgrid[150:330, 230:440]
    pts = np.stack([uu, vv, depth_np[150:330, 230:440]], -1).reshape(
        -1, 3).astype(np.float32)
    pts[::97] = np.nan
    cols = torch.from_numpy(bgr_np[150:330, 230:440].reshape(-1, 3)).to(
        eng.device)
    valid = torch.from_numpy(depth_np[150:330, 230:440] > 0).reshape(-1)
    pts_dev = torch.from_numpy(pts).to(eng.device)
    for name, img in got.items():
        digest = hashlib.sha256(np.ascontiguousarray(img).tobytes())
        check(digest.hexdigest() == EXPECT_VISUAL_SHA256[name],
              f"{name}: sha256 {digest.hexdigest()}")
    with tempfile.TemporaryDirectory() as tmp:
        for name, args in (("ply", (pts_dev,)),
                           ("ply colors valid", (pts_dev, cols, valid))):
            path = os.path.join(tmp, "cloud.ply")
            n = visualize.save_ply(path, *args)
            with open(path, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            check((n, digest) == EXPECT_VISUAL_SHA256[name],
                  f"{name}: {n} points, sha256 {digest}")
    print(f"visualize: {len(got)} overlays and 2 PLY files equal the JAX "
          f"package's (sha256); the three draw_response calls and the blit "
          f"took {draw_ms:.1f} ms on the host ({card})")


# -- phase 9: the kernel lab ------------------------------------------------

def lab_coarse_cases(planes, table, slots: int = 4096):
    """L1's and L2's cases on the lab's coarse inputs (bucketed, even
    bucket starts), {name: [(kernel, twin, args)]}: each L1 mode and both
    L2 settings on the inputs as they are; on a table of odd bucket counts
    (``fixture_like``'s own draw, every mode but unroll2); on planes 37
    columns wide and one row high; with every third template featureless;
    with every feature in the last bucket at the largest offsets (rx = ry
    = NB - 1, the bottom and right edges); with ``slots`` feature slots a
    template in 4 buckets (4096: up to 1024 in one bucket, so the packed
    lanes flush inside a bucket), on u8 up to 255; on planes all 255 with
    300 live features in each bucket (``lab.crowded_table``: a lane that
    takes more than 257 adds between flushes overflows, so a flush count
    carried wrongly across buckets shows); and on planes 1, 2 and 3 bytes
    past a 4-byte boundary.  noshift reads whole words, so only
    where the planes start on a boundary and hold a multiple of 4
    bytes."""
    import torch
    from fealess_tpu_torch.ops import lab
    c, hd, wd = planes.shape
    n, nf = table["c"].shape
    nb = table["bstart"].shape[1] - 1
    dev = planes.device
    odd = lab.fixture_like(seed=2, n=n, f=nf, nb=nb, hd=hd, wd=wd, c=c,
                           device=dev)[1]
    none = {k: v.clone() for k, v in table.items()}
    none["bstart"][::3] = 0
    edge = {k: v.clone() for k, v in table.items()}
    edge["bstart"][:, :-1] = 0
    edge["rx"][:] = nb - 1
    edge["ry"][:] = nb - 1
    wide = lab.fixture_like(seed=3, n=8, f=slots, nb=4, hd=hd, wd=wd, c=c,
                            device=dev)[1]
    crowded = lab.crowded_table(n=8, per_bucket=min(300, slots // nb),
                                nb=nb, f=slots, c=c, device=dev)
    g = torch.Generator(device=dev).manual_seed(9)
    loud = torch.randint(0, 256, planes.shape, generator=g,
                         dtype=torch.uint8, device=dev)
    flat = torch.cat([planes.new_zeros(3), planes.reshape(-1)])
    inputs = [(planes, table), (planes, odd),
              (planes[:, :, :37].contiguous(), table),
              (planes[:, :1].contiguous(), table), (planes, none),
              (planes, edge), (loud, wide),
              (torch.full_like(planes, 255), crowded)]
    inputs += [(flat[k:k + planes.numel()].view(planes.shape), table)
               for k in (1, 2, 3)]
    cases = {"coarse_variant": [], "coarse_stride2": []}
    for p, t in inputs:
        even = bool((t["bstart"] % 2 == 0).all())
        words = p.data_ptr() % 4 == 0 and p.numel() % 4 == 0
        cases["coarse_variant"] += [
            (lab.coarse_variant, lab.coarse_variant_plain, (p, t, mode))
            for mode in lab.MODES
            if (mode != "unroll2" or even) and (mode != "noshift" or words)]
        cases["coarse_stride2"] += [
            (lab.coarse_stride2, lab.coarse_stride2_plain, (p, t, skip))
            for skip in (False, True)]
    return cases


def lab_local_cases(planes, table_k, px0, py0, slots: int = 4096):
    """L3's cases in its four settings, [(kernel, twin, args)]: the lab's
    origins; origins 20 cells up and left of them (negative, clamped) and
    windows past the plane's right and bottom edges; planes 125 columns
    wide (Wd not a multiple of 4); planes 1 byte past a 4-byte boundary;
    ``slots`` feature slots a candidate (4096: up to 105 a bucket at the
    lab's 39) on u8 up to 255; one candidate and none; planes all 255 with
    300 live features in each of 13 buckets (``lab.crowded_table``, 3900
    a candidate: each slice's range holds 488, so a slice that flushed its
    packed lanes less often than every 257 features would overflow them);
    and the stride-2 edges where the TPU's shifted copy zeroed the last
    column, candidate i's stride-2 bucket j = i % ceil(NB / 2) read from
    px0 + 2j + 1 = Wd - 1 and = Wd, on the planes, at Wd = 125 and 1 byte
    past a 4-byte boundary."""
    import torch
    from fealess_tpu_torch.ops import lab
    c, hd, wd = planes.shape
    k, nf = table_k["c"].shape
    nb = table_k["bstart"].shape[1] - 1
    dev = planes.device
    far = torch.arange(k, device=dev, dtype=torch.int32) % 3 * 7
    wide = lab.fixture_like(seed=5, n=8, f=slots, nb=nb, hd=hd, wd=wd, c=c,
                            device=dev)[1]
    crowded = lab.crowded_table(n=8, per_bucket=min(300, slots // 13),
                                nb=13, f=slots, c=c, device=dev)
    g = torch.Generator(device=dev).manual_seed(10)
    loud = torch.randint(0, 256, planes.shape, generator=g,
                         dtype=torch.uint8, device=dev)
    flat = torch.cat([planes.new_zeros(1), planes.reshape(-1)])
    narrow = planes[:, :, :125].contiguous()
    shifted = flat[1:1 + planes.numel()].view(planes.shape)
    inputs = [(planes, table_k, px0, py0),
              (planes, table_k, px0 - 20, py0 - 20),
              (planes, table_k, wd - 16 + far, hd - 16 + far),
              (narrow, table_k, px0, py0),
              (shifted, table_k, px0, py0),
              (loud, wide, px0[:8].contiguous(), py0[:8].contiguous()),
              (planes, {key: v[:1] for key, v in table_k.items()}, px0[:1],
               py0[:1]),
              (planes, {key: v[:0] for key, v in table_k.items()}, px0[:0],
               py0[:0]),
              (torch.full_like(planes, 255), crowded, px0[:8].contiguous(),
               py0[:8].contiguous())]
    j = torch.arange(k, device=dev, dtype=torch.int32) % -(-nb // 2)
    for p in (planes, narrow, shifted):
        inputs += [(p, table_k, p.shape[2] - 1 - end - 2 * j, py0)
                   for end in (1, 0)]
    return [(lab.local_variant, lab.local_variant_plain,
             args + (stride, cond)) for args in inputs
            for stride, cond in ((1, False), (1, True), (2, False),
                                 (2, True))]


def lab_nn_cases(query, ref):
    """L4's cases, [(query, ref, (tq, tr), planted)]: the lab's clouds;
    reference rows duplicated across every 2048-row boundary b (row b =
    row b - 1, the query ``planted[i]`` rows there, whose first index
    b - 1 must win exactly); ragged counts (queries not a multiple of the
    256-query block, references not of 2048, fewer than 2048, one, and
    fewer queries than a warp's 32); and other tiles (64 queries a block,
    1000 rows)."""
    nq, nr = query.shape[0], ref.shape[0]
    bounds = list(range(2048, nr, 2048))
    straddle = ref.clone()
    for b in bounds:
        straddle[b] = straddle[b - 1]
    planted = query.clone()
    planted[:len(bounds)] = straddle[[b - 1 for b in bounds]]
    ragged = query[:nq - 77].contiguous()
    return [(query, ref, (256, 2048), None),
            (planted, straddle, (256, 2048), [b - 1 for b in bounds]),
            (ragged, ref[:nr - 333].contiguous(), (256, 2048), None),
            (ragged, ref[:300].contiguous(), (256, 2048), None),
            (query, ref[5:6].contiguous(), (256, 2048), None),
            (query[:20].contiguous(), ref, (256, 2048), None),
            (planted, straddle, (64, 1000), [b - 1 for b in bounds])]


def hold_nn_mxu(cases, errs, where: str) -> None:
    """L4 against its twin and against K3 by ``lab.near_tie`` in every
    row (the lab's near-tie rule, and d2 within the matrix form's
    rounding, ``lab.D2_CANCEL`` of |q|^2 + |r|^2), planted duplicates at
    their first index exactly; prints the equal indices, the largest
    relative d2 gap and the largest share of the d2 limit of each case;
    ``errs["nn_mxu"]`` keeps the largest |d2 - d2_twin|."""
    import torch
    from fealess_tpu_torch.ops import lab, nn
    errs.setdefault("nn_mxu", 0.0)
    for i, (q, r, tiles, planted) in enumerate(cases):
        idx, d2 = lab.nn_mxu(q, r, *tiles)
        twin = lab.nn_mxu_plain(q, r)
        k3 = nn.nearest_neighbor(q, r)
        if q.is_cuda:
            torch.cuda.synchronize()
        check(idx.dtype == torch.int32 and d2.dtype == torch.float32
              and idx.shape == twin[0].shape and d2.shape == twin[1].shape,
              f"nn_mxu ({where}) case {i}: {idx.dtype}{tuple(idx.shape)}")
        for what, want in (("twin", twin), ("K3", k3)):
            ok, same, worst, share = lab.near_tie(idx, d2, *want, q, r)
            check(ok, f"nn_mxu ({where}) case {i}: breaks the near-tie rule "
                  f"or the d2 limit against its {what} (max_rel "
                  f"{worst:.3e}, d2 share {share:.3e})")
            print(f"kernel nn_mxu ({where}) case {i}, {q.shape[0]} x "
                  f"{r.shape[0]}, tiles {tiles}: against its {what} "
                  f"idx_equal={same}/{idx.numel()} max_rel={worst:.3e} "
                  f"d2 share={share:.3e}")
        if planted:
            got = idx[:len(planted)].tolist()
            check(got == planted and
                  twin[0][:len(planted)].tolist() == planted,
                  f"nn_mxu ({where}) case {i}: planted duplicates at "
                  f"{got}, want the first index {planted}")
        if d2.numel():
            errs["nn_mxu"] = max(errs["nn_mxu"],
                                 (d2 - twin[1]).abs().max().item())


def hold_nn_operands(query, ref, where: str) -> None:
    """L4's operand kernel (``lab.nn_operands``) bitwise equal to its twin
    (``lab.nn_operands_plain`` in ``lab.tile_order``) on the lab's clouds,
    on ragged counts, and on points made of the finite TF32 rounding edges
    (``lab.TF32_EDGE_BITS`` under 1e18, so the norms stay finite): the card's
    cvt.rna against the twin's rule on the bits."""
    import torch
    from fealess_tpu_torch.ops import lab
    bits = torch.tensor(lab.TF32_EDGE_BITS, dtype=torch.int64)
    edges = (bits - (bits >> 31 << 32)).to(torch.int32).view(torch.float32)
    edges = edges[torch.isfinite(edges) & (edges.abs() < 1e18)]
    pts = torch.cat([edges, edges.flip(0), edges.roll(1)])
    pts = pts[:pts.numel() // 3 * 3].reshape(-1, 3).to(query.device)
    cases = [(query, ref), (query[:77].contiguous(), ref[:1001].contiguous()),
             (pts, pts.flip(0).contiguous())]
    for i, (q, r) in enumerate(cases):
        a, b = lab.nn_operands(q, r)
        want_a, want_b = lab.nn_operands_plain(q, r)
        if q.is_cuda:
            torch.cuda.synchronize()
        for name, got, want in (("A", a, want_a),
                                ("B", b, lab.tile_order(want_b))):
            check(got.shape == want.shape and torch.equal(
                got.view(torch.int32), want.view(torch.int32)),
                f"nn_operands ({where}) case {i}: {name} differs from its "
                f"twin")
    print(f"kernel nn_mxu ({where}): operands bitwise equal to their twin "
          f"on {len(cases)} cases (the last {pts.shape[0]} points of TF32 "
          f"rounding edges)")


def hold_to_served(coarse_cases, local_cases) -> None:
    """Every exact L1 mode and both L2 settings bitwise equal to K1, and
    every L3 setting bitwise equal to K2, on the same inputs (every case
    table is bucketed)."""
    import torch
    from fealess_tpu_torch.ops import lab, score
    n = 0
    for runs, served in ((coarse_cases["coarse_variant"] +
                          coarse_cases["coarse_stride2"],
                          score.coarse_scores),
                         (local_cases, score.local_scores)):
        for kernel, _, args in runs:
            if kernel is lab.coarse_variant and \
                    args[2] not in lab.EXACT_MODES:
                continue
            want = served(*args[:2 if served is score.coarse_scores
                                else 4])
            check(torch.equal(kernel(*args), want),
                  f"{kernel.__name__} {args[2:]} differs from "
                  f"{served.__name__}")
            n += 1
    print(f"kernel lab: {n} exact L1/L2/L3 runs bitwise equal to K1/K2 on "
          f"the same inputs")


def hold_topk(cases, where: str) -> None:
    """The coarse stage's exact top-k (``detector.exact_top_k_flat``) and
    the per-row form (``exact_top_k_rows`` at each row count) on each case
    (flat scores, k, row counts): bitwise equal on ``flat``'s device and on
    a CPU copy, and equal to numpy's stable argsort of the negated scores
    (value descending, flat index ascending: ``jax.lax.top_k``'s order)."""
    import numpy as np
    import torch
    from fealess_tpu_torch import detector
    for i, (flat, k, rows_list) in enumerate(cases):
        cpu = flat.cpu()
        ref = np.argsort(-cpu.numpy(), kind="stable")[:k]
        forms = [("flat", detector.exact_top_k_flat, ())] + [
            (f"rows={r}", detector.exact_top_k_rows, (r,))
            for r in rows_list]
        for name, form, extra in forms:
            s, idx = form(flat, k, *extra)
            s_cpu, idx_cpu = form(cpu, k, *extra)
            check(torch.equal(s.cpu(), s_cpu) and
                  torch.equal(idx.cpu(), idx_cpu),
                  f"top-k {name} ({where}) case {i}: differs from its CPU "
                  f"run")
            check(idx_cpu.tolist() == ref.tolist() and torch.equal(
                s_cpu, cpu[torch.from_numpy(ref)]),
                f"top-k {name} ({where}) case {i}: not in (value desc, "
                f"index asc) order")
        top = cpu[torch.from_numpy(ref)]
        print(f"top-k ({where}) case {i}: {flat.numel()} scores, k = {k}, "
              f"the flat form and rows {list(rows_list)} bitwise equal to "
              f"their CPU runs and to a stable argsort; "
              f"{int((cpu == top[-1]).sum())} scores tie the k-th")


def hold_front(q0, q1, where: str) -> None:
    """The front end's three rows (``kernel_lab.FRONT_BUILDS``) at both
    levels bitwise equal on the images' device and on CPU copies."""
    import torch
    from fealess_tpu_torch.apps import kernel_lab
    images = (q0, q1)
    for name, build in kernel_lab.FRONT_BUILDS.items():
        for i, t in kernel_lab.FRONT_LEVELS:
            got = build(images[i], t)
            want = build(images[i].cpu(), t)
            check(got.dtype == want.dtype and torch.equal(got.cpu(), want),
                  f"{name} ({where}) at T = {t}: differs from its CPU run")
    print(f"front end ({where}): {list(kernel_lab.FRONT_BUILDS)} at T = 5 "
          f"and 8 bitwise equal to their CPU runs")


def hold_local_lab(local, local3, errs, where: str) -> None:
    """K2 on the lab's ``local`` path (the table gather, then
    ``score.local_scores``) and ``local3`` path (both modalities through the
    front end and its strided-slices form, then K2) bitwise equal to K2's
    twin (``score.local_scores_plain``) on CPU copies of the inputs;
    ``errs["local_refine"]`` keeps the largest difference."""
    import torch
    from fealess_tpu_torch.apps import kernel_lab
    from fealess_tpu_torch.ops import lab, response, score

    def cpu(x):
        return ({k: v.cpu() for k, v in x.items()} if isinstance(x, dict)
                else x.cpu())

    planes, table, tslot, px0, py0 = local
    runs = [("local", score.local_scores(planes, lab.gather_rows(
        table, tslot), px0, py0), score.local_scores_plain(
            cpu(planes), lab.gather_rows(cpu(table), cpu(tslot)), cpu(px0),
            cpu(py0)))]
    img0, img1, table_k, px0, py0 = local3
    for name, build in (("local3", response.build_level_2d),
                        ("local3 slices", lab.build_level_2d_slices)):
        got_planes = kernel_lab.front_planes(img0, img1, build)
        want_planes = kernel_lab.front_planes(cpu(img0), cpu(img1), build)
        check(torch.equal(got_planes.cpu(), want_planes),
              f"{name} ({where}): the planes differ from their CPU run")
        runs.append((name, score.local_scores(got_planes, table_k, px0, py0),
                     score.local_scores_plain(want_planes, cpu(table_k),
                                              cpu(px0), cpu(py0))))
    errs.setdefault("local_refine", 0.0)
    for name, got, want in runs:
        err = (got.cpu() - want).abs().max().item()
        errs["local_refine"] = max(errs["local_refine"], float(err))
        check(got.dtype == torch.int32 and torch.equal(got.cpu(), want),
              f"K2 on the lab's {name} path ({where}) differs from its twin "
              f"(max |diff| {err})")
    print(f"kernel local_scores ({where}): the lab's local, local3 and "
          f"local3-slices paths bitwise equal to K2's twin on CPU copies")


STRIDE2_EVENTS = """
import json
from fealess_tpu_torch.apps import kernel_lab
from fealess_tpu_torch.ops import lab
from fealess_tpu_torch.utils.profiling import profile_calls
local = kernel_lab.local2_inputs("cuda")
lab.local_variant(*local, 2, False)
events = profile_calls(lambda: lab.local_variant(*local, 2, False),
                       1).device_events
print(json.dumps([e.name for e in events]))
"""


def stride2_call_events() -> list:
    """The device events of one profiled stride-2 L3 call on the lab's
    local2 inputs (``utils/profiling.profile_calls``), in a process of its
    own.  In a process whose last profiler session ended 30 s or more
    before (idle or busy in between), each later session loses the device
    records of its first 0-4 kernels, while a process's first session
    records every one (``apps/profile_check``); this process profiles in
    phase 8, long before."""
    out = subprocess.run([sys.executable, "-c", STRIDE2_EVENTS], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"the profiled stride-2 call failed: "
          f"{out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def lab_phase(card, errs, floor_ms, inputs):
    """Phase 9 on the lab's inputs (``inputs``: each subcommand of
    ``apps/kernel_lab.RUNS`` -> its inputs on the card): the lab's entry
    point (every run of ``apps/kernel_lab``) with the launch counters
    zeroed before and read after; each L kernel against its twin and the
    served kernels on the lab's inputs and edge cases; the top-k, front-end
    and K2 paths of the runs that add no kernel against their CPU runs; each
    kernel, its twin and L4's library call timed.  Returns (the kernels
    line's L1-L4 entries, each variant's times from the entry point under
    ``cases``; the rows that launched K2, for K2's entry; K2's launches on
    the lab's path).  ``floor_ms`` is the launch floor of phase 5."""
    import torch
    from fealess_tpu_torch.apps import kernel_lab
    from fealess_tpu_torch.ops import _build, bounds, lab, nn, score
    from fealess_tpu_torch.utils.profiling import graph_ms
    counted = lab.LAUNCHED + (score.coarse_scores, score.local_scores,
                              nn.nearest_neighbor)
    coarse, local, clouds = (inputs[k] for k in ("coarse", "local2", "nn"))
    # 9a. the lab's entry point
    for fn in counted:
        fn.launches = 0
    rows, k2_runs = [], {}
    for which, (_, run) in kernel_lab.RUNS.items():
        before = score.local_scores.launches
        rows += run(*inputs[which])
        k2_runs[which] = score.local_scores.launches - before
    launches = {fn.__name__: fn.launches for fn in counted}
    print(f"launches on path kernel lab: {launches}; K2 by run: {k2_runs}")
    for fn in lab.LAUNCHED:
        check(launches[fn.__name__] > 0,
              f"{fn.__name__} never launched on the kernel lab's path")
    for which in ("local", "local3"):
        check(k2_runs[which] > 0,
              f"local_scores never launched on the kernel lab's {which} run")
    hgmma = [row.get("hgmma") for row in rows if row["kernel"] == "nn_mxu"]
    check(all(h is None or h > 0 for h in hgmma),
          f"L4's kernel has no HGMMA in its SASS: {hgmma}")
    # 9b. the runs that add no kernel against their CPU runs
    hold_topk([inputs["topk"], kernel_lab.topk_tie_inputs(
        inputs["topk"][0].device)], "kernel lab")
    hold_front(*inputs["frontend"], "kernel lab")
    hold_local_lab(inputs["local"], inputs["local3"], errs, "kernel lab")
    # 9c. the L kernels against their twins and the served kernels
    coarse_cases = lab_coarse_cases(*coarse)
    local_cases = {"local_variant": lab_local_cases(*local)}
    hold_to_twins(coarse_cases, errs, "kernel lab")
    hold_to_twins(local_cases, errs, "kernel lab")
    hold_nn_mxu(lab_nn_cases(*clouds), errs, "kernel lab")
    hold_nn_operands(*clouds, "kernel lab")
    hold_to_served(coarse_cases, local_cases["local_variant"])
    # One stride-2 L3 call is one launch on the planes: no copy, no torch
    # op (the parent's call was 5 device events).
    names = stride2_call_events()
    check(len(names) == 1 and "lab_local_kernel" in names[0],
          f"a stride-2 local_variant call ran {len(names)} device events, "
          f"want 1, L3's kernel: {names}")
    print(f"kernel local_variant: one stride-2 call, 1 device event "
          f"({names[0]})")
    # 9d. times of each kernel's first case
    entry = {"coarse_variant": coarse_cases["coarse_variant"][0],
             "coarse_stride2": coarse_cases["coarse_stride2"][1],
             "local_variant": local_cases["local_variant"][0],
             "nn_mxu": (lab.nn_mxu, lab.nn_mxu_plain, clouds)}
    q, r = clouds
    library_ms = cuda_ms(lambda: torch.cdist(
        q, r, compute_mode="use_mm_for_euclid_dist").min(dim=1), 5)
    for tr in (2048, 4096, 8192):   # L4's reference chunk a block walks
        print(f"time nn_mxu tiles (256, {tr}): "
              f"{graph_ms(lambda: lab.nn_mxu(q, r, 256, tr), 20):.4f} ms "
              f"(graph) ({card})")
    out = []
    for name, (kernel, plain, args) in entry.items():
        ms = cuda_ms(lambda: kernel(*args), 20)
        gms = graph_ms(lambda: kernel(*args), 20)
        pms = cuda_ms(lambda: plain(*args), 3)
        bound, by = bounds.bound_ms(name, args)
        lib = library_ms if name == "nn_mxu" else None
        shapes = [tuple(a["c"].shape) if isinstance(a, dict)
                  else tuple(a.shape) if isinstance(a, torch.Tensor) else a
                  for a in args]
        print(f"time {name} {shapes}: kernel {ms:.4f} ms (events), "
              f"{gms:.4f} ms (graph), twin {pms:.4f} ms, bound "
              f"{bound:.6f} ms ({by}), {bound / gms:.3f} of it (graph)"
              + (f", torch.cdist + min {lib:.4f} ms" if lib else "")
              + f" ({card})")
        source, replaces, _ = _build.KERNELS[name]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": errs[name], "ms": ms, "graph_ms": gms,
                    "launch_floor_ms": floor_ms, "plain_ms": pms,
                    "bound_ms": bound, "bound_by": by, "library_ms": lib,
                    "cases": [{"case": row["variant"],
                               **{k: v for k, v in row.items()
                                  if k not in ("variant", "kernel")}}
                              for row in rows if row["kernel"] == name]})
    k2_rows = [{"case": row["variant"], **{k: v for k, v in row.items()
                                           if k not in ("variant", "kernel")}}
               for row in rows if row["kernel"] == "local_scores"]
    return out, k2_rows, launches["local_scores"]


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
    from fealess_tpu_torch.apps import fixture, kernel_lab
    from fealess_tpu_torch.utils.profiling import graph_ms
    from fealess_tpu_torch.engine import ObjReco
    from fealess_tpu_torch.io.export import ServingArtifact
    from fealess_tpu_torch.ops import _build, nn, score
    from fealess_tpu_torch.ops.bounds import bound_ms
    from fealess_tpu_torch.tracker.kcf import KcfTracker

    # -- 1. card and versions
    t_run = time.perf_counter()

    def phase_clock(phase: str) -> None:
        print(f"clock: {time.perf_counter() - t_run:.1f} s at the start of "
              f"phase {phase}")

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
        if ("registers" in line or "spill" in line
                or "Function properties" in line):
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
    cases, n_pairs = kernel_cases(eng, bgr_np, depth_np, cam)
    errs = {}
    hold_to_twins(cases, errs, "fixture bank")
    check(n_pairs == eng.cfg.icp.max_points, f"ICP pairs {n_pairs}")
    bgr, depth, scene_k = eng._prepare_frame(bgr_np, depth_np, cam)
    tables = eng._kernels

    # -- 4. end to end through the public API
    counted = (score.coarse_scores, score.local_refine, nn.nearest_neighbor)
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
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    pkg = training_and_cli(dev, bgr_np, depth_np, card, zero_counts,
                           read_counts, path_launches, errs, work.name)

    # -- 5. timing
    phase_clock("5")
    one = torch.zeros(1, device=dev)
    floor_ms = graph_ms(lambda: one.add_(1), 20)
    print(f"time launch floor: {floor_ms:.4f} ms (graph) a one-element "
          f"in-place add ({card})")
    times, graph, bounds = {}, {}, {}
    for name, runs in cases.items():
        kernel, plain, args = runs[0]
        times[name] = (cuda_ms(lambda: kernel(*args), 20),
                       cuda_ms(lambda: plain(*args), 3))
        graph[name] = graph_ms(lambda: kernel(*args), 20)
        bounds[name] = bound_ms(name, args)
        shapes = [tuple(a.shape) for a in args
                  if isinstance(a, torch.Tensor)]
        print(f"time {name}: kernel {times[name][0]:.4f} ms (events), "
              f"{graph[name]:.4f} ms (graph), twin {times[name][1]:.4f} ms, "
              f"bound {bounds[name][0]:.6f} ms ({bounds[name][1]}), "
              f"{bounds[name][0] / times[name][0]:.3f} / "
              f"{bounds[name][0] / graph[name]:.3f} of it, graph "
              f"{graph[name] / floor_ms:.2f}x the launch floor, inputs "
              f"{shapes} ({card})")
    kernel, _, args = cases["coarse_scores"][1]
    k1_ms = cuda_ms(lambda: kernel(*args), 20)
    k1_graph = graph_ms(lambda: kernel(*args), 20)
    k1_bound = bound_ms("coarse_scores", args)[0]
    print(f"time coarse_scores (distinct templates: random c, ry, rx at "
          f"{tuple(args[1]['c'].shape)}): kernel {k1_ms:.4f} ms (events), "
          f"{k1_graph:.4f} ms (graph), bound {k1_bound:.4f} ms, "
          f"{k1_bound / k1_ms:.3f} / {k1_bound / k1_graph:.3f} of it "
          f"({card})")
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
    # cold start at the fixture's 1024 templates: add_obj (YAML parse,
    # 1024 model depth PNGs, table build) against the artifact's load
    with tempfile.TemporaryDirectory() as tmp:
        eng.export_artifact(tmp)
        t0 = time.perf_counter()
        ObjReco.create("LmICP", device=dev).add_obj(
            os.path.join(fixture.FIXTURE, "features"))
        torch.cuda.synchronize()
        add_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ServingArtifact(tmp, dev)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
    print(f"time cold start ({eng.bank.num_templates} templates): add_obj "
          f"{add_ms:.3f} ms, ServingArtifact load {load_ms:.3f} ms ({card})")

    # -- 6. the parallel layer
    phase_clock("6")
    shard_timing = parallel_phase(eng, bgr_np, depth_np, cam, card,
                                  (zero_counts, read_counts, path_launches),
                                  errs)
    # -- 7. camera widths and frame input
    phase_clock("7")
    zoom_phase(eng, bgr_np, depth_np, cam, card,
               (zero_counts, read_counts, path_launches, counted),
               default_icp)
    phase_clock("7d")
    frame_input_phase(eng, bgr_np, depth_np, cam, card,
                      (zero_counts, read_counts, path_launches, counted),
                      default_icp)
    phase_clock("7e")
    persistence_phase(eng, bgr_np, depth_np, cam, card,
                      (zero_counts, read_counts, path_launches, counted),
                      default_icp)
    filestorage_phase(eng, bgr_np, depth_np, cam, card,
                      (zero_counts, read_counts, path_launches, counted),
                      default_icp)
    phase_clock("7f")
    video_phase(eng, card, (zero_counts, read_counts, path_launches, counted),
                default_icp)
    # -- 8. the rest of the public surface
    phase_clock("8")
    surface_phase(eng, bgr_np, depth_np, cam, card,
                  (zero_counts, read_counts, path_launches, counted),
                  default_icp, pkg)
    work.cleanup()
    # -- 9. the kernel lab
    phase_clock("9")
    lab_entries, lab_k2_rows, lab_k2_launches = lab_phase(
        card, errs, floor_ms, {which: make(dev) for which, (make, _)
                               in kernel_lab.RUNS.items()})
    phase_clock("the end")
    launches = {fn.__name__: sum(v[k] for v in path_launches.values())
                for k, fn in enumerate(counted)}
    print(f"peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    src = _build.KERNELS
    print(card)
    # library_ms: no one PyTorch call computes K1-K3.  K1 and K2 are
    # gathered, bounds-masked integer sums over feature tables; K3 returns
    # the first argmin with d2 rounded as above, and torch.cdist forms
    # |q|^2 + |r|^2 - 2 q.r, which rounds differently (L4's library call).
    # K2's entry also carries the kernel lab's K2 rows (local, local3) and
    # its launches there (``lab_launches``, not in ``launches``).
    lab_k2 = {"local_refine": {"lab_launches": lab_k2_launches}}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src[name][0],
         "replaces": src[name][1], "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "graph_ms": graph[name], "launch_floor_ms": floor_ms,
         "plain_ms": times[name][1], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": None,
         **lab_k2.get(name, {}),
         "cases": [shard_timing[name]] + (
             lab_k2_rows if name == "local_refine" else [])}
        for name in cases] + lab_entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def numpy_twin(fn):
    """``fn()`` with ``io.native``'s library set aside, so the training
    path runs its numpy extraction (the plain twin of libfealess_host)."""
    from fealess_tpu_torch.io import native
    saved = native._LIB, native._SEARCHED
    native._LIB, native._SEARCHED = None, True
    try:
        return fn()
    finally:
        native._LIB, native._SEARCHED = saved


def per_crop_front_end(bgr_c, dep_c, det, dev):
    """The training front-end as it ran before batching: one upload, the
    serving front-end (one (H, W[, 3]) image a call) crop by crop, one
    fetch; ``out[l][i]`` as ``training.quantize_crops`` returns it."""
    import numpy as np
    import torch
    from fealess_tpu_torch import training
    bgr_d = torch.from_numpy(np.ascontiguousarray(bgr_c)).to(dev)
    dep_d = torch.from_numpy(np.asarray(dep_c, np.int32)).to(dev)
    parts = [t for i in range(len(bgr_c))
             for lv in training._quantize_levels(bgr_d[i], dep_d[i], det)
             for t in lv]
    host = training._fetch(parts)
    per = 3 * det.pyramid_levels
    return [[tuple(host[i * per + 3 * l:i * per + 3 * l + 3])
             for i in range(len(bgr_c))] for l in range(det.pyramid_levels)]


def same_levels(got, want) -> bool:
    """Every level, crop and output equal bit for bit (magnitudes as
    bits)."""
    return all(
        len(g_l) == len(w_l) and all(
            a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes()
            for g, w in zip(g_l, w_l) for a, b in zip(g, w))
        for g_l, w_l in zip(got, want)) and len(got) == len(want)


def training_and_cli(dev, bgr_np, depth_np, card, zero_counts, read_counts,
                     path_launches, errs, work: str) -> str:
    """Phase 4d: training on the card, then the CLI's offline path; the
    scan package (trained, served by phase 8 too) lives in ``work``.
    Returns its path."""
    import hashlib

    import numpy as np
    import torch
    from fealess_tpu_torch import config as cfg
    from fealess_tpu_torch import training
    from fealess_tpu_torch.apps import cli, fixture, scan_package
    from fealess_tpu_torch.ops.bounds import bound_ms
    from fealess_tpu_torch.ops import _build
    from fealess_tpu_torch.utils.profiling import graph_ms, profile_calls
    from fealess_tpu_torch.io import linemod_yaml
    from fealess_tpu_torch.io.export import ServingArtifact

    # the native extraction the port builds from native/fealess_host's
    # scatter.cc, chamfer.cc and extract.cc (no CMake, no OpenCV)
    cached = any(_build.BUILD_DIR.glob("libfealess_host_*.so"))
    t0 = time.perf_counter()
    so = _build.build_native_host()
    build_s = time.perf_counter() - t0
    check(training.have_native(), "training.have_native() is false")
    print(f"native: {os.path.relpath(so, REPO)} "
          f"{'found built' if cached else 'built'} in {build_s:.3f} s "
          f"(c++), loaded; training.have_native() true")

    # the fixture's training view (benchmarks/reference/make_fixture.py)
    det = cfg.DetectorConfig()
    mask = np.zeros(depth_np.shape, bool)
    mask[160:320, 240:432] = True
    pose = np.zeros(13, np.float32)
    pose[0] = pose[5] = pose[10] = 1.0
    pose[12] = 800.0
    _, classes = linemod_yaml.load_linemod(os.path.join(
        fixture.FIXTURE, "features", "linemod_templates.yml"))
    golden = classes["obj"][0]
    host_path = "native" if training.have_native() else "numpy"
    check(host_path == "native", f"host extraction path {host_path}")
    for name, view in (
            ("add_template", training.add_template(
                bgr_np, depth_np, mask, pose, det, dev)),
            ("add_templates_batched", training.add_templates_batched(
                [bgr_np], [depth_np], [mask], [pose], det, dev)[0]),
            ("add_template (numpy twin)", numpy_twin(
                lambda: training.add_template(bgr_np, depth_np, mask, pose,
                                              det, dev)))):
        check(same_view(view, golden),
              f"{name} on the card differs from YAML template 0")
    print(f"train: the fixture view through add_template and "
          f"add_templates_batched on {dev} equals YAML template 0 "
          f"({[len(f) for fl in golden.features for f in fl]} features); "
          f"host extraction path {host_path}, and the numpy twin's view "
          f"equals it")

    tmp = work
    pkg = os.path.join(tmp, "pkg")
    art = os.path.join(tmp, "artifact")
    fixture.write_scan_package(pkg, bgr_np, depth_np, TRAIN_FRAMES)
    rc, out = run_cli(["train", pkg, "--device", "cuda"])
    check(rc == 0 and out[-1].startswith(
        f"Training: {TRAIN_FRAMES}/{TRAIN_FRAMES} frames"),
        f"cli train: rc {rc}, {out[-1:]}")
    with open(os.path.join(pkg, "linemod_templates.yml"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    check(digest == EXPECT_TRAIN_SHA256,
          f"cli train: database sha256 {digest}, JAX's "
          f"{EXPECT_TRAIN_SHA256}")
    print(f"cli train: {out[-1].split(' -> ')[0]}, database sha256 "
          f"equal to the JAX package's")

    rc, out = run_cli(["export", pkg, art, "--device", "cuda"])
    check(rc == 0, f"cli export: rc {rc}")
    lines = {}
    for path, extra in (("cli recon", []),
                        ("cli recon --artifact", ["--artifact", art])):
        zero_counts()
        rc, out = run_cli(["recon", pkg, "--device", "cuda"] + extra)
        read_counts(path)
        grew = path_launches[path]
        check(rc == 0, f"{path}: rc {rc}")
        check(grew[0] == grew[1] == TRAIN_FRAMES,
              f"{path}: K1/K2 launched {grew[:2]}, expected one each "
              f"per frame")
        lines[path] = [json.loads(ln) for ln in out]
        check(len(lines[path]) == TRAIN_FRAMES, f"{path}: {out}")
        for rec, (sim, t, dist) in zip(lines[path], EXPECT_CLI):
            check(len(rec["results"]) == 1, f"{path}: {rec}")
            r = rec["results"][0]
            p = np.asarray(r["pose"])
            check(r["obj"] == "obj" and r["similarity"] == sim
                  and p.shape == (4, 4) and bool(np.isfinite(p).all())
                  and close(p[:3, 3], t, CLI_T_TOL_MM)
                  and rotation_deg(p[:3, :3]) <= ROT_TOL_DEG
                  and abs(r["icp_dist"] - dist) <= CLI_DIST_TOL,
                  f"{path} frame {rec['frame']}: {r} vs JAX's "
                  f"{(sim, t, dist)}")
        print(f"{path}: {len(lines[path])} frames equal the JAX CLI's "
              f"(t " + ", ".join(
                  str([round(float(v), 4) for v in np.asarray(
                      rec["results"][0]["pose"])[:3, 3]])
                  for rec in lines[path]) + ")")
    check(lines["cli recon --artifact"] == lines["cli recon"],
          "recon --artifact lines differ from recon's")
    print("cli recon --artifact: lines equal recon's")

    # one forced-ICP recognition of the served bank, so K3 runs; first
    # each kernel against its twin at the shapes this bank gives it
    served = ServingArtifact(art, dev)
    for name, value in FORCED.items():
        served.set_advanced_param(name, value)
    frame0 = next(scan_package.iter_training_frames(pkg))
    cam = cli._camera(cli.build_parser().parse_args(["recon", pkg]),
                      frame0.bgr.shape[1], frame0.bgr.shape[0])
    served_cases, n_pairs = kernel_cases(served, frame0.bgr,
                                         frame0.depth_mm, cam)
    hold_to_twins(served_cases, errs,
                  f"served {served.bank.num_templates}-template bank")
    check(n_pairs == served.cfg.icp.max_points,
          f"served ICP pairs {n_pairs}")
    kernel, _, args = served_cases["coarse_scores"][0]
    print(f"time coarse_scores (served {served.bank.capacity}-slot "
          f"bank): kernel {cuda_ms(lambda: kernel(*args), 20):.4f} ms "
          f"(events), {graph_ms(lambda: kernel(*args), 20):.4f} ms "
          f"(graph), bound {bound_ms('coarse_scores', args)[0]:.4f} ms "
          f"({card})")
    zero_counts()
    res = served.recognition(frame0.bgr, frame0.depth_mm, cam)
    read_counts("served forced ICP")
    grew = path_launches["served forced ICP"]
    check(len(res) == 1 and tuple(res[0].match_rect[:2]) == EXPECT_MATCH
          and close(res[0].world2cam[:3, 3], EXPECT_T["b"],
                    T_TOL_MM["b"])
          and abs(rotation_deg(res[0].world2cam[:3, :3])
                  - EXPECT_ROT_DEG["b"]) <= ROT_TOL_DEG,
          f"served forced ICP: {res}")
    check(grew == [1, 1, EXPECT_NN["b"]],
          f"served forced ICP: launches {grew}")
    print(f"served forced ICP: match {res[0].match_rect[:2]} t "
          f"{[round(float(v), 4) for v in res[0].world2cam[:3, 3]]} "
          f"rotation {rotation_deg(res[0].world2cam[:3, :3]):.4f} deg")

    # timing: the stages of add_templates_batched (host crop, device
    # front-end, host extraction threads) timed in turn on one chunk:
    # the package's 4 frames, and a chunk of CHUNK panned frames as
    # train_package feeds it, whose first 4 views must equal the first
    # chunk's.  On each chunk the batched front-end is held bit for bit
    # to the per-crop loop it replaced, and both are profiled (device
    # events and busy per chunk); on the CHUNK-view chunk the native
    # views are held to the numpy twin's.  Then add_obj vs artifact load
    frames = list(scan_package.iter_training_frames(pkg))
    chunks = {TRAIN_FRAMES: [(f.bgr, f.depth_mm, f.mask, f.pose13)
                             for f in frames],
              scan_package.CHUNK: [
                  (b, d, d < d[0, 0], frames[0].pose13)
                  for b, d in fixture.pan(bgr_np, depth_np,
                                          scan_package.CHUNK)]}
    workers = training.default_workers()
    trained = {}
    for n, chunk in chunks.items():
        bgrs, depths, masks, poses = (list(c) for c in zip(*chunk))
        stages = np.zeros((TRAIN_TIMED, 3))
        for k in range(TRAIN_TIMED):
            t0 = time.perf_counter()
            rects, bgr_c, dep_c, msk_c = training.crop_views(
                bgrs, depths, masks, det.pyramid_levels)
            t1 = time.perf_counter()
            qlevels = training.quantize_crops(bgr_c, dep_c, det, dev)
            t2 = time.perf_counter()
            trained[n] = training.extract_views(qlevels, rects, msk_c,
                                                poses, det, workers)
            stages[k] = (t1 - t0, t2 - t1, time.perf_counter() - t2)
            check(all(v is not None for v in trained[n]),
                  f"batched training of {n} views")
        crop_ms, front_ms, extract_ms = stages.mean(0) * 1e3
        t_ms = crop_ms + front_ms + extract_ms
        print(f"time add_templates_batched ({n} views, crops "
              f"{bgr_c.shape[1]}x{bgr_c.shape[2]}, {host_path} "
              f"extraction on {workers} threads): {t_ms:.3f} ms, "
              f"{n / t_ms * 1e3:.3f} templates/s (C++ reference "
              f"{CPP_TEMPLATES_PER_S}); crop {crop_ms:.3f} ms, front-end "
              f"{front_ms:.3f} ms, extraction {extract_ms:.3f} ms; mean of "
              f"{TRAIN_TIMED} ({card})")
        check(same_levels(qlevels, per_crop_front_end(bgr_c, dep_c, det,
                                                      dev)),
              f"batched front-end of {n} crops differs from the per-crop "
              f"loop")
        prof = {name: profile_calls(fn, 1) for name, fn in (
            ("per-crop loop", lambda: per_crop_front_end(bgr_c, dep_c, det,
                                                         dev)),
            ("batched", lambda: training.quantize_crops(bgr_c, dep_c, det,
                                                        dev)))}
        print(f"front-end ({n} crops): batched bitwise equal to the "
              f"per-crop loop at {det.pyramid_levels} levels; device "
              f"events a chunk " + ", ".join(
                  f"{name} {len(p.device_events)} (busy {p.busy_ms:.3f} "
                  f"ms, wall {p.wall_ms:.3f} ms)"
                  for name, p in prof.items()) + f" ({card})")
        if n == scan_package.CHUNK:
            t0 = time.perf_counter()
            twin = numpy_twin(lambda: training.extract_views(
                qlevels, rects, msk_c, poses, det, workers))
            twin_ms = (time.perf_counter() - t0) * 1e3
            check(len(twin) == n and all(
                same_view(a, b) for a, b in zip(trained[n], twin)),
                f"native views of the {n}-view chunk differ from the numpy "
                f"twin's")
            print(f"train: the {n}-view chunk's native views equal the "
                  f"numpy twin's (every feature); twin extraction "
                  f"{twin_ms:.3f} ms on {workers} threads ({card})")
    check(all(same_view(a, b) for a, b in zip(
        trained[scan_package.CHUNK], trained[TRAIN_FRAMES])),
        f"the {scan_package.CHUNK}-view chunk's first views differ from "
        f"the {TRAIN_FRAMES}-view chunk's")
    recon_args = cli.build_parser().parse_args(["recon", pkg, "--device",
                                                "cuda"])
    h, w = frames[0].depth_mm.shape
    load = {"add_obj": [], "artifact": []}
    for _ in range(TRAIN_TIMED):
        t0 = time.perf_counter()
        cli._engine_for(recon_args, w, h)
        torch.cuda.synchronize()
        load["add_obj"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        ServingArtifact(art, dev)
        torch.cuda.synchronize()
        load["artifact"].append(time.perf_counter() - t0)
    print(f"time cold start ({TRAIN_FRAMES} templates): add_obj "
          f"{np.mean(load['add_obj']) * 1e3:.3f} ms, ServingArtifact "
          f"load {np.mean(load['artifact']) * 1e3:.3f} ms; mean of "
          f"{TRAIN_TIMED} ({card})")
    return pkg


if __name__ == "__main__":
    main()
