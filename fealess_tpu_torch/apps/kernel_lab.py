"""The kernel lab on the card: each variant of the lab's scorers and nearest
neighbour (``ops/lab.py``, kernels L1-L4) timed beside the served kernel it
varies (K1, K2 or K3) on the same inputs, and the served path's other
questions (the exact top-K's form, the front end's working type, the table
gather before K2, K2 behind the real front end), in one process: the
counterpart of ``benchmarks/kernel_lab.py``'s seven subcommands.

Usage (from the repository root, on a machine with a CUDA card):

    python -m fealess_tpu_torch.apps.kernel_lab \
        coarse|local2|nn|topk|frontend|local|local3 [--device cuda]

- ``coarse``: the lab's coarse inputs (``fixture_like(even=True,
  valid_frac=0.5)``: 1024 templates of 126 feature slots, ~26 live in 13
  rx buckets, planes (1024, 30, 40)); L1 in each mode of ``lab.MODES``
  and L2 with and without the empty-bucket skip, against K1
  (``ops.score.coarse_scores``);
- ``local2``: K2's operating point (planes (400, 96, 128), 39 buckets, 64
  candidates at origins in [0, Wd - 16) x [0, Hd - 16)); L3 at stride 1
  and 2, with and without the skip, against K2 (``ops.score.local_scores``);
- ``nn``: 16384 x 16384 normal(0, 100) points; L4 against K3
  (``ops.nn.nearest_neighbor``), and the count of ``HGMMA`` (``wgmma``)
  instructions in L4's kernel (``cuobjdump -sass`` of the built library,
  where the tool is present);
- ``topk``: the exact top-64 of 1024 x 30 x 40 = 1,228,800 scores, 2%
  live (normal + 100, the rest -inf): ``topk/flat-1.2M`` is the coarse
  stage's served form (``detector.exact_top_k_flat``, one stable sort),
  ``topk/2level-r1024`` and ``topk/2level-r30720`` the per-row form
  (``detector.exact_top_k_rows``) with 1024 and 30720 rows; all three
  asserted equal, scores and indices;
- ``frontend``: one modality's front end at both levels (480 x 640 at T =
  5, 240 x 320 at T = 8) on random bytes: ``front/current-u8`` is the
  served ``ops.response.build_level_2d`` (its working type is int32; the
  JAX lab's row name), ``front/i32`` and ``front/u8copy``
  ``lab.build_level_2d_dtype`` at int32 and uint8; all three asserted
  equal;
- ``local``: K2 at its operating point on a table of 7 buckets, all
  slots live: ``local/gather-fancy`` gathers the 64 candidates' table rows
  (``lab.gather_rows``) and runs K2 (``score.local_scores``),
  ``local/kernel-only`` runs K2 on rows gathered beforehand; asserted
  equal;
- ``local3``: K2 behind the real front end: ``local3/front+kernel`` builds
  both modalities' level-0 planes of two 480 x 640 images
  (``build_level_2d`` at T = 5, concatenated and cast to u8 as
  ``detector.response_planes`` does) and runs K2 on them,
  ``local3/front-slices+kernel`` the same with the decimation as strided
  slices (``lab.build_level_2d_slices``; asserted equal),
  ``local3/front-only`` the planes alone.

Left out, by the JAX lab's row name: ``local/gather-onehot`` and
``local3/front-MXU+kernel`` (a one-hot matrix-unit gather and a
selection-matmul decimation: TPU workarounds for XLA's scalar gathers and
relayouts); ``local3/front+BARRIER+kernel`` and
``local3/front+COPY+kernel`` (controls of XLA's fusion across an
``optimization_barrier``, which eager PyTorch has no counterpart of); and
``local3/front+pack`` (the Pallas scorers' nibble packing, a TPU
workaround; the JAX row is also stale: it calls ``_stacked_planes(planes,
hpad)`` without the ``lanes`` argument that function takes).

Each row prints its milliseconds a call from a CUDA graph of :data:`REPS`
launches (``utils.profiling.graph_ms``, the stand-in for the lab's chain
slope).  A variant of an L kernel also prints the served kernel's time on
the same inputs and the variant's bound (``ops/bounds.bound_ms``); L2 and
L4 also print the kernel alone, without the wrapper's plane stack and
bucket starts (L2) or operands (L4); L3's call is one launch at either
stride, so it prints one time a setting.  The rows that launch K2 (every
row of ``local`` and ``local3`` but ``local3/front-only``) print K2's
bound on their planes and rows.  It asserts what the lab asserts (base == skipempty == unroll2 ==
both stride-2 settings; the four L3 settings equal; L4 against K3 by the
near-tie rule, with the number of equal indices printed, and its d2 within
the rounding of the matrix form, ``ops/lab.near_tie``; the rows of
``topk``, ``frontend``, ``local`` and ``local3`` each equal) and also that each exact variant equals the served
kernel.  ``--device cpu`` runs the plain twins and the same functions on
CPU tensors, without timings.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess

import numpy as np
import torch

from fealess_tpu_torch import detector
from fealess_tpu_torch.ops import _build, lab, nn, response, score
from fealess_tpu_torch.ops.bounds import bound_ms
from fealess_tpu_torch.utils.profiling import graph_ms

REPS = 20   # launches in each timed CUDA graph


def coarse_inputs(device="cuda"):
    """``lab_coarse``'s inputs: even bucket counts and ~50% validity."""
    return lab.fixture_like(even=True, valid_frac=0.5, device=device)


def _candidates(rng, device):
    """The lab's 64 refinement candidates at K2's operating point (Hd, Wd
    = 96, 128), drawn from ``rng`` in the lab's order: (slots (int64),
    px0, py0 in [0, Wd - 16) x [0, Hd - 16), int32), on ``device``."""
    tslot = rng.integers(0, 1024, (64,))
    px0 = rng.integers(0, 128 - 16, (64,)).astype(np.int32)
    py0 = rng.integers(0, 96 - 16, (64,)).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (tslot, px0, py0))


def local2_inputs(device="cuda"):
    """``lab_local2``'s inputs: (planes, the 64 candidates' table rows,
    px0, py0), drawn as the lab draws them."""
    rng = np.random.default_rng(1)
    planes, table = lab.fixture_like(seed=1, n=1024, f=126, nb=39, hd=96,
                                     wd=128, c=400, valid_frac=0.5,
                                     device=device)
    tslot, px0, py0 = _candidates(rng, device)
    return planes, lab.gather_rows(table, tslot), px0, py0


def nn_inputs(device="cuda", n=16384):
    """``lab_nn``'s inputs: two (n, 3) float32 normal(0, 100) clouds."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(n, 3)).astype(np.float32) * 100
    r = rng.normal(size=(n, 3)).astype(np.float32) * 100
    return torch.from_numpy(q).to(device), torch.from_numpy(r).to(device)


def _row(rows, variant, kernel, args, fn, served=None, alone=None):
    """Time ``fn`` (and ``alone``, the kernel without the wrapper's
    preparation) from a CUDA graph where ``args[0]`` lies on a card,
    append the row and print it, with ``served`` (the served kernel's
    time on the same inputs) where given and the bound of ``kernel`` (a
    kernel of ``ops/bounds.bound_ms``) on ``args`` where given; on the CPU
    print the variant only (a twin run where ``kernel`` is given)."""
    row = {"variant": variant, "kernel": kernel}
    if args[0].is_cuda:
        row["graph_ms"] = graph_ms(fn, REPS)
        text = f"{variant:26s} {row['graph_ms']:8.4f} ms (graph)"
        if alone is not None:
            row["alone_graph_ms"] = graph_ms(alone, REPS)
            text += f", kernel alone {row['alone_graph_ms']:.4f} ms"
        if served is not None:
            row["served_graph_ms"] = served
            text += f"; served {served:.4f} ms"
        if kernel is not None:
            row["bound_ms"], row["bound_by"] = bound_ms(kernel, args)
            text += f"; bound {row['bound_ms']:.6f} ms ({row['bound_by']})"
        print(text, flush=True)
    elif kernel is not None:
        print(f"{variant:26s} twin run (no timings on the CPU)", flush=True)
    else:
        print(f"{variant:26s} run on the CPU (no timings)", flush=True)
    rows.append(row)


def _served_ms(fn, inputs: torch.Tensor):
    return graph_ms(fn, REPS) if inputs.is_cuda else None


def run_coarse(planes, table) -> list:
    """L1 in every mode and L2 in both settings against K1 on one table
    (bucketed, even starts); asserts the exact ones equal to one another
    and to K1.  Returns the rows (times where the inputs lie on a card)."""
    k1 = score.coarse_scores(planes, table)
    k1_ms = _served_ms(lambda: score.coarse_scores(planes, table), planes)
    nf_total = int(table["bstart"][:, -1].sum())
    print(f"coarse: planes {tuple(planes.shape)}, table "
          f"{tuple(table['c'].shape)}, {nf_total} live features "
          f"(K1 on the same inputs)", flush=True)
    rows, ref = [], None
    for mode in lab.MODES:
        out = lab.coarse_variant(planes, table, mode)
        if mode in lab.EXACT_MODES:
            if ref is None:
                ref = out
            assert torch.equal(out, ref), mode
            assert torch.equal(out, k1), f"{mode} differs from K1"
        _row(rows, f"coarse/{mode}", "coarse_variant", (planes, table, mode),
             lambda m=mode: lab.coarse_variant(planes, table, m), k1_ms)
    prepared = lab.stride2_inputs(planes, table)
    for skip in (False, True):
        out = lab.coarse_stride2(planes, table, skip)
        assert torch.equal(out, ref), f"stride2 skipempty={skip}"
        _row(rows, f"coarse/stride2-se{int(skip)}", "coarse_stride2",
             (planes, table, skip),
             lambda s=skip: lab.coarse_stride2(planes, table, s), k1_ms,
             alone=lambda s=skip: lab.coarse_stride2(planes, table, s,
                                                     prepared))
    return rows


def run_local2(planes, table_k, px0, py0) -> list:
    """L3 in its four settings against K2 at the given origins; asserts
    them equal to one another and to K2."""
    k2 = score.local_scores(planes, table_k, px0, py0)
    k2_ms = _served_ms(lambda: score.local_scores(planes, table_k, px0, py0),
                       planes)
    print(f"local2: planes {tuple(planes.shape)}, "
          f"{table_k['c'].shape[0]} candidates x {table_k['c'].shape[1]} "
          f"features, {table_k['bstart'].shape[1] - 1} buckets (K2 on the "
          f"same inputs)", flush=True)
    rows = []
    for stride, cond in ((1, False), (1, True), (2, False), (2, True)):
        out = lab.local_variant(planes, table_k, px0, py0, stride, cond)
        assert torch.equal(out, k2), f"local2 s{stride} cond{int(cond)}"
        _row(rows, f"local2/s{stride}-cond{int(cond)}", "local_variant",
             (planes, table_k, px0, py0, stride, cond),
             lambda s=stride, c=cond: lab.local_variant(
                 planes, table_k, px0, py0, s, c), k2_ms)
    return rows


def sass_count(kernel: str, opcode: str):
    """Instructions named ``opcode`` in ``kernel``'s SASS in the built
    kernel library (``cuobjdump -sass``), or None without cuobjdump."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        tool = shutil.which("cuobjdump")
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(_build.build())],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    count, inside = 0, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside and opcode in line:
            count += 1
    return count


def run_nn(query, ref) -> list:
    """L4 against K3; asserts ``lab.near_tie`` (the near-tie rule and the
    d2 limit) in every row and prints the equal indices, the largest
    relative d2 gap and the largest share of the d2 limit."""
    k3 = nn.nearest_neighbor(query, ref)
    k3_ms = _served_ms(lambda: nn.nearest_neighbor(query, ref), query)
    print(f"nn: {query.shape[0]} x {ref.shape[0]} (K3 on the same inputs)",
          flush=True)
    idx, d2 = lab.nn_mxu(query, ref)
    ok, same, worst, share = lab.near_tie(idx, d2, *k3, query, ref)
    print(f"nn/mxu idx_equal={same}/{idx.numel()} all_ok={ok} "
          f"max_rel={worst:.2e} max_d2_share={share:.2e}", flush=True)
    assert ok, "nn_mxu breaks the near-tie rule or the d2 limit against K3"
    rows = []
    prepared = lab.nn_operands(query, ref) if query.is_cuda else None
    _row(rows, "nn/mxu-dot", "nn_mxu", (query, ref),
         lambda: lab.nn_mxu(query, ref), k3_ms,
         alone=lambda: lab.nn_mxu(query, ref, prepared=prepared))
    rows[-1].update(idx_equal=same, max_rel=worst, max_d2_share=share)
    if query.is_cuda:
        hgmma = sass_count("lab_nn_mma_kernel", "HGMMA")
        print("nn/mxu SASS: " + ("cuobjdump not found" if hgmma is None else
                                 f"{hgmma} HGMMA in lab_nn_mma_kernel"),
              flush=True)
        rows[-1]["hgmma"] = hgmma
    return rows


def topk_inputs(device="cuda", n=1024, hd=30, wd=40):
    """``lab_topk``'s inputs: (n * hd * wd float32 scores, normal + 100
    where a 2% draw is live and -inf elsewhere; k = 64; the row counts n
    and n * hd)."""
    rng = np.random.default_rng(0)
    flat = rng.normal(size=(n * hd * wd,)).astype(np.float32)
    live = rng.random(n * hd * wd) < 0.02
    flat = np.where(live, flat + np.float32(100), np.float32(-np.inf))
    return torch.from_numpy(flat).to(device), 64, (n, n * hd)


def topk_tie_inputs(device="cuda", n=1024, hd=30, wd=40):
    """A tie-heavy top-k input of ``topk_inputs``' shape: integer scores
    0..3 where a 2% draw is live, -inf elsewhere, so the top 64 are one
    tie that only the (value desc, flat index asc) order decides."""
    rng = np.random.default_rng(4)
    vals = rng.integers(0, 4, n * hd * wd).astype(np.float32)
    live = rng.random(n * hd * wd) < 0.02
    flat = np.where(live, vals, np.float32(-np.inf))
    return torch.from_numpy(flat).to(device), 64, (n, n * hd)


def frontend_inputs(device="cuda"):
    """``lab_frontend``'s inputs: random quantized bytes at the two levels'
    sizes, (480, 640) and (240, 320) u8."""
    rng = np.random.default_rng(0)
    q0 = rng.integers(0, 256, (480, 640), np.uint8)
    q1 = rng.integers(0, 256, (240, 320), np.uint8)
    return torch.from_numpy(q0).to(device), torch.from_numpy(q1).to(device)


def local_inputs(device="cuda"):
    """``lab_local``'s inputs: (planes (400, 96, 128), the 1024-row table of
    7 buckets with every slot live, the 64 candidates' slots (int64), px0,
    py0), drawn as the lab draws them."""
    rng = np.random.default_rng(1)
    planes, table = lab.fixture_like(seed=1, n=1024, f=126, nb=7, hd=96,
                                     wd=128, c=400, device=device)
    return (planes, table) + _candidates(rng, device)


def local3_inputs(device="cuda"):
    """``lab_local3``'s inputs: (two (480, 640) u8 images, the 64 candidates'
    table rows of ``local2``'s table, px0, py0): the images drawn before
    the table, the slots and origins after it, as the lab draws them."""
    rng = np.random.default_rng(1)
    images = [torch.from_numpy(rng.integers(0, 256, (480, 640), np.uint8))
              .to(device) for _ in range(2)]
    _, table = lab.fixture_like(seed=1, n=1024, f=126, nb=39, hd=96, wd=128,
                                c=400, valid_frac=0.5, device=device)
    tslot, px0, py0 = _candidates(rng, device)
    return (*images, lab.gather_rows(table, tslot), px0, py0)


def run_topk(flat, k, rows_list) -> list:
    """The served flat top-k against the per-row form at each row count;
    asserts scores and indices equal."""
    print(f"topk: {flat.numel()} scores, {int(torch.isfinite(flat).sum())} "
          f"live, k = {k}", flush=True)
    s0, i0 = detector.exact_top_k_flat(flat, k)
    rows = []
    _row(rows, "topk/flat-1.2M", None, (flat,),
         lambda: detector.exact_top_k_flat(flat, k))
    for r in rows_list:
        s1, i1 = detector.exact_top_k_rows(flat, k, r)
        assert torch.equal(s1, s0), f"scores differ at rows={r}"
        assert torch.equal(i1, i0), f"indices differ at rows={r}"
        _row(rows, f"topk/2level-r{r}", None, (flat,),
             lambda r=r: detector.exact_top_k_rows(flat, k, r))
    return rows


FRONT_LEVELS = ((0, 5), (1, 8))   # (image, T): level 0 and level 1
# frontend's rows: the served build and the lab's working types
FRONT_BUILDS = {"front/current-u8": response.build_level_2d,
                "front/i32": lambda q, t: lab.build_level_2d_dtype(
                    q, t, torch.int32),
                "front/u8copy": lambda q, t: lab.build_level_2d_dtype(
                    q, t, torch.uint8)}


def run_frontend(q0, q1) -> list:
    """One modality's planes at both levels: the served ``build_level_2d``
    and ``lab.build_level_2d_dtype`` at int32 and uint8; asserts the three
    equal."""
    print(f"frontend: {tuple(q0.shape)} at T = 5 and {tuple(q1.shape)} at "
          f"T = 8, one modality", flush=True)
    images = (q0, q1)
    want = [response.build_level_2d(images[i], t) for i, t in FRONT_LEVELS]
    rows = []
    for name, build in FRONT_BUILDS.items():
        for (i, t), ref in zip(FRONT_LEVELS, want):
            got = build(images[i], t)
            assert got.shape == ref.shape and torch.equal(
                got.to(torch.int32), ref), f"{name} differs at T = {t}"
        _row(rows, name, None, images, lambda b=build: [
            b(images[i], t) for i, t in FRONT_LEVELS])
    return rows


def run_local(planes, table, tslot, px0, py0) -> list:
    """K2 behind the candidates' table gather, and K2 on rows gathered
    beforehand; asserts the two equal."""
    table_k = lab.gather_rows(table, tslot)
    print(f"local: planes {tuple(planes.shape)}, {tslot.numel()} candidates "
          f"of {table['c'].shape[0]} rows x {table['c'].shape[1]} features, "
          f"{table['bstart'].shape[1] - 1} buckets", flush=True)
    assert torch.equal(score.local_scores(planes, lab.gather_rows(
        table, tslot), px0, py0), score.local_scores(planes, table_k, px0,
                                                     py0))
    rows = []
    k2_args = (planes, table_k, px0, py0)
    _row(rows, "local/gather-fancy", "local_scores", k2_args,
         lambda: score.local_scores(planes, lab.gather_rows(table, tslot),
                                    px0, py0))
    _row(rows, "local/kernel-only", "local_scores", k2_args,
         lambda: score.local_scores(planes, table_k, px0, py0))
    return rows


def front_planes(img0, img1, build=response.build_level_2d):
    """Both modalities' level-0 planes (T = 5) concatenated and cast to u8,
    as ``detector.response_planes`` builds them."""
    return torch.cat([build(img0, 5), build(img1, 5)]).to(torch.uint8)


def run_local3(img0, img1, table_k, px0, py0) -> list:
    """K2 behind the real front end (and behind its strided-slices form),
    and the front end alone; asserts the two K2 results equal."""
    planes = front_planes(img0, img1)
    print(f"local3: two {tuple(img0.shape)} images -> planes "
          f"{tuple(planes.shape)}, {table_k['c'].shape[0]} candidates x "
          f"{table_k['c'].shape[1]} features, "
          f"{table_k['bstart'].shape[1] - 1} buckets", flush=True)
    slices = front_planes(img0, img1, lab.build_level_2d_slices)
    assert torch.equal(score.local_scores(planes, table_k, px0, py0),
                       score.local_scores(slices, table_k, px0, py0))
    rows = []
    k2_args = (planes, table_k, px0, py0)
    _row(rows, "local3/front+kernel", "local_scores", k2_args,
         lambda: score.local_scores(front_planes(img0, img1), table_k, px0,
                                    py0))
    _row(rows, "local3/front-slices+kernel", "local_scores", k2_args,
         lambda: score.local_scores(front_planes(
             img0, img1, lab.build_level_2d_slices), table_k, px0, py0))
    _row(rows, "local3/front-only", None, (img0,),
         lambda: front_planes(img0, img1))
    return rows


# subcommand -> (its inputs on a device, its run on them)
RUNS = {"coarse": (coarse_inputs, run_coarse),
        "local2": (local2_inputs, run_local2),
        "nn": (nn_inputs, run_nn),
        "topk": (topk_inputs, run_topk),
        "frontend": (frontend_inputs, run_frontend),
        "local": (local_inputs, run_local),
        "local3": (local3_inputs, run_local3)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", choices=sorted(RUNS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        import subprocess
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(f"card: {card or torch.cuda.get_device_name(dev)}", flush=True)
    inputs, run = RUNS[args.which]
    run(*inputs(dev))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
