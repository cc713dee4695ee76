"""The kernel lab on the card: each variant of the lab's scorers and nearest
neighbour (``ops/lab.py``, kernels L1-L4) timed beside the served kernel it
varies (K1, K2 or K3) on the same inputs, in one process (counterpart of
``benchmarks/kernel_lab.py``'s ``coarse``, ``local2`` and ``nn``).

Usage (from the repository root, on a machine with a CUDA card):

    python -m fealess_tpu_torch.apps.kernel_lab coarse|local2|nn
        [--device cuda]

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
  where the tool is present).

Each variant prints one line: its milliseconds a call from a CUDA graph of
:data:`REPS` launches (``utils.profiling.graph_ms``, the stand-in for
the lab's chain slope), the served kernel's on the same inputs, and the
variant's bound (``ops/bounds.bound_ms``).  L2 and L4 also print the
kernel alone, without the wrapper's plane stack and bucket starts (L2)
or operands (L4); L3's call is one launch at either stride, so it
prints one time a setting.  It asserts what the lab asserts (base == skipempty == unroll2
== both stride-2 settings; the four L3 settings equal; L4 against K3 by
the near-tie rule, with the number of equal indices printed, and its d2
within the rounding of the matrix form, ``ops/lab.near_tie``) and also
that each exact variant equals the served kernel.  ``--device cpu`` runs
the plain twins, without timings.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess

import numpy as np
import torch

from fealess_tpu_torch.ops import _build, lab, nn, score
from fealess_tpu_torch.ops.bounds import bound_ms
from fealess_tpu_torch.utils.profiling import graph_ms

REPS = 20   # launches in each timed CUDA graph


def coarse_inputs(device="cuda"):
    """``lab_coarse``'s inputs: even bucket counts and ~50% validity."""
    return lab.fixture_like(even=True, valid_frac=0.5, device=device)


def local2_inputs(device="cuda"):
    """``lab_local2``'s inputs: (planes, the 64 candidates' table rows,
    px0, py0), drawn as the lab draws them."""
    rng = np.random.default_rng(1)
    hd, wd, k = 96, 128, 64
    planes, table = lab.fixture_like(seed=1, n=1024, f=126, nb=39, hd=hd,
                                     wd=wd, c=400, valid_frac=0.5,
                                     device=device)
    tslot = torch.from_numpy(rng.integers(0, 1024, (k,))).to(device)
    table_k = {key: v.index_select(0, tslot) for key, v in table.items()}
    px0 = torch.from_numpy(rng.integers(0, wd - 16, (k,)).astype(np.int32))
    py0 = torch.from_numpy(rng.integers(0, hd - 16, (k,)).astype(np.int32))
    return planes, table_k, px0.to(device), py0.to(device)


def nn_inputs(device="cuda", n=16384):
    """``lab_nn``'s inputs: two (n, 3) float32 normal(0, 100) clouds."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(n, 3)).astype(np.float32) * 100
    r = rng.normal(size=(n, 3)).astype(np.float32) * 100
    return torch.from_numpy(q).to(device), torch.from_numpy(r).to(device)


def _row(rows, variant, kernel, args, fn, served, alone=None):
    """Time ``fn`` (and ``alone``, the kernel without the wrapper's
    preparation) from a CUDA graph where the inputs lie on a card, append
    the row and print it; on the CPU print the variant only."""
    row = {"variant": variant, "kernel": kernel}
    if args[0].is_cuda:
        row["graph_ms"] = graph_ms(fn, REPS)
        if alone is not None:
            row["alone_graph_ms"] = graph_ms(alone, REPS)
        row["served_graph_ms"] = served
        row["bound_ms"], row["bound_by"] = bound_ms(kernel, args)
        extra = (f", kernel alone {row['alone_graph_ms']:.4f} ms"
                 if alone is not None else "")
        print(f"{variant:22s} {row['graph_ms']:8.4f} ms (graph){extra}; "
              f"served {served:.4f} ms; bound {row['bound_ms']:.6f} ms "
              f"({row['bound_by']})", flush=True)
    else:
        print(f"{variant:22s} twin run (no timings on the CPU)", flush=True)
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


RUNS = {"coarse": lambda dev: run_coarse(*coarse_inputs(dev)),
        "local2": lambda dev: run_local2(*local2_inputs(dev)),
        "nn": lambda dev: run_nn(*nn_inputs(dev))}


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
    RUNS[args.which](dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
