"""The kernel lab's port (``fealess_tpu_torch/ops/lab.py``: kernels L1-L4
and their plain twins; ``apps/kernel_lab.py``) held on the CPU against
``benchmarks/kernel_lab.py`` and the JAX package's references.

The lab's own L1-L3 cannot run: they call ``score_pallas._pack_planes``
without the ``lanes`` argument it has taken since the multi-tile scorer,
and they extract bytes where the planes are now nibble-packed (pinned by
``test_lab_coarse_runs_are_stale``).  So their twins are held to what the
lab asserts they compute, the JAX package's references: K1's sum
``_coarse_scores_xla`` and K2's ``_local_scores_xla``.  L4's twin is held
to the lab's ``nn_mxu`` run in Pallas interpret mode (``pallas_call``
partial-applied in the test; no file of the JAX side changes) by the lab's
near-tie rule.  The ``cuda`` tests hold each kernel to its twin and skip
without a card; they import nothing of JAX, so they also run on the card
(``python -m pytest --noconftest -m cuda tests/test_torch_kernel_lab.py``).
"""

import functools
import os
import types

import numpy as np
import pytest
import torch

from fealess_tpu_torch.apps import kernel_lab as port_app
from fealess_tpu_torch.ops import bounds, lab, response, score

torch.set_num_threads(1)

SMALL = dict(n=16, f=26, nb=4, hd=6, wd=10, c=16)
TABLES = {"even": dict(SMALL, even=True, valid_frac=0.5),
          "odd": dict(SMALL),
          "wide": dict(seed=3, n=8, f=40, nb=5, hd=7, wd=13, c=9,
                       valid_frac=0.7)}


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's score references and the lab (imported here, so
    that the ``cuda`` tests need no JAX)."""
    import jax.numpy as jnp
    from benchmarks import kernel_lab
    from fealess_tpu.ops import score_pallas
    return types.SimpleNamespace(jnp=jnp, lab=kernel_lab, sp=score_pallas)


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the L kernels are CUDA C++, which "
                    "has no interpret mode")
    return torch.device("cuda", 0)


def _jax_table(jnp, table):
    return {k: jnp.asarray(v.numpy()) for k, v in table.items()}


def _both(jax_side, **kw):
    """The lab's inputs from both packages for the same arguments."""
    pj, tj = jax_side.lab._fixture_like(**kw)
    pp, tp = lab.fixture_like(**kw, device="cpu")
    return (pj, tj), (pp, tp)


@pytest.mark.parametrize("kw", [
    {}, dict(even=True, valid_frac=0.5), dict(TABLES["wide"]),
    dict(seed=1, n=40, f=126, nb=39, hd=96, wd=128, c=40, valid_frac=0.5)])
def test_fixture_like_equals_lab(jax_side, kw):
    (pj, tj), (pp, tp) = _both(jax_side, **kw)
    assert pp.dtype == torch.uint8
    np.testing.assert_array_equal(pp.numpy(), np.asarray(pj))
    assert set(tp) == set(tj)
    for key in tj:
        assert tp[key].dtype == torch.int32
        np.testing.assert_array_equal(tp[key].numpy(), np.asarray(tj[key]),
                                      err_msg=key)


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("name", ["even", "wide"])
def test_bucket_starts_equal_jax(jax_side, stride, name):
    (_, tj), (_, tp) = _both(jax_side, **TABLES[name])
    np.testing.assert_array_equal(
        lab.bucket_starts(tp["bstart"], stride).numpy(),
        np.asarray(jax_side.sp._bucket_starts(tj["bstart"], stride)))


@pytest.mark.parametrize("name", sorted(TABLES))
def test_stride2_bucket_starts_equal_lab_rebucketing(jax_side, name):
    """``stride2_bucket_starts`` against the lab's re-bucketing
    (kernel_lab.py:211-223, which ``coarse_run_stride2`` reaches only past
    its stale packing, so its lines are repeated here) and, on these
    rx-sorted tables, against ``_bucket_starts(bstart, 2)``."""
    jnp = jax_side.jnp
    (_, tj), (_, tp) = _both(jax_side, **TABLES[name])
    n, f = tj["c"].shape
    nb2 = -(-(tj["bstart"].shape[1] - 1) // 2)
    fid = jnp.arange(f)[None, :]
    nvalid = tj["bstart"][:, -1][:, None]
    key = jnp.where(fid < nvalid, tj["rx"] // 2, nb2)
    counts = jnp.sum(key[:, None, :] == jnp.arange(nb2)[None, :, None],
                     axis=2)
    want = jnp.concatenate([jnp.zeros((n, 1), jnp.int32),
                            jnp.cumsum(counts, axis=1, dtype=jnp.int32)],
                           axis=1)
    got = lab.stride2_bucket_starts(tp)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_side.sp._bucket_starts(tj["bstart"], 2)))


def test_shifted_copy_and_plane_stack(jax_side):
    """The shifted copy is the lab's (``jnp.concatenate([x[:, :, 1:],
    zeros], axis=2)``, kernel_lab.py:204-205) on the planes, and the stack
    holds the planes and that copy."""
    jnp = jax_side.jnp
    (pj, _), (pp, _) = _both(jax_side, **TABLES["wide"])
    want = np.asarray(jnp.concatenate([pj[:, :, 1:],
                                       jnp.zeros_like(pj[:, :, :1])], axis=2))
    np.testing.assert_array_equal(lab.shifted_copy(pp).numpy(), want)
    stack = lab.plane_stack(pp)
    assert stack.shape == (2,) + tuple(pp.shape) and stack.is_contiguous()
    assert torch.equal(stack[0], pp)
    np.testing.assert_array_equal(stack[1].numpy(), want)


COARSE_RUNS = [("even", "base"), ("even", "skipempty"), ("even", "unroll2"),
               ("even", "stride2-se0"), ("even", "stride2-se1"),
               ("odd", "base"), ("odd", "skipempty"), ("odd", "stride2-se1"),
               ("wide", "base"), ("wide", "stride2-se0")]


@pytest.mark.parametrize("name,mode", COARSE_RUNS)
def test_coarse_twins_equal_xla(jax_side, name, mode):
    """L1's exact modes and L2 in both settings: K1's sum bitwise, on the
    CPU wrappers (which run the twins)."""
    (pj, tj), (pp, tp) = _both(jax_side, **TABLES[name])
    want = np.asarray(jax_side.sp._coarse_scores_xla(pj, tj))
    if mode.startswith("stride2"):
        got = lab.coarse_stride2(pp, tp, mode.endswith("1"))
    else:
        got = lab.coarse_variant(pp, tp, mode)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(TABLES))
def test_halftrip_twin_equals_xla_on_halved_table(jax_side, name):
    """``halftrip`` walks the first half of each bucket: K1's sum on the
    table of those features."""
    (pj, _), (pp, tp) = _both(jax_side, **TABLES[name])
    half = lab.walked_table(tp, tp["bstart"], half=True)
    lo, hi = tp["bstart"][:, :-1], tp["bstart"][:, 1:]
    assert torch.equal(half["bstart"][:, -1], ((hi - lo) // 2).sum(1).int())
    want = np.asarray(jax_side.sp._coarse_scores_xla(
        pj, _jax_table(jax_side.jnp, half)))
    np.testing.assert_array_equal(
        lab.coarse_variant(pp, tp, "halftrip").numpy(), want)
    assert not np.array_equal(want, np.asarray(jax_side.sp._coarse_scores_xla(
        pj, _jax_table(jax_side.jnp, tp))))


CROWDED = dict(n=2, per_bucket=300, nb=13, f=4000, c=8)


def test_crowded_table_fills_every_bucket():
    table = lab.crowded_table(**CROWDED, device="cpu")
    bstart = table["bstart"]
    assert bstart.shape == (2, 14) and bool((bstart == 300 * torch.arange(
        14, dtype=torch.int32)).all())
    for b in range(13):
        assert bool((table["rx"][:, 300 * b:300 * (b + 1)] == b).all())
    assert bool((table["ry"] == 0).all())
    assert int(table["c"].min()) >= 0 and int(table["c"].max()) < 8
    with pytest.raises(ValueError, match="exceed"):
        lab.crowded_table(per_bucket=316, nb=13, f=4096, device="cpu")


@pytest.mark.parametrize("mode", ["base", "skipempty", "unroll2",
                                  "stride2-se0", "stride2-se1"])
def test_crowded_twins_equal_xla(jax_side, mode):
    """Planes all 255 and 300 live features in each of 13 buckets (the
    flush case of chip_smoke's lab_coarse_cases): the exact twins equal
    K1's sum, and the sums exceed what a 16-bit lane holds, 257 adds of
    255, so a walk that flushed less often than every 257 features
    would differ."""
    planes = torch.full((8, 6, 16), 255, dtype=torch.uint8)
    table = lab.crowded_table(**CROWDED, device="cpu")
    want = np.asarray(jax_side.sp._coarse_scores_xla(
        jax_side.jnp.asarray(planes.numpy()),
        _jax_table(jax_side.jnp, table)))
    assert want.max() > 257 * 255
    if mode.startswith("stride2"):
        got = lab.coarse_stride2(planes, table, mode.endswith("1"))
    else:
        got = lab.coarse_variant(planes, table, mode)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("stride,use_cond", [(1, False), (1, True),
                                             (2, False), (2, True)])
def test_crowded_local_twins_equal_xla(jax_side, stride, use_cond):
    """L3's twin on the crowded table (300 live features in each of 13
    buckets; chip_smoke's lab_local_cases holds the kernel to it on the
    lab's planes, all 255) equals K2's window sums, which exceed what a
    16-bit lane holds, 257 adds of 255: a slice that flushed its lanes
    less often than every 257 features would differ."""
    jnp = jax_side.jnp
    planes = torch.full((8, 24, 32), 255, dtype=torch.uint8)
    table = lab.crowded_table(**CROWDED, device="cpu")
    px0 = np.array([0, 3], np.int32)
    py0 = np.array([0, 5], np.int32)
    want = np.asarray(jax_side.sp._local_scores_xla(
        jnp.asarray(planes.numpy()), _jax_table(jnp, table),
        jnp.asarray(px0), jnp.asarray(py0)))
    assert want.max() > 257 * 255
    got = lab.local_variant(planes, table, torch.from_numpy(px0),
                            torch.from_numpy(py0), stride, use_cond)
    np.testing.assert_array_equal(got.numpy(), want)


def test_noshift_twin_follows_its_word_rule():
    """The ``noshift`` twin against its docstring's rule, walked in numpy
    position by position: byte i of the aligned word q of the run."""
    planes, table = lab.fixture_like(seed=7, n=3, f=12, nb=3, hd=4, wd=16,
                                     c=4, device="cpu")
    got = lab.coarse_variant(planes, table, "noshift").numpy()
    flat = planes.numpy().reshape(-1)
    c, hd, wd = planes.shape
    want = np.zeros(got.shape, np.int64)
    bstart = table["bstart"].numpy()
    for n in range(3):
        for b in range(bstart.shape[1] - 1):
            for f in range(bstart[n, b], bstart[n, b + 1]):
                cc, ry = int(table["c"][n, f]), int(table["ry"][n, f])
                for y in range(hd):
                    for x in range(wd):
                        x0 = x - x % lab.RUN
                        start = cc * hd * wd + (y + ry) * wd + x0 + b
                        word = min(start // 4 + (x % lab.RUN) // 4,
                                   flat.size // 4 - 1)
                        want[n, y, x] += flat[4 * word + x % 4]
    np.testing.assert_array_equal(got, want)


def test_unroll2_raises_on_odd_bucket_starts():
    planes, table = lab.fixture_like(**SMALL, device="cpu")
    assert bool((table["bstart"] % 2 != 0).any())
    with pytest.raises(ValueError, match="even bucket starts"):
        lab.coarse_variant(planes, table, "unroll2")
    with pytest.raises(ValueError, match="mode"):
        lab.coarse_variant(planes, table, "unroll3")


@pytest.mark.parametrize("origins", ["lab", "border", "edge-1", "edge0"])
@pytest.mark.parametrize("stride,use_cond", [(1, False), (1, True),
                                             (2, False), (2, True)])
def test_local_twins_equal_xla(jax_side, stride, use_cond, origins):
    """L3's four settings: K2's window sums bitwise, at the lab's origins,
    at negative and border ones (windows past every edge), and at the
    stride-2 edges of ``chip_smoke.lab_local_cases`` (candidate i's
    stride-2 bucket j = i % ceil(NB / 2) has its odd column at Wd - 1,
    ``edge-1``, or at Wd, ``edge0``: where the TPU's shifted copy zeroed
    its last column), some of them on a live odd-rx feature."""
    jnp = jax_side.jnp
    hd, wd, k = 24, 32, 12
    kw = dict(seed=1, n=32, f=30, nb=7, hd=hd, wd=wd, c=9, valid_frac=0.5)
    (pj, tj), (pp, tp) = _both(jax_side, **kw)
    rng = np.random.default_rng(1)
    tslot = rng.integers(0, 32, (k,))
    if origins == "lab":     # lab_local2's range
        px0 = rng.integers(0, wd - 16, (k,)).astype(np.int32)
        py0 = rng.integers(0, hd - 16, (k,)).astype(np.int32)
    elif origins == "border":
        px0 = rng.integers(-25, wd + 8, (k,)).astype(np.int32)
        py0 = rng.integers(-20, hd + 6, (k,)).astype(np.int32)
    else:
        j = np.arange(k) % -(-kw["nb"] // 2)
        end = 1 if origins == "edge-1" else 0
        px0 = (wd - 1 - end - 2 * j).astype(np.int32)
        py0 = rng.integers(0, hd - 16, (k,)).astype(np.int32)
        bstart = tp["bstart"].numpy()[tslot]
        odd = 2 * j + 1 < kw["nb"]
        live = bstart[np.arange(k), np.minimum(2 * j + 2, kw["nb"])] > \
            bstart[np.arange(k), np.minimum(2 * j + 1, kw["nb"])]
        assert (odd & live).any(), "no live odd-rx feature at the edge"
    want = np.asarray(jax_side.sp._local_scores_xla(
        pj, {key: v[tslot] for key, v in tj.items()}, jnp.asarray(px0),
        jnp.asarray(py0)))
    table_k = {key: v[torch.from_numpy(tslot)].contiguous()
               for key, v in tp.items()}
    got = lab.local_variant(pp, table_k, torch.from_numpy(px0),
                            torch.from_numpy(py0), stride, use_cond)
    assert got.dtype == torch.int32 and got.shape == (k, 16, 16)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nq,nr", [(600, 5000), (37, 2049)])
def test_nn_mxu_twin_near_tie_with_jax_interpret(jax_side, monkeypatch, nq,
                                                 nr):
    """L4's twin against the lab's ``nn_mxu`` in Pallas interpret mode
    (ragged against both 256 x 2048 tiles): ``lab.near_tie`` in every row
    (the lab's near-tie rule and d2 within ``lab.D2_CANCEL`` of |q|^2 +
    |r|^2; the worst relative d2 gap and share of the d2 limit printed),
    and duplicate reference rows straddling each 2048-row tile edge (row
    b = row b - 1, a query on it) resolved to the first index."""
    jnp = jax_side.jnp
    monkeypatch.setattr(jax_side.lab.pl, "pallas_call", functools.partial(
        jax_side.lab.pl.pallas_call, interpret=True))
    rng = np.random.default_rng(nq)
    q = rng.normal(size=(nq, 3)).astype(np.float32) * 100
    r = rng.normal(size=(nr, 3)).astype(np.float32) * 100
    edges = list(range(2048, nr, 2048))
    for i, b in enumerate(edges):
        r[b] = r[b - 1]
        q[i] = r[b - 1]
    ij, dj = (np.asarray(v) for v in jax_side.lab.nn_mxu(jnp.asarray(q),
                                                          jnp.asarray(r)))
    ip, dp = lab.nn_mxu(torch.from_numpy(q), torch.from_numpy(r))
    assert ip.dtype == torch.int32 and dp.dtype == torch.float32
    ok, same, worst, share = lab.near_tie(
        ip, dp, torch.from_numpy(ij.copy()), torch.from_numpy(dj.copy()),
        torch.from_numpy(q), torch.from_numpy(r))
    # the worst gap is at the queries planted on a reference row (d2 ~ 0,
    # measured against max(d2, 1)), where the indices agree
    print(f"nn_mxu twin vs interpret {nq} x {nr}: idx_equal={same}/{nq}, "
          f"max_rel={worst:.3e}, d2 share={share:.3e}")
    assert ok, (same, worst, share)
    assert ip[:len(edges)].tolist() == [b - 1 for b in edges]
    assert ij[:len(edges)].tolist() == [b - 1 for b in edges]


def _tf32_nearest(bits: int) -> int:
    """cvt.rna's rule from the values, not the bits' carry: the two TF32
    values around x (low 13 bits cleared, and the next one up in magnitude,
    2^128 past the largest finite), the nearer one, ties away from zero;
    infinity past the largest finite value, NaN and infinity as they are."""
    x = np.uint32(bits).view(np.float32)
    if not np.isfinite(x):
        return bits
    sign, mag = bits & 0x80000000, bits & 0x7FFFFFFF
    down = mag & ~0x1FFF
    v_down = float(np.uint32(down).view(np.float32))
    up = down + 0x2000
    v_up = 2.0 ** 128 if up >= 0x7F800000 else \
        float(np.uint32(up).view(np.float32))
    v = abs(float(x))
    pick = up if v_up - v <= v - v_down else down
    return sign | min(pick, 0x7F800000)


@pytest.mark.parametrize("bits", lab.TF32_EDGE_BITS,
                         ids=[f"{b:08x}" for b in lab.TF32_EDGE_BITS])
def test_tf32_round_is_cvt_rna_rule(bits):
    """L4's operand rounding (``lab.tf32_round``, cvt.rna on the bits)
    against the rule worked from the values, on the edge patterns: halfway
    both ways and both signs, +-0, just under a power of two, a subnormal,
    the TPU lab's padding value 3e9, past the largest finite TF32 value;
    the low 13 bits of every finite result are 0."""
    x = torch.tensor([bits], dtype=torch.int64)
    x = (x - (x >> 31 << 32)).to(torch.int32).view(torch.float32)
    got = int(lab.tf32_round(x).view(torch.int32)[0]) & 0xFFFFFFFF
    assert got == _tf32_nearest(bits), (hex(bits), hex(got))
    if np.isfinite(np.uint32(got).view(np.float32)):
        assert got & 0x1FFF == 0


def test_nn_operands_layout():
    """The operands' shapes, the slots of one point in the documented order,
    the padding rows 0, and the tile order (``nn_operands`` on CPU tensors)
    as the logical B's rows regrouped by 8: (group, k step, k half, row,
    4)."""
    q, r = port_app.nn_inputs("cpu", n=300)
    a, b = lab.nn_operands_plain(q, r)
    assert a.shape == (300, lab.NN_SLOTS)
    assert b.shape == (-(-300 // lab.NN_TILE) * lab.NN_TILE, lab.NN_SLOTS)
    assert not b[300:].any()
    qh = lab.tf32_round(q[5])
    ql = lab.tf32_round(q[5] - qh)
    assert torch.equal(a[5, :3], -2 * qh) and torch.equal(a[5, 3:6], -2 * ql)
    assert torch.equal(a[5, 8:11], -2 * qh)
    assert a[5, 12:].tolist() == [1.0, 1.0, 1.0, 0.0]
    rh = lab.tf32_round(r[7])
    assert torch.equal(b[7, :3], rh) and torch.equal(b[7, 3:6], rh)
    assert b[7, 6:8].tolist() == [1.0, 1.0] and b[7, 11].item() == 1.0
    qn = q[5, 0] * q[5, 0] + q[5, 1] * q[5, 1] + q[5, 2] * q[5, 2]
    pieces = [a[5, 6], a[5, 7], a[5, 11]]
    assert float(sum(float(p) for p in pieces)) == float(qn)
    assert all(torch.equal(lab.tf32_round(p), p) for p in pieces)
    a2, tiles = lab.nn_operands(q, r)
    assert torch.equal(a2, a) and tiles.is_contiguous()
    assert tiles.shape == (b.shape[0] // 8, 2, 2, 8, 4)
    for j, k in ((0, 0), (7, 5), (9, 12), (300, 3), (b.shape[0] - 1, 15)):
        assert tiles[j // 8, k // 8, (k % 8) // 4, j % 8, k % 4] == b[j, k]


def _folded(a, b, nr):
    """The product the kernel's accumulator holds, in float32 in the k8
    steps' order (every product of two TF32 values is exact): (first index
    of the minimum, that d2) over the first nr rows of B."""
    acc = torch.zeros((a.shape[0], nr), dtype=torch.float32)
    for k in range(lab.NN_SLOTS):
        acc = acc + a[:, k, None] * b[None, :nr, k]
    idx = acc.argmin(dim=1)
    return idx.to(torch.int32), acc.gather(1, idx[:, None])[:, 0]


@pytest.mark.parametrize("nq,nr", [(600, 5000), (37, 2049)])
def test_folded_product_near_tie_with_twin_and_jax_interpret(
        jax_side, monkeypatch, nq, nr):
    """L4's folded operands: A @ B.T summed in float32 in the k8 steps'
    order passes ``lab.near_tie`` against ``nn_mxu_plain`` and against the
    lab's ``nn_mxu`` in Pallas interpret mode (the ragged shapes and the
    duplicates planted across 2048-row edges of the twin's test, the first
    index winning); the share of the d2 limit used is printed."""
    jnp = jax_side.jnp
    monkeypatch.setattr(jax_side.lab.pl, "pallas_call", functools.partial(
        jax_side.lab.pl.pallas_call, interpret=True))
    rng = np.random.default_rng(nq)
    q = rng.normal(size=(nq, 3)).astype(np.float32) * 100
    r = rng.normal(size=(nr, 3)).astype(np.float32) * 100
    edges = list(range(2048, nr, 2048))
    for i, b in enumerate(edges):
        r[b] = r[b - 1]
        q[i] = r[b - 1]
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    idx, d2 = _folded(*lab.nn_operands_plain(qt, rt), nr)
    ij, dj = (torch.from_numpy(np.asarray(v).copy())
              for v in jax_side.lab.nn_mxu(jnp.asarray(q), jnp.asarray(r)))
    for what, want in (("twin", lab.nn_mxu_plain(qt, rt)), ("JAX", (ij, dj))):
        ok, same, worst, share = lab.near_tie(idx, d2, *want, qt, rt)
        print(f"folded product vs {what} {nq} x {nr}: idx_equal={same}/{nq}"
              f", max_rel={worst:.3e}, d2 share={share:.3e}")
        assert ok, (what, same, worst, share)
        assert share < 0.5
    assert idx[:len(edges)].tolist() == [b - 1 for b in edges]


def test_nn_operands_refuse_other_devices():
    q = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="no kernel"):
        lab.nn_operands(q.to("meta"), q.to("meta"))
    with pytest.raises(ValueError, match="tiles"):
        lab.nn_mxu(q, q, 32, 0, prepared=lab.nn_operands(q, q))


def test_phase9_operand_check_rehearses_on_cpu():
    """chip_smoke's check of L4's operand kernel against its twin, on CPU
    tensors (where ``nn_operands`` runs the twin), builds its TF32-edge
    points and passes."""
    import chip_smoke
    chip_smoke.hold_nn_operands(*port_app.nn_inputs("cpu", n=2100), "CPU")


@pytest.mark.parametrize("wrong", ["no_qn", "no_rn", "half_dot",
                                   "out_of_range"])
def test_near_tie_refuses_a_wrong_d2(wrong):
    """A d2 that lacks a term of the matrix form keeps every index (|q|^2
    is the same for every candidate of a query) and passes the lab's
    near-tie rule alone; the d2 limit refuses it, as it refuses an index
    past the reference rows."""
    q, r = port_app.nn_inputs("cpu", n=700)
    idx, d2 = lab.nn_mxu_plain(q, r)
    ok, same, worst, share = lab.near_tie(idx, d2, idx, d2, q, r)
    assert ok and same == 700 and worst == 0.0 and share == 0.0
    rn = (r * r).sum(dim=1)[idx.long()]
    qn = (q * q).sum(dim=1)
    bad_idx, bad = idx.clone(), {
        "no_qn": d2 - qn, "no_rn": d2 - rn, "half_dot": d2 + (
            qn + rn - d2) / 2, "out_of_range": d2}[wrong]
    if wrong == "out_of_range":
        bad_idx[3] = r.shape[0]
    ok, _, _, share = lab.near_tie(bad_idx, bad, idx, d2, q, r)
    assert not ok
    assert wrong == "out_of_range" or share > 1.0


@pytest.mark.parametrize("run", ["coarse_run", "coarse_run_stride2",
                                 "_local_variant_run"])
def test_lab_coarse_runs_are_stale(jax_side, run):
    """The finding this port rests on: the lab's L1-L3 call
    ``_pack_planes(planes, hpad)`` without ``lanes``.  If this fails, the
    lab runs again: hold the port to it directly."""
    planes, table = jax_side.lab._fixture_like(**TABLES["even"])
    args = {"coarse_run": (planes, table, "base"),
            "coarse_run_stride2": (planes, table),
            "_local_variant_run": (
                planes, table, jax_side.jnp.zeros(16, jax_side.jnp.int32),
                jax_side.jnp.zeros(16, jax_side.jnp.int32), 1, True)}[run]
    with pytest.raises(TypeError, match="lanes"):
        getattr(jax_side.lab, run)(*args)


def test_wrappers_refuse_other_devices_and_bad_tiles():
    planes, table = lab.fixture_like(**SMALL, device="cpu")
    meta = {k: v.to("meta") for k, v in table.items()}
    with pytest.raises(ValueError, match="no kernel"):
        lab.coarse_variant(planes.to("meta"), meta)
    with pytest.raises(ValueError, match="no kernel"):
        lab.coarse_stride2(planes.to("meta"), meta)
    q = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="no kernel"):
        lab.nn_mxu(q.to("meta"), q.to("meta"))
    for tq, tr in ((48, 2048), (512, 2048), (256, 0)):
        with pytest.raises(ValueError, match="tiles"):
            lab.nn_mxu(q, q, tq, tr)
    with pytest.raises(ValueError, match="stride"):
        lab.local_variant(planes, table, q[:, 0].int(), q[:, 0].int(), 3)


def test_staged_table_limits():
    """L1/L2 stage 8 bytes a feature and the bucket starts in 48 KiB; L3
    only the features (its bucket bounds stay in registers): 4096
    features in 4096 buckets fit L3 and not L1."""
    planes = torch.zeros((1, 4, 4), dtype=torch.uint8)
    table = lab.crowded_table(n=1, per_bucket=1, nb=4096, f=4096, c=1,
                              device="cpu")
    lab._require_inputs(planes, table, 1, 1, "local_variant",
                        staged_starts=False)
    with pytest.raises(ValueError, match="4096 features and 4097 staged"):
        lab._require_inputs(planes, table, 1, 1, "coarse_variant")
    small = lab.crowded_table(n=1, per_bucket=1, nb=4095, f=4096, c=1,
                              device="cpu")
    lab._require_inputs(planes, small, 1, 1, "coarse_variant")


def test_bound_ms_counts():
    """The bounds of the lab's kernels: L1/L2 K1's count (halftrip its own
    features); L4 the least work of any form at 16384 x 16384, the dot at
    float32 accuracy (three TF32 passes, ~0.0098 ms) over one compare and
    one select a pair on the CUDA cores (~0.0080 ms)."""
    planes, table = lab.fixture_like(**TABLES["even"], device="cpu")
    k1 = bounds.bound_ms("coarse_scores", (planes, table))
    assert bounds.bound_ms("coarse_variant", (planes, table, "base")) == k1
    assert bounds.bound_ms("coarse_stride2", (planes, table, True)) == k1
    half = bounds.bound_ms("coarse_variant", (planes, table, "halftrip"))
    assert half[0] <= k1[0]
    q = torch.zeros((16384, 3))
    ms, by = bounds.bound_ms("nn_mxu", (q, q))
    assert by == "operations" and abs(ms - 18 * 16384 ** 2 / 495e12 * 1e3) \
        < 1e-12
    assert 0.0097 < ms < 0.0098
    assert 0.0080 < 2 * 16384 ** 2 / 67e12 * 1e3 < ms
    with pytest.raises(ValueError, match="no bound"):
        bounds.bound_ms("nothing", ())


def _small_images(seed, shapes):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, 256, hw, np.uint8))
            for hw in shapes]


@pytest.mark.parametrize("which", ["coarse", "local2", "nn", "topk",
                                   "frontend", "local", "local3"])
def test_app_runs_on_cpu(which, capsys):
    """``apps/kernel_lab``'s runs on CPU tensors at small shapes: the
    twins, the lab's asserts and the equality with the served kernels'
    twins (L1-L4), the rows' equality (topk, frontend, local, local3), one
    line a variant, no timings."""
    if which == "coarse":
        rows = port_app.run_coarse(*lab.fixture_like(**TABLES["even"],
                                                     device="cpu"))
        want = [f"coarse/{m}" for m in lab.MODES] + \
            ["coarse/stride2-se0", "coarse/stride2-se1"]
    elif which == "local2":
        planes, table = lab.fixture_like(seed=1, n=32, f=30, nb=7, hd=24,
                                         wd=32, c=9, valid_frac=0.5,
                                         device="cpu")
        idx = torch.arange(0, 32, 3)
        table_k = {k: v[idx].contiguous() for k, v in table.items()}
        origin = (idx % 8).int()
        rows = port_app.run_local2(planes, table_k, origin, origin)
        want = ["local2/s1-cond0", "local2/s1-cond1", "local2/s2-cond0",
                "local2/s2-cond1"]
    elif which == "nn":
        rows = port_app.run_nn(*port_app.nn_inputs("cpu", n=700))
        want = ["nn/mxu-dot"]
        assert rows[0]["idx_equal"] >= 690
    else:
        planes, table = lab.fixture_like(seed=1, n=32, f=30, nb=7, hd=24,
                                         wd=32, c=400, device="cpu")
        tslot = torch.arange(0, 32, 3)
        origin = (tslot % 8).int()
        if which == "topk":
            rows = port_app.run_topk(*port_app.topk_tie_inputs(
                "cpu", n=16, hd=6, wd=8))
            want = ["topk/flat-1.2M", "topk/2level-r16", "topk/2level-r96"]
        elif which == "frontend":
            rows = port_app.run_frontend(*_small_images(0, [(40, 80),
                                                            (16, 32)]))
            want = ["front/current-u8", "front/i32", "front/u8copy"]
        elif which == "local":
            rows = port_app.run_local(planes, table, tslot, origin, origin)
            want = ["local/gather-fancy", "local/kernel-only"]
        else:
            rows = port_app.run_local3(
                *_small_images(1, [(120, 160), (120, 160)]),
                lab.gather_rows(table, tslot), origin, origin)
            want = ["local3/front+kernel", "local3/front-slices+kernel",
                    "local3/front-only"]
        assert [row["kernel"] for row in rows] == [
            "local_scores" if w.startswith("local") and
            not w.endswith("front-only") else None for w in want]
    assert [row["variant"] for row in rows] == want
    assert all("graph_ms" not in row for row in rows)
    out = capsys.readouterr().out
    twins = sum(row["kernel"] is not None for row in rows)
    assert out.count("twin run (no timings on the CPU)") == twins
    assert out.count("run on the CPU (no timings)") == len(want) - twins


def test_phase9_checks_rehearse_on_cpu(monkeypatch):
    """chip_smoke's phase-9 checks on CPU tensors at small shapes (where
    the wrappers run their twins): the edge cases build, every L1-L3 case
    equals its twin and the served kernels', L4 meets the near-tie rule
    against its twin and K3 with the planted first indices; the top-k
    (the lab's draw and a tie-heavy one), front-end and K2 checks of the
    runs that add no kernel pass."""
    import chip_smoke
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    coarse = lab.fixture_like(n=16, f=60, nb=13, hd=6, wd=40, c=32,
                              even=True, valid_frac=0.5, device="cpu")
    planes, table = lab.fixture_like(seed=1, n=64, f=40, nb=39, hd=24,
                                     wd=48, c=20, valid_frac=0.5,
                                     device="cpu")
    idx = torch.arange(0, 64, 4)
    local = (planes, {k: v[idx].contiguous() for k, v in table.items()},
             (idx % 30).int(), (idx % 8).int())
    errs = {}
    coarse_cases = chip_smoke.lab_coarse_cases(*coarse, slots=600)
    local_cases = chip_smoke.lab_local_cases(*local, slots=300)
    assert len(coarse_cases["coarse_variant"]) == 50
    assert len(coarse_cases["coarse_stride2"]) == 22
    assert len(local_cases) == 60
    chip_smoke.hold_to_twins(coarse_cases, errs, "CPU")
    chip_smoke.hold_to_twins({"local_variant": local_cases}, errs, "CPU")
    chip_smoke.hold_nn_mxu(chip_smoke.lab_nn_cases(
        *port_app.nn_inputs("cpu", n=2100)), errs, "CPU")
    chip_smoke.hold_to_served(coarse_cases, local_cases)
    chip_smoke.hold_topk([port_app.topk_inputs("cpu", n=64, hd=12, wd=16),
                          port_app.topk_tie_inputs("cpu", n=64, hd=12,
                                                   wd=16)], "CPU")
    chip_smoke.hold_front(*_small_images(0, [(40, 80), (16, 32)]), "CPU")
    table_k = {k: v[idx].contiguous() for k, v in table.items()}
    chip_smoke.hold_local_lab(
        (planes, table, idx, (idx % 30).int(), (idx % 8).int()),
        (*_small_images(1, [(120, 240), (120, 240)]), table_k,
         (idx % 30).int(), (idx % 8).int()), errs, "CPU")
    assert errs == {"coarse_variant": 0.0, "coarse_stride2": 0.0,
                    "local_variant": 0.0, "nn_mxu": 0.0,
                    "local_refine": 0.0}


# -- the runs that add no kernel: topk, frontend, local, local3 ---------------


def _lab_topk_draws(jnp, n, hd, wd):
    """``lab_topk``'s lines (kernel_lab.py:293-299) at another size."""
    rng = np.random.default_rng(0)
    flat = jnp.asarray(rng.normal(size=(n * hd * wd,)).astype(np.float32))
    mask = rng.random(n * hd * wd) < 0.02
    return jnp.where(jnp.asarray(mask), flat + 100.0, -jnp.inf)


TOPK_SHAPES = {"lab": (1024, 30, 40), "small": (64, 12, 16),
               "sparse": (16, 6, 8)}


@pytest.mark.parametrize("draw", ["lab", "ties"])
@pytest.mark.parametrize("shape", sorted(TOPK_SHAPES))
def test_topk_forms_equal_lab(jax_side, draw, shape):
    """The served flat top-k (``detector.exact_top_k_flat``) against the
    lab's ``_topk_flat`` (``jax.lax.top_k``) and the per-row form
    (``exact_top_k_rows``) against its ``_topk_two_level`` at rows = n and
    n * hd, scores and indices exactly: on the lab's draws (whose inputs
    are first shown equal; at the lab's 1.2M and smaller) and on a
    tie-heavy draw (integer scores 0..3, 2% live, the rest -inf: the top 64
    are ties that only the index order decides; at "sparse" fewer than 64
    are live, so -inf ties fill the tail)."""
    jnp = jax_side.jnp
    n, hd, wd = TOPK_SHAPES[shape]
    make = port_app.topk_inputs if draw == "lab" else \
        port_app.topk_tie_inputs
    flat, k, rows_list = make("cpu", n=n, hd=hd, wd=wd)
    assert k == 64 and rows_list == (n, n * hd)
    if draw == "lab":
        np.testing.assert_array_equal(
            flat.numpy(), np.asarray(_lab_topk_draws(jnp, n, hd, wd)))
    fj = jnp.asarray(flat.numpy())
    s0, i0 = jax_side.lab._topk_flat(fj, k)
    s, i = port_app.detector.exact_top_k_flat(flat, k)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s0))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i0))
    top = flat.numpy()[i.numpy()]
    if draw == "ties":
        assert (top == top[0]).sum() > 1
    for rows in rows_list:
        s1, i1 = jax_side.lab._topk_two_level(fj, k, rows)
        s, i = port_app.detector.exact_top_k_rows(flat, k, rows)
        np.testing.assert_array_equal(s.numpy(), np.asarray(s1))
        np.testing.assert_array_equal(i.numpy(), np.asarray(i1))
        np.testing.assert_array_equal(i.numpy(), np.asarray(i0))


@pytest.mark.parametrize("t,dtype", [(5, "int32"), (5, "uint8"),
                                     (8, "int32"), (8, "uint8")])
def test_build_level_2d_dtype_equals_lab(jax_side, t, dtype):
    """``lab.build_level_2d_dtype`` against the lab's
    ``_build_level_2d_dtype`` at its image sizes (480 x 640 at T = 5, 240 x
    320 at T = 8, ``frontend_inputs``, first shown equal to the lab's
    draws), values and working type exactly, and against the served
    ``response.build_level_2d``."""
    jnp = jax_side.jnp
    q0, q1 = port_app.frontend_inputs("cpu")
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        q0.numpy(), rng.integers(0, 256, (480, 640), np.uint8))
    np.testing.assert_array_equal(
        q1.numpy(), rng.integers(0, 256, (240, 320), np.uint8))
    q = q0 if t == 5 else q1
    want = np.asarray(jax_side.lab._build_level_2d_dtype(
        jnp.asarray(q.numpy()), t, getattr(jnp, dtype)))
    got = lab.build_level_2d_dtype(q, t, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and want.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got.to(torch.int32), response.build_level_2d(q, t))


@pytest.mark.parametrize("t", [5, 8])
def test_build_level_2d_slices_equals_served(jax_side, t):
    """``lab.build_level_2d_slices`` (the decimation as strided slices)
    against JAX's served ``build_level_2d`` (its decimate-first path off
    the TPU) and the port's, at the lab's image sizes."""
    from fealess_tpu.ops import response as jax_response
    q = port_app.frontend_inputs("cpu")[0 if t == 5 else 1]
    got = lab.build_level_2d_slices(q, t)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jax_response.build_level_2d(jax_side.jnp.asarray(q.numpy()), t)))
    assert torch.equal(got, response.build_level_2d(q, t))


def test_local_run_equals_lab(jax_side):
    """``local``: ``local_inputs`` equal to the lab's draws (``lab_local``,
    kernel_lab.py:388-396), ``lab.gather_rows`` to its ``_gather_fancy``,
    and K2's twin on the gathered rows to ``score_pallas.local_scores``
    (``_local_scores_xla`` off the TPU) exactly."""
    jnp = jax_side.jnp
    rng = np.random.default_rng(1)
    pj, tj = jax_side.lab._fixture_like(seed=1, n=1024, f=126, nb=7, hd=96,
                                        wd=128, c=400)
    tsj = jnp.asarray(rng.integers(0, 1024, (64,)), jnp.int32)
    pxj = jnp.asarray(rng.integers(0, 128 - 16, (64,)), jnp.int32)
    pyj = jnp.asarray(rng.integers(0, 96 - 16, (64,)), jnp.int32)
    planes, table, tslot, px0, py0 = port_app.local_inputs("cpu")
    np.testing.assert_array_equal(planes.numpy(), np.asarray(pj))
    for key in tj:
        np.testing.assert_array_equal(table[key].numpy(),
                                      np.asarray(tj[key]), err_msg=key)
    for got, want in ((tslot, tsj), (px0, pxj), (py0, pyj)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    gj = jax_side.lab._gather_fancy(tj, tsj)
    table_k = lab.gather_rows(table, tslot)
    for key in gj:
        assert table_k[key].dtype == torch.int32
        np.testing.assert_array_equal(table_k[key].numpy(),
                                      np.asarray(gj[key]), err_msg=key)
    want = np.asarray(jax_side.sp.local_scores(pj, gj, pxj, pyj))
    got = score.local_scores(planes, table_k, px0, py0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()


def test_local3_run_equals_lab(jax_side):
    """``local3``: ``local3_inputs`` equal to the lab's draws (both images
    before the table, the slots and origins after it, kernel_lab.py:
    513-524), and K2's twin behind the port's front end (``front_planes``:
    both modalities' level-0 planes, cast to u8) and behind its
    strided-slices form equal to the lab's ``with_front`` (JAX's
    ``build_level_2d`` twice, concatenated, then ``local_scores``) at full
    size."""
    from fealess_tpu.ops import response as jax_response
    jnp = jax_side.jnp
    rng = np.random.default_rng(1)
    i0 = jnp.asarray(rng.integers(0, 256, (480, 640), np.uint8))
    i1 = jnp.asarray(rng.integers(0, 256, (480, 640), np.uint8))
    _, tj = jax_side.lab._fixture_like(seed=1, n=1024, f=126, nb=39, hd=96,
                                       wd=128, c=400, valid_frac=0.5)
    tsj = jnp.asarray(rng.integers(0, 1024, (64,)), jnp.int32)
    tkj = {key: tj[key][tsj] for key in tj}
    pxj = jnp.asarray(rng.integers(0, 128 - 16, (64,)), jnp.int32)
    pyj = jnp.asarray(rng.integers(0, 96 - 16, (64,)), jnp.int32)
    img0, img1, table_k, px0, py0 = port_app.local3_inputs("cpu")
    for got, want in ((img0, i0), (img1, i1), (px0, pxj), (py0, pyj)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for key in tkj:
        np.testing.assert_array_equal(table_k[key].numpy(),
                                      np.asarray(tkj[key]), err_msg=key)
    planes_j = jnp.concatenate([jax_response.build_level_2d(i0, 5),
                                jax_response.build_level_2d(i1, 5)], axis=0)
    want = np.asarray(jax_side.sp.local_scores(planes_j, tkj, pxj, pyj))
    planes = port_app.front_planes(img0, img1)
    assert planes.dtype == torch.uint8 and planes.shape == (400, 96, 128)
    np.testing.assert_array_equal(planes.numpy(), np.asarray(planes_j))
    for build in (response.build_level_2d, lab.build_level_2d_slices):
        got = score.local_scores(port_app.front_planes(img0, img1, build),
                                 table_k, px0, py0)
        np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()


def test_every_lab_subcommand_has_a_run():
    """The JAX lab's ``__main__`` dispatch (``which == "..."``), read with
    ``ast``, names the same seven subcommands as the port's ``RUNS``."""
    import ast
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks", "kernel_lab.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    main = [node for node in tree.body if isinstance(node, ast.If)
            and "__main__" in ast.unparse(node.test)]
    assert len(main) == 1
    names = {cmp.comparators[0].value for cmp in ast.walk(main[0])
             if isinstance(cmp, ast.Compare)
             and isinstance(cmp.left, ast.Name) and cmp.left.id == "which"
             and isinstance(cmp.ops[0], ast.Eq)}
    assert len(names) == 7
    assert names == set(port_app.RUNS)


# -- on the card --------------------------------------------------------------


@pytest.mark.cuda
def test_coarse_kernels_equal_twins_on_card(card):
    planes, table = lab.fixture_like(even=True, valid_frac=0.5, device=card)
    for mode in lab.MODES:
        got = lab.coarse_variant(planes, table, mode)
        assert torch.equal(got, lab.coarse_variant_plain(planes, table,
                                                         mode)), mode
    want = score.coarse_scores(planes, table)
    for skip in (False, True):
        assert torch.equal(lab.coarse_stride2(planes, table, skip), want)
    full = torch.full_like(planes, 255)
    crowded = lab.crowded_table(device=card)
    want = score.coarse_scores(full, crowded)
    assert int(want.max()) > 257 * 255
    for mode in lab.MODES:
        got = lab.coarse_variant(full, crowded, mode)
        assert torch.equal(got, lab.coarse_variant_plain(full, crowded,
                                                         mode)), mode
        if mode in lab.EXACT_MODES:
            assert torch.equal(got, want), mode
    for skip in (False, True):
        assert torch.equal(lab.coarse_stride2(full, crowded, skip), want)


@pytest.mark.cuda
def test_local_kernel_equals_twin_on_card(card):
    planes, table_k, px0, py0 = port_app.local2_inputs(card)
    want = score.local_scores(planes, table_k, px0, py0)
    full = torch.full_like(planes, 255)
    crowded = lab.crowded_table(c=planes.shape[0], device=card)
    o8 = (px0[:8].contiguous(), py0[:8].contiguous())
    want_crowded = score.local_scores(full, crowded, *o8)
    assert int(want_crowded.max()) > 257 * 255
    j = torch.arange(px0.shape[0], device=card, dtype=torch.int32) % 20
    for stride in (1, 2):
        for use_cond in (False, True):
            for ox, oy in ((px0, py0), (px0 - 20, py0 - 20),
                           (126 - 2 * j, py0), (127 - 2 * j, py0)):
                args = (planes, table_k, ox, oy, stride, use_cond)
                assert torch.equal(lab.local_variant(*args),
                                   lab.local_variant_plain(*args))
            assert torch.equal(lab.local_variant(
                planes, table_k, px0, py0, stride, use_cond), want)
            assert torch.equal(lab.local_variant(
                full, crowded, *o8, stride, use_cond), want_crowded)


@pytest.mark.cuda
def test_nn_operands_equal_twin_on_card(card):
    q, r = port_app.nn_inputs(card, n=3001)
    a, b = lab.nn_operands(q, r)
    want_a, want_b = lab.nn_operands_plain(q, r)
    assert torch.equal(a.view(torch.int32), want_a.view(torch.int32))
    assert torch.equal(b.view(torch.int32),
                       lab.tile_order(want_b).view(torch.int32))


@pytest.mark.cuda
def test_nn_mma_near_tie_on_card(card):
    q, r = port_app.nn_inputs(card, n=5000)
    idx, d2 = lab.nn_mxu(q, r)
    ok, same, worst, share = lab.near_tie(idx, d2, *lab.nn_mxu_plain(q, r),
                                          q, r)
    assert ok, (same, worst, share)
