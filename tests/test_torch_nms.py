"""The port's 3D NMS held against the JAX ``nms_3d``: ``keep`` and
``winner`` must be equal, on seeded random candidates, on planted
clusters (the winner moves inside a cluster), with equal ``icp_dist``
ties, invalid candidates and the 85% point-count gate."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fealess_tpu import nms as jax_nms
from fealess_tpu_torch import nms as port_nms

torch.set_num_threads(1)


def _both(t, dist, npts, valid, th):
    want = jax_nms.nms_3d(jnp.asarray(t), jnp.asarray(dist),
                          jnp.asarray(npts), jnp.asarray(valid), th)
    got = port_nms.nms_3d(torch.from_numpy(t), torch.from_numpy(dist),
                          torch.from_numpy(npts), torch.from_numpy(valid), th)
    return want, got


def _assert_same(want, got):
    assert got.keep.dtype == torch.bool and got.winner.dtype == torch.int32
    np.testing.assert_array_equal(got.keep.numpy(), np.asarray(want.keep))
    np.testing.assert_array_equal(got.winner.numpy(), np.asarray(want.winner))


@pytest.mark.parametrize("seed", range(6))
def test_nms_random_matches_jax(seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(1, 17))
    t = rng.normal(0.0, 60.0, (k, 3)).astype(np.float32)
    dist = rng.uniform(0.1, 5.0, k).astype(np.float32)
    npts = rng.integers(100, 2000, k).astype(np.int32)
    valid = rng.random(k) < 0.8
    _assert_same(*_both(t, dist, npts, valid, 50.0))


@pytest.mark.parametrize("seed", range(4))
def test_nms_planted_clusters_match_jax(seed):
    """Three tight clusters in shuffled order, a chain whose members are
    near the moving winner but not the seed, and equal icp_dist ties."""
    rng = np.random.default_rng(100 + seed)
    centers = np.array([[0, 0, 600], [200, 0, 600], [0, 300, 800]],
                       np.float32)
    t = np.concatenate([c + rng.normal(0.0, 8.0, (4, 3)) for c in centers]
                       + [np.array([[400, 0, 600], [440, 0, 600],
                                    [480, 0, 600]])]).astype(np.float32)
    dist = rng.choice(np.float32([0.5, 0.5, 1.0, 2.0]), t.shape[0])
    dist[-2] = 0.25                       # the chain's winner moves once
    npts = rng.integers(800, 1000, t.shape[0]).astype(np.int32)
    npts[1] = 10                          # fails the 85% gate
    valid = np.ones(t.shape[0], bool)
    valid[5] = False
    order = rng.permutation(t.shape[0])
    want, got = _both(t[order], dist[order].astype(np.float32), npts[order],
                      valid[order], 50.0)
    _assert_same(want, got)
    assert int(got.keep.sum()) >= 4


def test_nms_all_tied_collapse_to_first():
    """Eight identical candidates with equal icp_dist (the fixture scene's
    top-8): one cluster, seeded and won by index 0."""
    t = np.tile(np.float32([[-3.75, -3.58, -2.1]]), (8, 1))
    dist = np.full(8, 0.383, np.float32)
    npts = np.full(8, 16384, np.int32)
    want, got = _both(t, dist, npts, np.ones(8, bool), 50.0)
    _assert_same(want, got)
    assert got.keep.tolist() == [True] + [False] * 7
    assert int(got.winner[0]) == 0
