"""The port's parallel layer (``fealess_tpu_torch.parallel``) held against
the JAX layer on the CPU.

The JAX side runs as tests/test_parallel.py runs it, on the 8-device
virtual CPU mesh of tests/conftest.py, its first n devices for n shards.
The port side runs n gloo processes on the CPU with ``device="cpu"``, so
the kernels' plain twins run; this file, run as a script, is the worker:

    python tests/test_torch_parallel.py ranks DIR RANK WORLD
    python tests/test_torch_parallel.py multihost DIR

Inputs are made once from seeds in the test process and handed to the
workers as ``DIR/inputs.npz`` (+ the configs in ``DIR/inputs.json``); each
worker writes its results to ``DIR/<run>_<rank>.npz``.  The ``ranks``
groups meet through a ``file://`` store in DIR (no TCP port to race for
under xdist); the ``multihost`` run joins through
``multihost.initialize`` and the ``FEALESS_*`` variables, over TCP.  The
workers import torch, numpy and the port only, and check that nothing of
JAX was loaded.  World-size-1 runs happen in this process.
"""

import dataclasses
import datetime
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:          # run as a script, sys.path[0] is tests/
    sys.path.insert(0, REPO)

from fealess_tpu_torch import config as cfg  # noqa: E402
from fealess_tpu_torch import detector as det_mod  # noqa: E402
from fealess_tpu_torch import icp as icp_mod  # noqa: E402
from fealess_tpu_torch import pipeline, training  # noqa: E402
from fealess_tpu_torch.bank import (bank_arrays, bank_from_numpy,  # noqa: E402
                                    pack_bank)
from fealess_tpu_torch.io import linemod_yaml  # noqa: E402
from fealess_tpu_torch.io.png import read_png  # noqa: E402
from fealess_tpu_torch.parallel import batch_recon  # noqa: E402
from fealess_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from fealess_tpu_torch.parallel import multihost  # noqa: E402
from fealess_tpu_torch.parallel import sharded_icp, sharded_match  # noqa: E402

torch.set_num_threads(1)

TIMEOUT = datetime.timedelta(seconds=60)   # every process group's
WAIT_S = 300                               # every worker's communicate()
H, W = 160, 240                            # make_scene's frame
THRESHOLD = 75.0
FIXTURE = os.path.join(REPO, "benchmarks", "reference", "out")
N_SLOTS = 128                              # bench.py's fixture prefix
BANKS = ("scene", "fixture")
ICP_CASES = ("point", "plane", "point_few", "plane_few")
FIELDS = ("x", "y", "similarity", "template_slot", "class_idx",
          "template_idx", "valid")
RANK_RUNS = (2, 4)


# -- inputs (test process) ---------------------------------------------


def _scene(rng):
    """tests/test_match_e2e.make_scene (imported there with JAX)."""
    from tests.test_match_e2e import make_scene
    return make_scene(rng)


def _icp_clouds(case: str):
    """(ref, model, mask, normals) (P, 3) f32 / (P,) bool of one ICP case:
    ``point`` the clouds of test_parallel.py:64-75, ``plane`` the bowl of
    test_icp_plane.py:134-161, and ``*_few`` clouds whose NN pairs after
    the first iteration are all gated out (each model point 10 mm from
    its own reference point in a random direction, references 100 mm
    apart), so the loop stops for too few correspondences."""
    from tests.test_icp_plane import _bowl_surface, _rot
    from fealess_tpu import icp as jax_icp
    rng = np.random.default_rng(0)
    cap = 1024
    if case == "point":
        pts = rng.normal(size=(500, 3)).astype(np.float32) * [50, 40, 10]
        pts[:, 2] += 600
        r = np.array([[0.999, -0.035, 0.0], [0.035, 0.999, 0.0],
                      [0, 0, 1.0]], np.float32)
        model = pts @ r + np.array([5.0, -3.0, 2.0], np.float32)
        normals = np.zeros_like(pts)
    elif case == "plane":
        pts, normals = _bowl_surface(rng, n=32)
        r_true = _rot([1.0, 0.1, 0.4], 2.5)
        t_true = np.array([4.0, -2.0, 3.0], np.float32)
        centroid = pts.mean(axis=0)
        model = (pts - centroid) @ r_true + centroid - r_true.T @ t_true
    else:
        gx, gy = np.meshgrid(np.arange(16) * 100.0, np.arange(16) * 100.0)
        pts = np.stack([gx.ravel() - 750, gy.ravel() - 750,
                        600 + rng.normal(size=256) * 5], 1)
        step = rng.normal(size=(256, 3))
        model = pts + 10.0 * step / np.linalg.norm(step, axis=1,
                                                   keepdims=True)
        normals = rng.normal(size=(256, 3))
        normals /= np.linalg.norm(normals, axis=1, keepdims=True)
        cap = 256
    ref, mask = jax_icp.pad_cloud(pts, np.ones(len(pts), bool), cap)
    model, _ = jax_icp.pad_cloud(model, np.ones(len(model), bool), cap)
    nrm = np.zeros((cap, 3), np.float32)
    nrm[:len(normals)] = normals
    return ref, model, mask, nrm


def _icp_config(case: str) -> cfg.IcpConfig:
    if case == "point":
        return cfg.IcpConfig(max_iterations=15)
    if case == "plane":
        return cfg.IcpConfig(mode="point_to_plane", max_iterations=8,
                             dist_mean_threshold=0.01,
                             dist_diff_threshold=1e-6)
    return cfg.IcpConfig(mode="point_to_plane" if case == "plane_few"
                         else "point_to_point", max_iterations=10,
                         dist_mean_threshold=0.0,
                         dist_diff_threshold=-1e30)


def _batch_frames(bgr, depth):
    """4 frames: the scene, and the scene rolled three ways."""
    shifts = ((0, 0), (0, 10), (-6, 0), (5, -8))
    return (np.stack([np.roll(bgr, s, (0, 1)) for s in shifts]),
            np.stack([np.roll(depth, s, (0, 1)) for s in shifts]).astype(
                np.int32))


def _make_inputs(d: str) -> None:
    """Every input of both sides, written to DIR/inputs.{npz,json}."""
    bgr, depth, mask = _scene(np.random.default_rng(7))
    det = cfg.DetectorConfig(image_width=W, image_height=H, max_candidates=8)
    v1 = training.add_template(bgr, depth, mask,
                               np.arange(13, dtype=np.float32), det, "cpu")
    small = np.zeros_like(mask)
    small[56:104, 88:168] = True
    v2 = training.add_template(bgr, depth, small,
                               np.arange(13, dtype=np.float32) + 1, det,
                               "cpu")
    # two classes whose template_idx values collide (0, 1 in both): the
    # merge's ties fall back to the rank order of the shards' lists
    banks = {"scene": pack_bank({"a": [v1, v2, v1], "b": [v1, v2]},
                                levels=2, capacity=8, device="cpu")}
    fdet, classes = linemod_yaml.load_linemod(
        os.path.join(FIXTURE, "features", "linemod_templates.yml"))
    banks["fixture"] = pack_bank({"obj": classes["obj"][:N_SLOTS]},
                                 levels=2, capacity=N_SLOTS, device="cpu")
    arrays = {}
    for name, bank in banks.items():
        arrays.update({f"bank_{name}_{k}": v
                       for k, v in bank_arrays(bank).items()})
    arrays.update(frame_scene_bgr=bgr, frame_scene_depth=depth.astype(
        np.int32))
    arrays["frame_fixture_bgr"] = read_png(os.path.join(FIXTURE,
                                                        "scene_bgr.png"))
    arrays["frame_fixture_depth"] = read_png(os.path.join(
        FIXTURE, "scene_depth.png")).astype(np.int32)
    for case in ICP_CASES:
        for k, v in zip(("ref", "model", "mask", "normals"),
                        _icp_clouds(case)):
            arrays[f"icp_{case}_{k}"] = v
    arrays["batch_bgr"], arrays["batch_depth"] = _batch_frames(bgr, depth)
    rng = np.random.default_rng(1)
    arrays["md"] = rng.integers(400, 880, size=(8, 96, 96)).astype(np.int32)
    arrays["org"] = np.zeros((8, 2), np.int32)
    arrays["scene_k"] = np.array([[608.0, 0, W / 2], [0, 608.0, H / 2],
                                  [0, 0, 1]], np.float32)
    engine = cfg.EngineConfig(detector=det, refine_crop=96,
                              icp=cfg.IcpConfig(max_points=2048),
                              template_fx=608.0, template_fy=608.0,
                              template_cx=W / 2.0, template_cy=H / 2.0)
    conf = {"det_scene": cfg.detector_to_dict(det),
            "det_fixture": cfg.detector_to_dict(fdet),
            "engine": dataclasses.asdict(engine),
            "icp": {c: dataclasses.asdict(_icp_config(c))
                    for c in ICP_CASES},
            "banks": {n: {"class_names": list(b.class_names),
                          "max_span": b.max_span} for n, b in banks.items()}}
    np.savez(os.path.join(d, "inputs.npz"), **arrays)
    with open(os.path.join(d, "inputs.json"), "w") as f:
        json.dump(conf, f)


# -- both sides' readers ------------------------------------------------


def _load(d: str):
    with open(os.path.join(d, "inputs.json")) as f:
        conf = json.load(f)
    return dict(np.load(os.path.join(d, "inputs.npz"))), conf


def _bank(inp, conf, name):
    meta = conf["banks"][name]
    return bank_from_numpy({k[len(f"bank_{name}_"):]: v
                            for k, v in inp.items()
                            if k.startswith(f"bank_{name}_")},
                           meta["class_names"], meta["max_span"], "cpu")


def _flat(prefix: str, tree) -> dict:
    """A dataclass tree's tensor leaves as numpy, keyed by field path
    (other leaves, such as class names, are left out)."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.numpy()}
    if not dataclasses.is_dataclass(tree):
        return {}
    out = {}
    for f in dataclasses.fields(tree):
        out.update(_flat(f"{prefix}.{f.name}", getattr(tree, f.name)))
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _icp_run(fn_pair, inp, conf, case, *extra):
    """One ICP case through ``fn_pair`` = (point fn, plane fn)."""
    ic = cfg.IcpConfig(**conf["icp"][case])
    ref, model, mask, nrm = (_t(inp[f"icp_{case}_{k}"])
                             for k in ("ref", "model", "mask", "normals"))
    if ic.mode == "point_to_plane":
        return fn_pair[1](ref, nrm, model, mask, ic, *extra)
    return fn_pair[0](ref, model, mask, ic, *extra)


# -- workers ------------------------------------------------------------


def _check_no_jax() -> None:
    bad = sorted(m for m in sys.modules
                 if m in ("jax", "flax", "fealess_tpu")
                 or m.startswith(("jax.", "flax.", "fealess_tpu.")))
    if bad:
        raise RuntimeError(f"the port's parallel layer loaded {bad[:5]}")


def _worker_ranks(d: str, rank: int, world: int) -> None:
    dist.init_process_group("gloo", init_method=f"file://{d}/store{world}",
                            rank=rank, world_size=world, timeout=TIMEOUT)
    inp, conf = _load(d)
    out = {}
    t_mesh = mesh_mod.make_mesh([("t", world)], "cpu")
    for name in BANKS:
        det = cfg.detector_from_dict(conf[f"det_{name}"])
        m = sharded_match.match_bank_sharded(
            _bank(inp, conf, name), _t(inp[f"frame_{name}_bgr"]),
            _t(inp[f"frame_{name}_depth"]), THRESHOLD, det, t_mesh)
        out.update(_flat(f"match_{name}", m))
    p_mesh = mesh_mod.make_mesh([("p", world)], "cpu")
    pair = (sharded_icp.icp_sharded, sharded_icp.icp_plane_sharded)
    for case in ICP_CASES:
        out.update(_flat(f"icp_{case}",
                         _icp_run(pair, inp, conf, case, p_mesh)))
    # an odd cloud is refused on every rank before any collective
    try:
        sharded_icp.icp_sharded(_t(inp["icp_point_ref"][:1021]),
                                _t(inp["icp_point_model"][:1021]),
                                _t(inp["icp_point_mask"][:1021]),
                                cfg.IcpConfig(), p_mesh)
        out["odd_refused"] = np.array(False)
    except ValueError:
        out["odd_refused"] = np.array(True)
    engine = cfg.engine_from_dict(conf["engine"])
    bank = _bank(inp, conf, "scene")
    if world == 2:
        d_mesh = mesh_mod.make_mesh([("d", world)], "cpu")
        step = batch_recon.recognize_batch_sharded(
            bank, _t(inp["md"]), _t(inp["org"]), _t(inp["batch_bgr"]),
            _t(inp["batch_depth"]), _t(inp["scene_k"]), engine, d_mesh)
        out.update(_flat("batch", step))
    else:
        mesh2 = mesh_mod.make_mesh([("d", 2), ("t", -1)], "cpu")
        m = batch_recon.match_batch_2d(
            bank, _t(inp["batch_bgr"][:2]), _t(inp["batch_depth"][:2]),
            THRESHOLD, engine.detector, mesh2)
        out.update(_flat("match2d", m))
    dist.destroy_process_group()
    _check_no_jax()
    np.savez(os.path.join(d, f"ranks{world}_{rank}.npz"), **out)


def _worker_multihost(d: str) -> None:
    dev = multihost.initialize(device="cpu", timeout=TIMEOUT)
    rank, world = dist.get_rank(), dist.get_world_size()
    assert dist.get_backend() == "gloo" and dev.type == "cpu"
    inp, conf = _load(d)
    mesh = multihost.global_mesh("d", device_type="cpu")
    local_b = inp["batch_bgr"].shape[0] // world
    mine = slice(rank * local_b, (rank + 1) * local_b)
    frames, offset = multihost.feed_local_batch(
        mesh, {"bgr": inp["batch_bgr"][mine],
               "depth": inp["batch_depth"][mine]})
    # only process 0 holds the real bank and model depths; replicate
    # must hand them to the others
    bank = _bank(inp, conf, "scene")
    state = {"md": inp["md"], "org": inp["org"]}
    if rank:
        bank = mesh_mod.tree_map(torch.zeros_like, bank)
        state = {k: np.zeros_like(v) for k, v in state.items()}
    bank = multihost.replicate(mesh, bank)
    state = multihost.replicate(mesh, state)
    step = batch_recon.recognize_batch(
        bank, state["md"], state["org"], frames["bgr"], frames["depth"],
        _t(inp["scene_k"]), cfg.engine_from_dict(conf["engine"]))
    out = _flat("batch", step)
    out["offset"] = np.array(offset)
    out["bank_equal"] = np.array(all(
        np.array_equal(v, inp[f"bank_scene_{k}"])
        for k, v in bank_arrays(bank).items()))
    dist.destroy_process_group()
    _check_no_jax()
    np.savez(os.path.join(d, f"multihost_{rank}.npz"), **out)


# -- the test process ---------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Runs:
    """The worker processes, started together; ``result`` waits for all
    of them once, then reads one rank's results."""

    def __init__(self, d: str):
        self.d = d
        me = os.path.abspath(__file__)
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.procs = {}
        for world in RANK_RUNS:
            for rank in range(world):
                self.procs[f"ranks{world}_{rank}"] = subprocess.Popen(
                    [sys.executable, me, "ranks", d, str(rank), str(world)],
                    env=env, cwd=REPO, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)
        env.update(FEALESS_COORDINATOR=f"127.0.0.1:{_free_port()}",
                   FEALESS_NUM_PROCESSES="2")
        for rank in range(2):
            self.procs[f"multihost_{rank}"] = subprocess.Popen(
                [sys.executable, me, "multihost", d],
                env=dict(env, FEALESS_PROCESS_ID=str(rank)), cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.outs = None

    def wait(self):
        if self.outs is None:
            self.outs = {k: p.communicate(timeout=WAIT_S)[0]
                         for k, p in self.procs.items()}
        return self.outs

    def result(self, name: str) -> dict:
        out = self.wait()[name]
        assert self.procs[name].returncode == 0, f"{name}:\n{out[-3000:]}"
        return dict(np.load(os.path.join(self.d, f"{name}.npz")))

    def close(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("parallel"))
    _make_inputs(d)
    return d


@pytest.fixture(scope="module", autouse=True)
def runs(workdir):
    r = _Runs(workdir)
    yield r
    r.close()


@pytest.fixture(scope="module")
def jax_side(workdir):
    """JAX's inputs: the same arrays, the JAX configs and banks."""
    import jax.numpy as jnp
    from fealess_tpu import config as jax_cfg
    from fealess_tpu.bank import TemplateBank as JaxBank

    def to_jax(c):
        if dataclasses.is_dataclass(c):
            return getattr(jax_cfg, type(c).__name__)(**{
                f.name: to_jax(getattr(c, f.name))
                for f in dataclasses.fields(c)})
        return c

    inp, conf = _load(workdir)
    banks = {}
    for name in BANKS:
        pb = _bank(inp, conf, name)
        banks[name] = JaxBank(
            **{k: jnp.asarray(v) for k, v in bank_arrays(pb).items()},
            class_names=pb.class_names, max_span=pb.max_span)
    dets = {n: to_jax(cfg.detector_from_dict(conf[f"det_{n}"]))
            for n in BANKS}
    return {"inp": inp, "conf": conf, "banks": banks, "dets": dets,
            "engine": to_jax(cfg.engine_from_dict(conf["engine"])),
            "icp": {c: to_jax(cfg.IcpConfig(**conf["icp"][c]))
                    for c in ICP_CASES}, "to_jax": to_jax}


def _jax_mesh(axes):
    import jax
    from fealess_tpu.parallel import mesh as jax_mesh
    n = int(np.prod([s for _, s in axes]))
    return jax_mesh.make_mesh(axes, jax.devices()[:n])


def _assert_matches_equal(port: dict, prefix: str, ref, rows=None):
    for f in FIELDS:
        got = port[f"{prefix}.{f}"]
        want = np.asarray(getattr(ref, f))
        if rows is not None:
            want = want[rows]
        assert got.dtype == want.dtype, (f, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f"{prefix}.{f}")


@pytest.mark.parametrize("world", RANK_RUNS)
@pytest.mark.parametrize("name", BANKS)
def test_sharded_match_equals_jax(runs, jax_side, name, world):
    """Every Matches field exactly as JAX's at the same shard count; the
    scene bank's two classes share template_idx values, so the merge's
    ties fall back to the shards' rank order."""
    import jax
    import jax.numpy as jnp
    from fealess_tpu.parallel import sharded_match as jax_sm
    det, bank = jax_side["dets"][name], jax_side["banks"][name]
    inp = jax_side["inp"]
    mesh = _jax_mesh([("t", world)])
    ref = jax.jit(lambda b, i, d: jax_sm.match_bank_sharded(
        b, i, d, THRESHOLD, det, mesh))(
            bank, jnp.asarray(inp[f"frame_{name}_bgr"]),
            jnp.asarray(inp[f"frame_{name}_depth"]))
    assert np.asarray(ref.valid).any()
    for rank in range(world):
        _assert_matches_equal(runs.result(f"ranks{world}_{rank}"),
                              f"match_{name}", ref)
    if name == "scene":
        # the tie the bank was built for: slots 0 and 3 (class a and b,
        # both template 0) at one position, in rank order
        slots = np.asarray(ref.template_slot)[np.asarray(ref.valid)]
        assert list(slots[:2]) == [0, 3], slots


def test_match_batch_2d_equals_jax(runs, jax_side):
    """(d=2, t=2) frame x template mesh over 2 frames: every field exactly
    as JAX's on the same mesh shape, on every rank."""
    import jax
    import jax.numpy as jnp
    from fealess_tpu.parallel import batch_recon as jax_br
    inp = jax_side["inp"]
    mesh = _jax_mesh([("d", 2), ("t", 2)])
    det = jax_side["engine"].detector
    ref = jax.jit(lambda b, i, d: jax_br.match_batch_2d(
        b, i, d, THRESHOLD, det, mesh))(
            jax_side["banks"]["scene"], jnp.asarray(inp["batch_bgr"][:2]),
            jnp.asarray(inp["batch_depth"][:2]))
    assert np.asarray(ref.valid).any(axis=1).all()
    for rank in range(4):
        _assert_matches_equal(runs.result(f"ranks4_{rank}"), "match2d", ref)


def _jax_icp(jax_side, case, mesh):
    import jax
    import jax.numpy as jnp
    from fealess_tpu.parallel import sharded_icp as jax_si
    inp, ic = jax_side["inp"], jax_side["icp"][case]
    ref, model, mask, nrm = (jnp.asarray(inp[f"icp_{case}_{k}"])
                             for k in ("ref", "model", "mask", "normals"))
    if ic.mode == "point_to_plane":
        return jax.jit(lambda r, n, m, k: jax_si.icp_plane_sharded(
            r, n, m, k, ic, mesh))(ref, nrm, model, mask)
    return jax.jit(lambda r, m, k: jax_si.icp_sharded(
        r, m, k, ic, mesh))(ref, model, mask)


@pytest.mark.parametrize("world", RANK_RUNS)
@pytest.mark.parametrize("case", ICP_CASES)
def test_sharded_icp_equals_jax(runs, jax_side, case, world):
    """Point- and plane-mode sharded ICP against JAX's at the same shard
    count: r within 1e-5, t within 1e-3 mm, iterations and ok equal
    (test_parallel.py:80-84's tolerance).  The ``*_few`` cases stop in
    the loop for too few correspondences, on every rank at once."""
    ref = _jax_icp(jax_side, case, _jax_mesh([("p", world)]))
    want_it = int(ref.iterations)
    if case.endswith("_few"):
        assert want_it == jax_side["icp"][case].max_iterations
    for rank in range(world):
        got = runs.result(f"ranks{world}_{rank}")
        np.testing.assert_allclose(got[f"icp_{case}.r"], np.asarray(ref.r),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(got[f"icp_{case}.t"], np.asarray(ref.t),
                                   atol=1e-3, rtol=0)
        assert int(got[f"icp_{case}.iterations"]) == want_it
        assert bool(got[f"icp_{case}.ok"]) == bool(ref.ok)
        assert bool(got["odd_refused"])


def _assert_steps_close(port: dict, ref, rows=slice(None)):
    """RecoStep: similarity within 1e-4 and pose within 1e-2
    (test_parallel.py:110-113), match x, y, slot and valid exact."""
    np.testing.assert_allclose(port["batch.similarity"],
                               np.asarray(ref.similarity)[rows], atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(port["batch.pose"], np.asarray(ref.pose)[rows],
                               atol=1e-2, rtol=0)
    for f in ("match_x", "match_y", "template_slot", "valid"):
        np.testing.assert_array_equal(port[f"batch.{f}"],
                                      np.asarray(getattr(ref, f))[rows],
                                      err_msg=f)


def test_batch_sharded_equals_jax(runs, jax_side):
    """Frame-sharded batch Recognition over 4 frames at 2 ranks against
    JAX's on a 2-device mesh; every rank holds the whole batch."""
    import jax
    import jax.numpy as jnp
    from fealess_tpu.parallel import batch_recon as jax_br
    inp, engine = jax_side["inp"], jax_side["engine"]
    mesh = _jax_mesh([("d", 2)])
    args = [jnp.asarray(inp[k]) for k in ("md", "org", "batch_bgr",
                                          "batch_depth", "scene_k")]
    ref = jax.jit(lambda *a: jax_br.recognize_batch_sharded(
        *a, engine, mesh))(jax_side["banks"]["scene"], *args)
    assert np.asarray(ref.valid).all()
    for rank in range(2):
        _assert_steps_close(runs.result(f"ranks2_{rank}"), ref)


@pytest.mark.parametrize("rank", [0, 1])
def test_multihost_equals_jax(runs, jax_side, rank):
    """Two processes joined by ``multihost.initialize`` from the
    ``FEALESS_*`` variables (TCP, gloo): each feeds its own 2 frames, takes
    the bank and model depths from process 0 (``replicate``) and runs
    ``recognize_batch``; its rows equal JAX's ``recognize_batch`` on those
    frames (the mirror of tests/multihost_worker.py)."""
    import jax
    import jax.numpy as jnp
    from fealess_tpu.parallel import batch_recon as jax_br
    inp, engine = jax_side["inp"], jax_side["engine"]
    args = [jnp.asarray(inp[k]) for k in ("md", "org", "batch_bgr",
                                          "batch_depth", "scene_k")]
    ref = jax.jit(lambda *a: jax_br.recognize_batch(*a, engine))(
        jax_side["banks"]["scene"], *args)
    got = runs.result(f"multihost_{rank}")
    assert int(got["offset"]) == 2 * rank
    assert bool(got["bank_equal"])
    _assert_steps_close(got, ref, slice(2 * rank, 2 * rank + 2))


@pytest.mark.parametrize("world", RANK_RUNS)
def test_every_rank_returns_the_same(runs, world):
    """Every rank of a run returns bit-identical results."""
    first = runs.result(f"ranks{world}_0")
    for rank in range(1, world):
        other = runs.result(f"ranks{world}_{rank}")
        assert other.keys() == first.keys()
        for k, v in first.items():
            assert v.tobytes() == other[k].tobytes(), (rank, k)


# -- world size 1, in this process --------------------------------------


@pytest.fixture(scope="module")
def world1(workdir):
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store1",
                            rank=0, world_size=1, timeout=TIMEOUT)
    yield _load(workdir)
    dist.destroy_process_group()


def _bitwise(a, b):
    """Two dataclass trees with bit-identical tensor leaves."""
    fa, fb = _flat("", a), _flat("", b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].tobytes() == \
            fb[k].tobytes(), k


def test_world1_match_is_the_merged_single_device_match(world1):
    """One shard is the whole bank: the sharded match is exactly
    ``_merge_matches`` of ``detector.match_bank``, and its valid entries'
    top one is match_bank's.  (The merge scores match_bank's duplicates
    -inf and moves them last, so the two lists are not equal field by
    field.)"""
    inp, conf = world1
    det = cfg.detector_from_dict(conf["det_scene"])
    bank = _bank(inp, conf, "scene")
    bgr, depth = _t(inp["frame_scene_bgr"]), _t(inp["frame_scene_depth"])
    got = sharded_match.match_bank_sharded(
        bank, bgr, depth, THRESHOLD, det, mesh_mod.template_mesh(
            device_type="cpu"))
    single = det_mod.match_bank(bank, bgr, depth, THRESHOLD, det)
    _bitwise(got, sharded_match._merge_matches(single, det.max_candidates))
    for f in FIELDS:
        assert getattr(got, f)[0] == getattr(single, f)[0], f
    fn = sharded_match.jit_match_sharded(
        mesh_mod.make_mesh([("t", 1)], "cpu"), det, THRESHOLD)
    _bitwise(fn(bank, bgr, depth), got)


@pytest.mark.parametrize("case", ICP_CASES)
def test_world1_icp_is_single_device(world1, case):
    """At one process the sharded ICP is the single-device ICP, bitwise."""
    inp, conf = world1
    mesh = mesh_mod.make_mesh([("p", -1)], "cpu")
    got = _icp_run((sharded_icp.icp_sharded, sharded_icp.icp_plane_sharded),
                   inp, conf, case, mesh)
    single = (icp_mod.icp_point_to_point, icp_mod.icp_point_to_plane)
    want = _icp_run(single, inp, conf, case)
    _bitwise(got, want)
    if case.endswith("_few"):
        # the loop ran 1 iteration and aborted in the 2nd: the pose is the
        # one-iteration pose, while iterations reads the cap
        conf["icp"][case]["max_iterations"] = 1
        once = _icp_run(single, inp, conf, case)
        conf["icp"][case]["max_iterations"] = 10
        assert int(want.iterations) == 10 and int(once.iterations) == 1
        assert torch.equal(want.r, once.r) and torch.equal(want.t, once.t)
        assert not torch.equal(want.r, torch.eye(3))


def test_world1_batch_is_single_device(world1):
    """``recognize_batch_sharded`` at one process is ``recognize_top1``
    frame by frame, bitwise."""
    inp, conf = world1
    bank = _bank(inp, conf, "scene")
    engine = cfg.engine_from_dict(conf["engine"])
    fixed = [_t(inp[k]) for k in ("md", "org")]
    bgr, depth = _t(inp["batch_bgr"]), _t(inp["batch_depth"])
    got = batch_recon.recognize_batch_sharded(
        bank, *fixed, bgr, depth, _t(inp["scene_k"]), engine,
        mesh_mod.make_mesh([("d", 1)], "cpu"))
    want = mesh_mod.stack_tree([pipeline.recognize_top1(
        bank, *fixed, bgr[i], depth[i], _t(inp["scene_k"]), engine)
        for i in range(bgr.shape[0])])
    _bitwise(got, want)


def test_world1_match_batch_2d_is_single_device(world1):
    """``match_batch_2d`` on a (1, 1) mesh is the merged ``match_bank`` of
    each frame, bitwise."""
    inp, conf = world1
    bank = _bank(inp, conf, "scene")
    det = cfg.detector_from_dict(conf["det_scene"])
    bgr, depth = _t(inp["batch_bgr"]), _t(inp["batch_depth"])
    got = batch_recon.match_batch_2d(
        bank, bgr, depth, THRESHOLD, det,
        mesh_mod.make_mesh([("d", 1), ("t", 1)], "cpu"))
    tables = det_mod.build_match_tables(bank, det)
    want = mesh_mod.stack_tree([sharded_match._merge_matches(
        det_mod.match_bank(bank, bgr[i], depth[i], THRESHOLD, det,
                           kernels=tables), det.max_candidates)
        for i in range(bgr.shape[0])])
    _bitwise(got, want)


def test_world1_mesh_feed_and_replicate(world1):
    """Mesh sizes that do not fit the world are refused; at one process
    ``feed_local_batch`` gives offset 0 and ``replicate`` the tree
    itself."""
    inp, conf = world1
    with pytest.raises(ValueError):
        mesh_mod.make_mesh([("t", 3)], "cpu")
    mesh = mesh_mod.make_mesh([("d", -1)], "cpu")
    frames, offset = multihost.feed_local_batch(
        mesh, {"bgr": inp["batch_bgr"]})
    assert offset == 0 and torch.equal(frames["bgr"], _t(inp["batch_bgr"]))
    bank = _bank(inp, conf, "scene")
    got = multihost.replicate(mesh, bank)
    assert got.class_names == bank.class_names
    _bitwise(got, bank)


if __name__ == "__main__":
    if sys.argv[1] == "ranks":
        _worker_ranks(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    else:
        _worker_multihost(sys.argv[2])
    print(f"worker {' '.join(sys.argv[1:])} ok", flush=True)
