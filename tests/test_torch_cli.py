"""The port's command line (``python -m fealess_tpu_torch``, here with
``--device cpu``) against the JAX package's CLI on the same scan package:
``train`` writes the same database; ``recon`` (both ICP modes and
``--multi``), ``recon --artifact`` after ``export``, ``track`` and ``eval``
print the JAX CLI's JSON lines: frames, objects and similarity exactly,
poses within 0.05 mm and 0.01 deg, tracker ROIs within 0.05 px.  A
subprocess drives every action with the new modules imported and shows
that jax, flax, cv2 and the JAX package are never loaded."""

import json
import os
import shutil
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from fealess_tpu.apps import cli as jax_cli
from fealess_tpu_torch.apps import cli
from tests.test_torch_engine import T_TOL_MM, _rot_diff_deg
from tests.make_torch_ckpt import OUT as CKPT
from tests.test_torch_io import LOADED, adam7_png, bad_plte_png
from tests.test_torch_scan_package import write_package

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECON = ["--refine-crop", "128", "--icp-max-points", "8192"]
ROI_TOL_PX = 0.05
DIST_ATOL_MM = 1e-3


def _write_cube_obj(path, half=30.0):
    with open(path, "w") as fh:
        for sx in (-1, 1):
            for sy in (-1, 1):
                for sz in (-1, 1):
                    fh.write(f"v {sx * half} {sy * half} {sz * half}\n")
        fh.write("f 1 2 3\nf 5 6 7\nf 1 2 5\nf 3 4 7\n")


def _run(main, argv, capsys):
    """(return code, JSON lines of stdout, other stdout lines, stderr)."""
    rc = main(argv)
    cap = capsys.readouterr()
    lines = cap.out.splitlines()
    return (rc, [json.loads(ln) for ln in lines if ln.startswith("{")],
            [ln for ln in lines if not ln.startswith("{")], cap.err)


def _capture(main, argv):
    """(return code, stdout lines) of one in-process CLI call (module-scoped
    fixtures cannot use the function-scoped capsys)."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = main(argv)
    return rc, out.getvalue().splitlines()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One package (with a cube model for eval), copied once per CLI:
    {"port": dir, "jax": dir}."""
    src = str(tmp_path_factory.mktemp("pkg"))
    write_package(src)
    _write_cube_obj(os.path.join(src, "model.obj"))
    out = {}
    for name in ("port", "jax"):
        out[name] = os.path.join(str(tmp_path_factory.mktemp(name)), "pkg")
        shutil.copytree(src, out[name])
    return out


@pytest.fixture(scope="module")
def corrupt_series(trained, tmp_path_factory):
    """A recon series of the package's 3 frames and copies of frame 0 as
    frames 3 and 4, with frame 1's colour PNG cut in half, frame 2's depth
    PNG replaced by bytes that are no PNG and frame 4's colour PNG by a
    palette PNG whose PLTE length is no multiple of 3."""
    d = str(tmp_path_factory.mktemp("series"))
    for sub in ("gray", "depth"):
        os.makedirs(os.path.join(d, sub))
        for i in range(5):
            shutil.copy(os.path.join(trained["jax"], sub, f"{i % 3}.png"),
                        os.path.join(d, sub, f"{i}.png"))
    path = os.path.join(d, "gray", "1.png")
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:len(data) // 2])
    with open(os.path.join(d, "depth", "2.png"), "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + bytes(range(64)))
    h, w = cv2.imread(os.path.join(d, "depth", "0.png"),
                      cv2.IMREAD_UNCHANGED).shape
    with open(os.path.join(d, "gray", "4.png"), "wb") as f:
        f.write(bad_plte_png(h, w))
    return d


@pytest.fixture(scope="module")
def jax_lines(trained, corrupt_series):
    """The JAX CLI's train output and recon/track JSON lines on its copy."""
    d = trained["jax"]
    out = {"train": _capture(jax_cli.main, ["train", d])}
    for key, argv in (("plane", ["recon", d] + RECON),
                      ("point", ["recon", d, "--icp-mode",
                                 "point_to_point"] + RECON),
                      ("multi", ["recon", d, "--multi"] + RECON),
                      ("track", ["track", d] + RECON),
                      ("corrupt", ["recon", d, "--series", corrupt_series]
                       + RECON)):
        rc, lines = _capture(jax_cli.main, argv)
        assert rc == 0
        out[key] = [json.loads(ln) for ln in lines if ln.startswith("{")]
    return out


@pytest.fixture(scope="module")
def port_trained(trained):
    """The port's copy, trained by the port's CLI; (dir, train output)."""
    d = trained["port"]
    return d, _capture(cli.main, ["train", d, "--device", "cpu"])


def _same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["obj"] == w["obj"]
        assert g["similarity"] == w["similarity"]
        pg, pw = np.asarray(g["pose"]), np.asarray(w["pose"])
        assert pg.shape == pw.shape == (4, 4)
        np.testing.assert_allclose(pg[:3, 3], pw[:3, 3], atol=T_TOL_MM,
                                   rtol=0)
        assert _rot_diff_deg(pg[:3, :3], pw[:3, :3]) <= 0.01
        if "icp_dist" in w:
            np.testing.assert_allclose(g["icp_dist"], w["icp_dist"],
                                       atol=DIST_ATOL_MM, rtol=0)


def _same_lines(got, want):
    assert [g["frame"] for g in got] == [w["frame"] for w in want]
    for g, w in zip(got, want):
        _same_results(g["results"], w["results"])


def test_cli_train_matches_jax(port_trained, trained, jax_lines):
    """train on two copies of one package: the same per-frame report, the
    same 3/3 count and the same database bytes."""
    d, (rc, text) = port_trained
    rc_w, text_w = jax_lines["train"]
    assert rc == rc_w == 0
    assert text[:-1] == text_w[:-1] and len(text) == 4
    assert text[-1] == f"Training: 3/3 frames -> {d}/linemod_templates.yml"
    with open(os.path.join(d, "linemod_templates.yml"), "rb") as a, \
            open(os.path.join(trained["jax"], "linemod_templates.yml"),
                 "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("key,flags", [
    ("plane", []), ("point", ["--icp-mode", "point_to_point"]),
    ("multi", ["--multi"])])
def test_cli_recon_matches_jax(port_trained, jax_lines, capsys, key, flags):
    rc, got, _, err = _run(cli.main, ["recon", port_trained[0], "--device",
                                      "cpu"] + flags + RECON, capsys)
    assert rc == 0 and "frames in" in err
    want = jax_lines[key]
    assert len(want) == 3 and all(w["results"] for w in want)
    _same_lines(got, want)


def test_cli_recon_skips_undecodable_frames(port_trained, jax_lines,
                                           corrupt_series, capsys):
    """A pair whose colour or depth PNG does not decode (cut, not a PNG, a
    bad PLTE) is skipped and the frame index counts on over it: the JAX
    CLI's lines, frames 0 and 3."""
    rc, got, _, err = _run(cli.main, ["recon", port_trained[0], "--series",
                                      corrupt_series, "--device", "cpu"]
                           + RECON, capsys)
    assert rc == 0 and "2 frames in" in err
    want = jax_lines["corrupt"]
    assert [w["frame"] for w in want] == [0, 3]
    _same_lines(got, want)


def test_cli_recon_refuses_interlaced_frame(port_trained, trained,
                                            jax_lines, tmp_path, capsys):
    """A series whose frame 1 colour PNG and frame 2 depth PNG are
    Adam7-interlaced, which cv2 (and so the JAX CLI) reads: every frame is
    recognised, and the lines equal the JAX CLI's.  (The name is kept from
    when the port refused such frames.)"""
    src = port_trained[0]
    for sub in ("gray", "depth"):
        os.makedirs(tmp_path / sub)
        for i in range(3):
            shutil.copy(os.path.join(src, sub, f"{i}.png"),
                        tmp_path / sub / f"{i}.png")
    bgr = cv2.imread(os.path.join(src, "gray", "1.png"))
    path = str(tmp_path / "gray" / "1.png")
    with open(path, "wb") as f:
        f.write(adam7_png(np.ascontiguousarray(bgr[:, :, ::-1]),
                          filters=[0, 1, 2, 3, 4]))
    np.testing.assert_array_equal(cv2.imread(path), bgr)
    depth = cv2.imread(os.path.join(src, "depth", "2.png"),
                       cv2.IMREAD_UNCHANGED)
    path = str(tmp_path / "depth" / "2.png")
    with open(path, "wb") as f:
        f.write(adam7_png(depth, filters=[1, 2]))
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED),
                                  depth)
    series = ["--series", str(tmp_path)] + RECON
    rc, lines = _capture(jax_cli.main, ["recon", trained["jax"]] + series)
    assert rc == 0
    want = [json.loads(ln) for ln in lines if ln.startswith("{")]
    rc, got, _, err = _run(cli.main, ["recon", src, "--device", "cpu"]
                           + series, capsys)
    assert rc == 0 and "3 frames in" in err
    assert [w["frame"] for w in want] == [0, 1, 2]
    assert all(w["results"] for w in want)
    _same_lines(got, want)


def test_cli_export_and_artifact_recon(port_trained, jax_lines, tmp_path,
                                       capsys):
    """export, then recon --artifact: the lines equal the port's recon
    lines exactly and the JAX CLI's within the tolerances; --multi with an
    artifact is refused as in JAX."""
    art = str(tmp_path / "artifact")
    rc, _, text, _ = _run(cli.main, ["export", port_trained[0], art, "--width",
                                     "240", "--height", "160", "--device",
                                     "cpu"] + RECON, capsys)
    assert rc == 0 and text == [f"artifact -> {art}"]
    rc, served, _, _ = _run(cli.main, ["recon", port_trained[0], "--artifact",
                                       art, "--device", "cpu"] + RECON,
                            capsys)
    assert rc == 0
    rc, direct, _, _ = _run(cli.main, ["recon", port_trained[0], "--device",
                                       "cpu"] + RECON, capsys)
    assert served == direct
    _same_lines(served, jax_lines["plane"])
    rc, _, _, err = _run(cli.main, ["recon", port_trained[0], "--artifact", art,
                                    "--multi", "--device", "cpu"], capsys)
    assert rc == 1 and "top-1" in err


def test_cli_track_matches_jax(port_trained, jax_lines, capsys):
    rc, got, _, _ = _run(cli.main, ["track", port_trained[0], "--device",
                                    "cpu"] + RECON, capsys)
    assert rc == 0
    want = jax_lines["track"]
    assert [(g["frame"], g["redetected"], g["tracking"]) for g in got] == \
        [(w["frame"], w["redetected"], w["tracking"]) for w in want]
    assert want[0]["redetected"] and not want[1]["redetected"]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["roi"], w["roi"], atol=ROI_TOL_PX,
                                   rtol=0)
        _same_results(g["results"], w["results"])


def test_cli_eval_matches_jax(port_trained, trained, jax_lines, tmp_path,
                              capsys):
    """eval of each CLI's recon lines against the package's poses."""
    summaries = []
    for main, d, lines, extra in (
            (cli.main, port_trained[0], None, ["--device", "cpu"]),
            (jax_cli.main, trained["jax"], jax_lines["plane"], [])):
        if lines is None:
            rc, lines, _, _ = _run(main, ["recon", d] + extra + RECON, capsys)
            assert rc == 0
        path = tmp_path / f"{len(summaries)}.jsonl"
        path.write_text("# comment\n" + "\n".join(json.dumps(ln)
                                                  for ln in lines) + "\n")
        rc, out, _, _ = _run(main, ["eval", d, str(path), "--model-scale",
                                    "1.0"], capsys)
        assert rc == 0 and len(out) == 1
        summaries.append(out[0])
    got, want = summaries
    assert got.keys() == want.keys()
    assert want["n_frames"] == 3 and want["detection_rate"] == 1.0
    for k in ("n_frames", "detection_rate", "add_pass_rate"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["mean_add"], want["mean_add"], atol=0.05)
    np.testing.assert_allclose(got["mean_trans_mm"], want["mean_trans_mm"],
                               atol=T_TOL_MM)
    np.testing.assert_allclose(got["mean_rot_deg"], want["mean_rot_deg"],
                               atol=0.01)


def test_cli_profile_report_and_refusals(port_trained, trained, jax_lines,
                                        tmp_path, capsys):
    """--profile prints the host stage report, whose decode row times the
    wait on the frame loader; an empty series returns 1; a colour frame of
    another size is resized to the first frame's, as the JAX CLI does, and
    the lines equal the JAX CLI's; --device defaults to cuda.  (The name
    is kept from when the port refused such frames.)"""
    rc, _, _, err = _run(cli.main, ["recon", port_trained[0], "--profile",
                                    "--device", "cpu"] + RECON, capsys)
    assert rc == 0
    assert "host-io(decode+wait)" in err and "recognition(+fetch)" in err
    assert _device_rows(err) == STAGE_ROWS
    empty = tmp_path / "empty"
    empty.mkdir()
    rc, _, _, err = _run(cli.main, ["recon", port_trained[0], "--series",
                                    str(empty), "--device", "cpu"], capsys)
    assert rc == 1 and "no frames" in err
    odd = str(tmp_path / "odd")
    shutil.copytree(port_trained[0], odd)
    from fealess_tpu_torch.io.png import read_png, write_png
    write_png(os.path.join(odd, "gray", "1.png"),
              read_png(os.path.join(odd, "gray", "1.png"))[:80])
    series = ["--series", odd] + RECON
    rc, lines = _capture(jax_cli.main, ["recon", trained["jax"]] + series)
    assert rc == 0
    want = [json.loads(ln) for ln in lines if ln.startswith("{")]
    rc, got, _, err = _run(cli.main, ["recon", port_trained[0], "--device",
                                      "cpu"] + series, capsys)
    assert rc == 0 and "3 frames in" in err
    assert [w["frame"] for w in want] == [0, 1, 2]
    _same_lines(got, want)
    args = cli.build_parser().parse_args(["recon", port_trained[0]])
    assert args.device == "cuda"


# the JAX CLI's device-stage rows (fealess_tpu/apps/cli.py _profile_stages)
STAGE_ROWS = ["frontend(quant+planes)", "match(front+score+topk+refine16)",
              "full(match+icp_refine)"]


def _device_rows(err):
    """The row names of --profile's device-stage table, each with a
    positive finite ms/frame; [] without the table."""
    lines = err.splitlines()
    heads = [i for i, ln in enumerate(lines)
             if ln.startswith("# device stages (")]
    if not heads:
        return []
    rows = lines[heads[0] + 1:heads[0] + 4]
    for ln in rows:
        ms = float(ln[2 + 36:].split()[0])
        assert 0 < ms < float("inf") and ln.endswith(" ms/frame"), ln
    return [ln[2:2 + 36].strip() for ln in rows]


def test_cli_profile_device_stage_rows(port_trained, tmp_path, capsys):
    """``recon --profile`` and ``track --profile`` print the JAX CLI's
    three device-stage rows (cumulative prefixes, JAX's names and format)
    after the host table; ``recon --profile --artifact`` prints the host
    table only, as the JAX CLI leaves the table out there."""
    import inspect
    src = inspect.getsource(jax_cli._profile_stages)
    assert all(f'"{name}"' in src for name in STAGE_ROWS)
    rc, _, _, err = _run(cli.main, ["track", port_trained[0], "--profile",
                                    "--device", "cpu"] + RECON, capsys)
    assert rc == 0 and "track_step(kcf+match+refine)" in err
    assert _device_rows(err) == STAGE_ROWS
    assert err.index("# host wall-clock") < err.index("# device stages")
    art = str(tmp_path / "artifact")
    assert cli.main(["export", port_trained[0], art, "--width", "240",
                     "--height", "160", "--device", "cpu"] + RECON) == 0
    capsys.readouterr()
    rc, _, _, err = _run(cli.main, ["recon", port_trained[0], "--artifact",
                                    art, "--profile", "--device", "cpu"]
                         + RECON, capsys)
    assert rc == 0 and "recognition(+fetch)" in err
    assert _device_rows(err) == [] and "device stages" not in err


_SUBPROCESS = LOADED + r"""
import contextlib, io, json, os, runpy, sys
from fealess_tpu_torch import training
from fealess_tpu_torch.apps import cli, scan_package  # noqa: F401
from fealess_tpu_torch.io import checkpoint, export  # noqa: F401

pkg, art, jax_ckpt = sys.argv[1:4]
recon = ["--refine-crop", "64", "--icp-max-points", "1024", "--device", "cpu"]
sys.argv = ["fealess_tpu_torch", "train", pkg, "--device", "cpu"]
try:
    runpy.run_module("fealess_tpu_torch", run_name="__main__", alter_sys=True)
except SystemExit as e:
    rcs = [e.code]
rcs += [cli.main(["export", pkg, art, "--width", "240", "--height", "160"]
                 + recon),
        cli.main(["recon", pkg, "--artifact", art] + recon),
        cli.main(["track", pkg, "--profile"] + recon)]
lines = io.StringIO()
with contextlib.redirect_stdout(lines):
    rcs.append(cli.main(["recon", pkg] + recon))
res = os.path.join(art, "recon.jsonl")
with open(res, "w") as f:
    f.write(lines.getvalue())
rcs.append(cli.main(["eval", pkg, res, "--model-scale", "1.0"]))
bank, det = checkpoint.import_yaml(os.path.join(pkg, "linemod_templates.yml"),
                                   device="cpu")
checkpoint.save_bank(os.path.join(art, "ckpt"), bank, det)
checkpoint.load_bank(os.path.join(art, "ckpt"), device="cpu")
checkpoint.load_bank(jax_ckpt, device="cpu")       # written by orbax
print(json.dumps({"rcs": rcs, "native": training.have_native(),
                  "loaded": _loaded()}))
"""


def test_cli_runs_without_jax_flax_or_cv2(tmp_path):
    """A fresh interpreter imports every module of the offline path and
    runs ``python -m fealess_tpu_torch train``, then export, recon
    --artifact, track --profile (with the device-stage table), recon, eval,
    a bank checkpoint saved and loaded, and the JAX package's orbax
    checkpoint loaded; jax, flax, cv2, PIL, orbax, tensorstore and the JAX
    package (by name or by file) are never loaded."""
    pkg = str(tmp_path / "pkg")
    write_package(pkg, shifts=((0, 0), (4, 2)))
    _write_cube_obj(os.path.join(pkg, "model.obj"))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _SUBPROCESS, pkg,
                          str(tmp_path / "art"), CKPT], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["loaded"] == []
    assert result["rcs"] == [0] * 6
    assert result["native"]        # train built and ran libfealess_host
