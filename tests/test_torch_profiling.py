"""``utils/profiling.py`` and ``utils/logging.py`` against the JAX
package's: ``StageTimer.stage``, ``add``, ``stats``, ``reset`` and
``report`` keep the same stages, calls and order as JAX's on the same
sequence; ``device_seconds`` (JAX's ``chain_slope``) and ``time_calls``
(``time_jitted``) give positive finite seconds on CPU tensors; ``trace``
writes a Chrome trace; the package logger is named ``fealess_tpu_torch``,
quiet by default and set by ``FEALESS_LOG`` as JAX's ``fealess_tpu`` is,
and ``add_obj`` logs the model depths it loaded as JAX's engine does."""

import json
import logging
import math

import pytest
import torch

from fealess_tpu.engine import ObjReco as JaxReco
from fealess_tpu.utils import logging as jax_logging
from fealess_tpu.utils import profiling as jax_prof
from fealess_tpu_torch.engine import ObjReco
from fealess_tpu_torch.utils import logging as port_logging
from fealess_tpu_torch.utils import profiling as prof
from tests.test_torch_config import to_port
from tests.test_torch_engine import _config, feature_dir  # noqa: F401

torch.set_num_threads(1)


def _drive(timer, value):
    for _ in range(2):
        with timer.stage("match", value):
            pass
    timer.add("io", 0.25)
    with timer.stage("refine"):
        pass
    with pytest.raises(RuntimeError):
        with timer.stage("match", value):
            raise RuntimeError("the stage still counts")


def _summary(timer):
    return [(name, s.calls) for name, s in timer.stats().items()]


def test_stage_timer_matches_jax():
    synced = {"jax": [], "port": []}
    jt = jax_prof.StageTimer(sync=synced["jax"].append)
    pt = prof.StageTimer(sync=synced["port"].append)
    value = torch.zeros(3)
    _drive(jt, value)
    _drive(pt, value)
    assert _summary(pt) == _summary(jt) == [("match", 3), ("io", 1),
                                            ("refine", 1)]
    assert len(synced["port"]) == len(synced["jax"]) == 3
    assert pt.stats()["io"].total_s == jt.stats()["io"].total_s == 0.25
    assert pt.stats()["io"].mean_ms == jt.stats()["io"].mean_ms == 250.0
    got = [ln.split()[:2] for ln in pt.report().splitlines()]
    want = [ln.split()[:2] for ln in jt.report().splitlines()]
    assert got == want
    jt.reset()
    pt.reset()
    assert pt.stats() == jt.stats() == {}
    assert pt.report() == jt.report()
    # the default sync waits for a value's card; CPU tensors need nothing
    timer = prof.StageTimer()
    with timer.stage("cpu", value):
        value.add_(1)
    assert timer.stats()["cpu"].calls == 1


def test_device_seconds_and_time_calls_on_cpu():
    x0 = torch.randn(96, 96)

    def body(x):
        return torch.tanh(x @ x.T / 96.0)

    secs = prof.device_seconds(body, x0, iters=6, reps=2)
    assert math.isfinite(secs) and secs > 0
    per_call = prof.time_calls(lambda: body(x0), iters=5, warmup=1)
    assert math.isfinite(per_call) and per_call > 0


def test_timers_take_recognition_results(feature_dir):  # noqa: F811
    """``time_calls`` and ``StageTimer.stage`` on what a frame loop holds:
    ``recognition``'s list of ``RecoResult`` (a string, numpy arrays and
    floats, no tensor), as JAX's ``time_jitted`` is used."""
    from tests.test_torch_engine import CX, CY, FX, FY, H, W
    from fealess_tpu_torch.engine import CamIntrinsics

    eng = ObjReco.create("LmICP", to_port(_config("point_to_plane")),
                         device="cpu")
    eng.add_obj(feature_dir[0])
    bgr, depth, _ = feature_dir[1]
    cam = CamIntrinsics(FX, FY, CX, CY, W, H)
    results = eng.recognition(bgr, depth, cam)
    assert results and isinstance(results[0].obj_tag, str)
    per_call = prof.time_calls(lambda: eng.recognition(bgr, depth, cam),
                               iters=1, warmup=1)
    assert math.isfinite(per_call) and per_call > 0
    timer = prof.StageTimer()
    with timer.stage("recognition", results):
        pass
    with timer.stage("recognition", {"device": torch.device("cpu"),
                                     "results": results, "n": 1}):
        pass
    assert timer.stats()["recognition"].calls == 2
    assert prof._devices([results, "cuda", torch.zeros(1)]) == set()


def test_trace_writes_a_chrome_trace(tmp_path):
    with prof.trace(str(tmp_path / "tr")):
        torch.randn(64, 64) @ torch.randn(64, 64)
    path = tmp_path / "tr" / "trace.json"
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_busy_us_is_the_union_of_intervals():
    assert prof.busy_us([]) == 0.0
    assert prof.busy_us([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17.0


@pytest.fixture
def fresh_loggers(monkeypatch):
    """Both packages' loggers unconfigured; their handlers and levels put
    back afterwards."""
    saved = {}
    for mod, root in ((jax_logging, "fealess_tpu"),
                      (port_logging, "fealess_tpu_torch")):
        lg = logging.getLogger(root)
        saved[root] = (list(lg.handlers), lg.level)
        monkeypatch.setattr(mod, "_CONFIGURED", False)
    yield
    for root, (handlers, level) in saved.items():
        lg = logging.getLogger(root)
        lg.handlers[:] = handlers
        lg.setLevel(level)


@pytest.mark.parametrize("env,level", [(None, logging.WARNING),
                                       ("DEBUG", logging.DEBUG),
                                       ("info", logging.INFO),
                                       ("nonsense", logging.WARNING)])
def test_logger_follows_fealess_log(fresh_loggers, monkeypatch, env, level):
    if env is None:
        monkeypatch.delenv("FEALESS_LOG", raising=False)
    else:
        monkeypatch.setenv("FEALESS_LOG", env)
    want = jax_logging.get_logger()
    got = port_logging.get_logger()
    assert want.name == "fealess_tpu" and got.name == "fealess_tpu_torch"
    assert got.level == want.level == level
    child = port_logging.get_logger("fealess_tpu_torch.engine")
    assert child.parent is got
    assert got.handlers and want.handlers


def test_add_obj_logs_like_jax(fresh_loggers, monkeypatch, caplog,
                               feature_dir):  # noqa: F811
    monkeypatch.setenv("FEALESS_LOG", "DEBUG")
    path = feature_dir[0]
    with caplog.at_level(logging.DEBUG):
        JaxReco.create("LmICP", _config("point_to_plane")).add_obj(path)
        ObjReco.create("LmICP", to_port(_config("point_to_plane")),
                       device="cpu").add_obj(path)
    msgs = {r.name: r.getMessage() for r in caplog.records
            if "model depths" in r.getMessage()}
    assert msgs == {"fealess_tpu": "loaded 1 model depths",
                    "fealess_tpu_torch": "loaded 1 model depths"}
