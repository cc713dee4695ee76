"""Does ``torch.profiler`` record every device event of a short profiled
run, in a fresh process and after what a long process (``chip_smoke.py``)
has done before it?

chip_smoke's phase 9 counts the device events of one profiled stride-2 L3
call (``ops/lab.local_variant``) and wants exactly 1; phase 8 counts a
frame's.  Each line below is one measurement in a child process on the
lab's local2 inputs: the device events of one profiled L3 call alone (1
is right), of 5 calls (5), and of the call between two one-element adds
(3), and, for that last run, each event with its start in microseconds
after the run's first event (runtime calls on the host marked ``@host``).

- :data:`STEPS`, for each CUPTI setting of Kineto's environment in
  :data:`SETTINGS` (none, and ``TEARDOWN_CUPTI=0``: keep CUPTI set up
  between profiler sessions): one child takes the steps in turn and
  measures after each.
- :data:`SCENARIOS`: a child each, in the default setting, that profiles
  one add (or not), idles :data:`IDLE_S` seconds (or 5, or keeps the card
  busy as long), then takes one remedy (or none) and measures.

Usage (from the repository root, on a machine with a CUDA card):

    python -m fealess_tpu_torch.apps.profile_check
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

SETTINGS = {"default": {}, "TEARDOWN_CUPTI=0": {"TEARDOWN_CUPTI": "0"}}
IDLE_S = 30
STEPS = ("fresh", "after 20 profiled sessions",
         "after 10 CUDA graphs of the call", "after a profiled 2000 adds",
         "after 30 s idle")
# (scenario, an earlier profiled session, seconds of idle (busy: graph
# replays of the call as long), the remedy)
SCENARIOS = (
    ("no earlier session, idle 30 s", False, "idle", None),
    ("earlier session, idle 30 s", True, "idle", None),
    ("earlier session, idle 5 s", True, "idle5", None),
    ("earlier session, busy 30 s", True, "busy", None),
    ("earlier session, idle 30 s, a throwaway session", True, "idle",
     "throwaway"),
    ("earlier session, idle 30 s, 1 s of graph replays", True, "idle",
     "replays"),
    ("earlier session, idle 30 s, a spin kernel first in each profile",
     True, "idle", "spin"),
    ("earlier session, idle 30 s, measured twice", True, "idle", "twice"),
)
SPIN_CYCLES = 4_000_000   # ~2 ms of torch.cuda._sleep at the card's clock


def _events(fn, n, spin=False):
    """(device events of ``fn`` run ``n`` times under ``torch.profiler``
    as ``utils/profiling.profile_calls`` runs it, every event listed);
    with ``spin`` the profile starts with a ``torch.cuda._sleep`` kernel
    and a synchronize, and the spin kernel's own event is not counted."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    every = sorted(prof.events(), key=lambda e: e.time_range.start)
    t0 = every[0].time_range.start if every else 0.0
    seen = [f"{e.name[:40]}"
            f"{'' if e.device_type == DeviceType.CUDA else '@host'} "
            f"{e.time_range.start - t0:.1f}" for e in every]
    return sum(e.device_type == DeviceType.CUDA and "spin" not in e.name
               for e in every), seen


def _measure(call, one, spin=False) -> dict:
    """The three profiled runs of the module's note (``spin``: as
    :func:`_events`)."""
    def bracketed():
        one.add_(1)
        call()
        one.add_(1)

    got = {"alone": _events(call, 1, spin)[0],
           "five": _events(call, 5, spin)[0]}
    got["bracketed"], got["events"] = _events(bracketed, 1, spin)
    return got


def child(scenario: str) -> None:
    """One scenario (``steps`` or one of :data:`SCENARIOS`) in this process,
    one JSON line a measurement."""
    import torch
    from fealess_tpu_torch.apps import kernel_lab
    from fealess_tpu_torch.ops import lab
    from fealess_tpu_torch.utils.profiling import graph_ms
    local = kernel_lab.local2_inputs("cuda")
    one = torch.zeros(1, device="cuda")

    def call():
        return lab.local_variant(*local, 2, False)

    def emit(step, got):
        print(json.dumps({"step": step, **got}), flush=True)

    call()
    torch.cuda.synchronize()
    if scenario == "steps":
        for step in STEPS:
            if step == STEPS[1]:
                for _ in range(20):
                    _events(lambda: one.add_(1), 1)
            elif step == STEPS[2]:
                for _ in range(10):
                    graph_ms(call, 20)
            elif step == STEPS[3]:
                _events(lambda: one.add_(1), 2000)
            elif step == STEPS[4]:
                time.sleep(IDLE_S)
            emit(step, _measure(call, one))
        return
    _, earlier, wait, remedy = next(sc for sc in SCENARIOS
                                    if sc[0] == scenario)
    if earlier:
        _events(lambda: one.add_(1), 1)
    t0 = time.perf_counter()
    if wait == "busy":
        while time.perf_counter() - t0 < IDLE_S:
            graph_ms(call, 20)
    else:
        time.sleep(5 if wait == "idle5" else IDLE_S)
    if remedy == "throwaway":
        _events(lambda: one.add_(1), 1)
    elif remedy == "replays":
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 1:
            graph_ms(call, 20)
    emit(scenario, _measure(call, one, remedy == "spin"))
    if remedy == "twice":
        emit(scenario + " (the second)", _measure(call, one))


def _run(name: str, env: dict, scenario: str, repo: str) -> None:
    child_env = {k: v for k, v in os.environ.items() if k != "TEARDOWN_CUPTI"}
    child_env.update(env)
    out = subprocess.run(
        [sys.executable, "-m", "fealess_tpu_torch.apps.profile_check",
         "--child", scenario], cwd=repo, env=child_env,
        capture_output=True, text=True, timeout=600)
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            row = json.loads(line)
            print(f"{name:<18} {row['step']:<66} alone {row['alone']}/1, "
                  f"five {row['five']}/5, bracketed {row['bracketed']}/3: "
                  f"{row['events']}")
    notes = [ln for ln in out.stderr.splitlines()
             if "CUPTI" in ln or "dropped" in ln.lower()]
    if notes:
        print(f"{name} {scenario}: the child's CUPTI notes: {notes[:8]}")
    if out.returncode:
        print(f"{name} {scenario}: the child failed (rc {out.returncode}): "
              f"{out.stderr[-2000:]}")


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        child(sys.argv[2])
        return
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for name, env in SETTINGS.items():
        _run(name, env, "steps", repo)
    for scenario, *_ in SCENARIOS:
        _run("default", {}, scenario, repo)


if __name__ == "__main__":
    main()
