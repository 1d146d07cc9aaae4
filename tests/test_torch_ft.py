"""The port's copies of the reference's process-level fault tolerance
(``repro_torch.ft.supervisor``, ``ft.monitor``'s ``Heartbeat`` and
``FailureInjector``), held to ``tests/test_ft_supervisor.py``'s cases and
to the reference's pieces."""
import sys
import textwrap
import time

import pytest
import torch

torch.set_num_threads(1)

from repro.ft import monitor as RMon
from repro_torch.ft import monitor as TMon
from repro_torch.ft.supervisor import RunReport, SupervisorConfig, supervise

HANG_ONCE = textwrap.dedent("""\
    import pathlib, sys, time
    work = pathlib.Path(sys.argv[1])
    sentinel = work / "ran_once"
    if sentinel.exists():
        sys.exit(0)                      # the relaunch succeeds
    sentinel.write_text("1")
    (work / "heartbeat").write_text(str(time.time()))
    time.sleep(60)                       # hang: heartbeat goes stale
""")


def test_stale_heartbeat_triggers_relaunch(tmp_path):
    """A child whose heartbeat goes stale is killed (-9) and the relaunch
    runs to a clean exit."""
    script = tmp_path / "child.py"
    script.write_text(HANG_ONCE)
    report = supervise(
        [sys.executable, str(script), str(tmp_path)], tmp_path,
        SupervisorConfig(max_restarts=2, hang_timeout_s=1.5, poll_s=1.0))
    assert report == RunReport(restarts=1, exit_code=0, history=[-9, 0])


def test_hang_restarts_exhaust(tmp_path):
    """A child that never heartbeats is killed on every launch; the
    supervisor gives up after ``max_restarts`` and reports the kill."""
    script = tmp_path / "child.py"
    script.write_text("import time; time.sleep(60)\n")
    report = supervise(
        [sys.executable, str(script)], tmp_path,
        SupervisorConfig(max_restarts=1, hang_timeout_s=0.2, poll_s=0.2))
    assert report == RunReport(restarts=1, exit_code=-9, history=[-9, -9])


def test_crash_exit_codes_restart_and_supervisor_config(tmp_path):
    """A child that exits non-zero is relaunched until the budget is
    spent; the defaults are the reference's."""
    from repro.ft.supervisor import SupervisorConfig as RConfig
    assert SupervisorConfig() == SupervisorConfig(**vars(RConfig()))
    report = supervise([sys.executable, "-c", "import sys; sys.exit(3)"],
                       tmp_path, SupervisorConfig(max_restarts=2,
                                                  poll_s=0.05))
    assert report == RunReport(restarts=2, exit_code=3, history=[3, 3, 3])


def test_heartbeat_age_matches_reference(tmp_path):
    path = tmp_path / "hb"
    assert TMon.Heartbeat.age(path) == RMon.Heartbeat.age(path) \
        == float("inf"), "no file: infinitely stale"
    path.write_text("not a float")
    assert TMon.Heartbeat.age(path) == float("inf")
    with TMon.Heartbeat(path, interval=0.05):
        time.sleep(0.15)
    # read once the writer has stopped: a read racing its rewrite of the
    # file sees it empty (inf), in both packages alike
    port, ref = TMon.Heartbeat.age(path), RMon.Heartbeat.age(path)
    assert 0.0 <= port < 1.0 and 0.0 <= ref < 1.0
    assert abs(port - ref) < 0.05
    time.sleep(0.1)
    assert TMon.Heartbeat.age(path) >= port + 0.09, "stopped: it ages"


@pytest.mark.parametrize("fail_at", [None, 3])
def test_failure_injector_matches_reference(tmp_path, monkeypatch, fail_at):
    """``REPRO_FAIL_AT_STEP`` crashes once at that step (a sentinel file
    lets the restarted process pass it), in both packages alike."""
    if fail_at is None:
        monkeypatch.delenv(TMon.FailureInjector.ENV, raising=False)
    else:
        monkeypatch.setenv(TMon.FailureInjector.ENV, str(fail_at))
    assert TMon.FailureInjector.ENV == RMon.FailureInjector.ENV
    outcomes = {}
    for name, mod in (("ref", RMon), ("port", TMon)):
        work = tmp_path / name
        work.mkdir()
        got = []
        for _ in range(2):              # the process and its relaunch
            inj = mod.FailureInjector(work)
            for step in range(6):
                try:
                    inj.check(step)
                except RuntimeError as e:
                    got.append((step, str(e)))
                    break
            else:
                got.append(None)
        outcomes[name] = (got, sorted(p.name for p in work.iterdir()))
    assert outcomes["port"] == outcomes["ref"]
    if fail_at is not None:
        assert outcomes["port"][0] == [(3, "injected failure at step 3"),
                                       None]
