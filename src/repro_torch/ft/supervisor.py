"""Supervisor: restart-from-checkpoint orchestration for node failures (a
copy of ``repro/ft/supervisor.py``).

Runs the training program as a child process; on non-zero exit (crash,
injected fault, OOM-kill) or a stale heartbeat (hang), it relaunches.  The
program restores from the newest checkpoint at startup, so each restart
loses at most ``ckpt_every`` steps of work.  At real multi-pod scale this
process runs per-slice under the cluster scheduler; the logic is the same.
"""
from __future__ import annotations

import dataclasses
import pathlib
import subprocess
import sys
import time
from typing import List, Optional

from repro_torch.ft.monitor import Heartbeat

__all__ = ["SupervisorConfig", "supervise"]


@dataclasses.dataclass
class SupervisorConfig:
    max_restarts: int = 3
    hang_timeout_s: float = 0.0      # 0 = no hang detection
    poll_s: float = 0.5


@dataclasses.dataclass
class RunReport:
    restarts: int
    exit_code: int
    history: List[int]               # child exit codes in order


def supervise(cmd: List[str], workdir, cfg: SupervisorConfig = SupervisorConfig(),
              env=None) -> RunReport:
    """Run `cmd` under restart supervision.  Returns the final report."""
    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    hb_path = workdir / "heartbeat"
    history: List[int] = []
    restarts = 0
    while True:
        proc = subprocess.Popen(cmd, env=env)
        code: Optional[int] = None
        while code is None:
            try:
                code = proc.wait(timeout=cfg.poll_s)
            except subprocess.TimeoutExpired:
                if (cfg.hang_timeout_s > 0
                        and Heartbeat.age(hb_path) > cfg.hang_timeout_s):
                    proc.kill()
                    code = -9
        history.append(code)
        if code == 0:
            return RunReport(restarts, 0, history)
        restarts += 1
        if restarts > cfg.max_restarts:
            return RunReport(restarts - 1, code, history)
        print(f"[supervisor] child exited {code}; restart "
              f"{restarts}/{cfg.max_restarts}", file=sys.stderr)
        time.sleep(cfg.poll_s)
