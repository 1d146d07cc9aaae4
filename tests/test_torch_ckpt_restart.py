"""The port's training launcher and its restart drill: the reference's
drill on the port (an injected crash at step 8, the supervisor's
relaunch resuming from the step-8 checkpoint, exactly one restart, the
resumed losses an uninterrupted run's), and the launcher's refusals
without a card or a process group.  ``tests/test_torch_ckpt_data.py``
holds the data pipeline and the checkpoints."""
import json
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

from repro_torch.launch import train as launch_train

from test_torch_ckpt_data import _env


def _train_cmd(tmp, metrics, extra=()):
    return [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "olmoe-1b-7b", "--reduced", "--device", "cpu", "--steps", "12",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp),
            "--ckpt-every", "4", "--metrics-out", str(metrics), *extra]


def test_supervised_restart_resumes_training(tmp_path):
    """The reference's drill on the port: an injected crash at step 8, the
    supervisor's relaunch, the resume from the step-8 checkpoint, exactly
    one restart; the resumed losses equal an uninterrupted run's."""
    from repro_torch.ft.supervisor import SupervisorConfig, supervise
    run = tmp_path / "run"
    metrics = tmp_path / "m.json"
    rep = supervise(_train_cmd(run, metrics), workdir=run,
                    cfg=SupervisorConfig(max_restarts=2),
                    env=_env(REPRO_FAIL_AT_STEP="8"))
    assert rep.exit_code == 0
    assert rep.restarts == 1
    rpt = json.loads(metrics.read_text())
    assert rpt["start"] == 8
    assert rpt["steps_run"] == 4
    whole = tmp_path / "whole.json"
    r = subprocess.run(_train_cmd(tmp_path / "whole", whole), env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert json.loads(whole.read_text())["losses"][8:] == rpt["losses"]


def test_launch_needs_a_card_or_the_cpu(monkeypatch):
    """Without ``--device cpu`` the launcher runs on the card, and raises
    with none visible; a mesh above 1 (one process a rank) is refused
    without the process group's environment."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is fine")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "qwen3-14b", "--reduced", "--steps",
                           "1"])
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        launch_train.main(["--arch", "qwen3-14b", "--reduced", "--device",
                           "cpu", "--data-mesh", "2"])
