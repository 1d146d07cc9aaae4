"""Training driver: data pipeline + train step + checkpoint/restart + FT
(the counterpart of ``repro/launch/train.py``).

Runs any ``--arch`` (reduced or full config) on one device: the card
unless ``--device cpu``.  This is the process ``ft.supervisor``
relaunches on failure: at startup it restores the newest checkpoint and
resumes the deterministic data stream from the restored step.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
      --reduced --device cpu --steps 8 --batch 2 --seq 16 \\
      --ckpt-dir /tmp/ck --ckpt-every 4
  REPRO_FAIL_AT_STEP=20 PYTHONPATH=src python -m repro_torch.launch.train ...
"""
from __future__ import annotations

import argparse
import json
import pathlib

import repro_torch.configs as C
from repro_torch import resolve_device
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.ft.monitor import FailureInjector, Heartbeat, StepTimer
from repro_torch.train import optim, step as tstep


def build(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--data-mesh", type=int, default=1)
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None):
    args = build(argv)
    if args.data_mesh * args.model_mesh > 1:
        raise NotImplementedError(
            "--data-mesh/--model-mesh > 1 is the FSDP/TP step over "
            "distributed/sharding.py, not ported yet (ROADMAP Queue 1 "
            "item 12)")
    dev = resolve_device(args.device)
    cfg = C.reduced(args.arch) if args.reduced else C.get(args.arch)
    ocfg = optim.OptConfig(lr=args.lr, warmup_steps=max(2, args.steps // 20),
                           decay_steps=args.steps)
    dcfg = DataConfig(seed=args.seed, global_batch=args.batch,
                      seq_len=args.seq)

    state = tstep.init_state(cfg, ocfg, seed=args.seed, device=dev)
    step_fn = tstep.make_train_step(cfg, ocfg, accum_steps=args.accum)

    start = 0
    workdir = pathlib.Path(args.ckpt_dir) if args.ckpt_dir else None
    if workdir:
        workdir.mkdir(parents=True, exist_ok=True)     # the heartbeat's
        last = ckpt.latest_step(workdir)
        if last is not None:
            state = ckpt.restore(workdir, last, state)
            start = last
            print(f"[train] restored step {start} from {workdir}")
    saver = ckpt.AsyncCheckpointer(workdir) if workdir else None
    injector = FailureInjector(workdir or ".")
    timer = StepTimer()
    hb = Heartbeat((workdir or pathlib.Path(".")) / "heartbeat")

    losses = []
    with hb:
        for i in range(start, args.steps):
            injector.check(i)
            batch = batch_at(dcfg, cfg, i)
            timer.start()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            timer.stop(i)
            losses.append(loss)
            if i % args.log_every == 0 or i == args.steps - 1:
                print(f"[train] step {i} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.3f}")
            if saver and (i + 1) % args.ckpt_every == 0:
                saver.save(i + 1, state)
    if saver:
        saver.save(args.steps, state)
        saver.wait()
    report = {"final_loss": losses[-1], "first_loss": losses[0],
              "steps_run": len(losses), "start": start,
              "stragglers": timer.stragglers, "device": str(dev)}
    print("[train] done:", json.dumps(report))
    if args.metrics_out:
        pathlib.Path(args.metrics_out).write_text(json.dumps(
            {**report, "losses": losses}))
    return report


if __name__ == "__main__":
    main()
