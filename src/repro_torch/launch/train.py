"""Training driver: data pipeline + train step + checkpoint/restart + FT
(the counterpart of ``repro/launch/train.py``).

Runs any ``--arch`` (reduced or full config) on one device -- the card
unless ``--device cpu`` -- or, with ``--data-mesh`` x ``--model-mesh``
above 1, as one rank of the mesh step (``train.step`` over a
``launch.mesh.make_host_mesh``): the process group comes from the
``torchrun``-style environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``; ``LOCAL_RANK`` picks the card), NCCL on
cards and gloo under ``--device cpu``.  Checkpoints gather the whole
state to rank 0, which writes the single-device layout
(``ckpt/checkpoint.py``); a restore loads it on every rank and re-shards
it.  This is the process ``ft.supervisor`` relaunches on failure: at
startup it restores the newest checkpoint and resumes the deterministic
data stream from the restored step.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
      --reduced --device cpu --steps 8 --batch 2 --seq 16 \\
      --ckpt-dir /tmp/ck --ckpt-every 4
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen3-14b --reduced --device cpu --data-mesh 2 \\
      --model-mesh 2 --steps 4 --batch 4 --seq 32
  REPRO_FAIL_AT_STEP=20 PYTHONPATH=src python -m repro_torch.launch.train ...
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib

import torch
import torch.distributed as dist

import repro_torch.configs as C
from repro_torch import resolve_device
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.distributed.compat import implicit_replication
from repro_torch.ft.monitor import FailureInjector, Heartbeat, StepTimer
from repro_torch.models import model as mdl
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
    ranks = args.data_mesh * args.model_mesh
    mesh = None
    if ranks > 1:
        mesh, dev = _mesh(args)
    else:
        dev = resolve_device(args.device)
    lead = mesh is None or dist.get_rank() == 0
    cfg = C.reduced(args.arch) if args.reduced else C.get(args.arch)
    ocfg = optim.OptConfig(lr=args.lr, warmup_steps=max(2, args.steps // 20),
                           decay_steps=args.steps)
    dcfg = DataConfig(seed=args.seed, global_batch=args.batch,
                      seq_len=args.seq)

    state = tstep.init_state(cfg, ocfg, seed=args.seed, device=dev,
                             mesh=mesh)
    step_fn = tstep.make_train_step(
        cfg, ocfg, mesh, accum_steps=args.accum,
        param_specs=None if mesh is None else
        mdl.param_specs(state["params"]))
    # a restore copies whole arrays into DTensor leaves: each rank keeps
    # its shard
    sharded = implicit_replication if mesh is not None else \
        contextlib.nullcontext

    start = 0
    workdir = pathlib.Path(args.ckpt_dir) if args.ckpt_dir else None
    if workdir:
        workdir.mkdir(parents=True, exist_ok=True)     # the heartbeat's
        last = ckpt.latest_step(workdir)
        if last is not None:
            with sharded():
                state = ckpt.restore(workdir, last, state)
            start = last
            if lead:
                print(f"[train] restored step {start} from {workdir}")
    saver = ckpt.AsyncCheckpointer(workdir) if workdir else None

    def save(step):
        # every rank joins the gather; rank 0 writes
        whole = state if mesh is None else tstep.gather_state(state)
        if lead:
            saver.save(step, whole)

    injector = FailureInjector(workdir or ".")
    timer = StepTimer()
    hb = Heartbeat((workdir or pathlib.Path(".")) / (
        "heartbeat" if lead else f"heartbeat_rank{dist.get_rank()}"))

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
            if lead and (i % args.log_every == 0 or i == args.steps - 1):
                print(f"[train] step {i} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.3f}")
            if saver and (i + 1) % args.ckpt_every == 0:
                save(i + 1)
    if saver:
        save(args.steps)
        saver.wait()
    if mesh is not None:
        # no rank leaves (and drops the group) before rank 0 has written
        dist.barrier()
    report = {"final_loss": losses[-1], "first_loss": losses[0],
              "steps_run": len(losses), "start": start,
              "stragglers": timer.stragglers, "device": str(dev),
              "mesh": [args.data_mesh, args.model_mesh]}
    if not lead:
        return report
    print("[train] done:", json.dumps(report))
    if args.metrics_out:
        pathlib.Path(args.metrics_out).write_text(json.dumps(
            {**report, "losses": losses}))
    return report


def _mesh(args):
    """(the (data, model) mesh, this rank's device) over the process group
    the environment describes (started here when none is up)."""
    from repro_torch.launch.mesh import make_host_mesh
    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    if not dist.is_initialized():
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"--data-mesh x --model-mesh = {args.data_mesh} x "
                f"{args.model_mesh} runs one process a rank: start them "
                f"with torchrun or set {', '.join(missing)}")
        dist.init_process_group("gloo" if cpu else "nccl",
                                init_method="env://")
    if cpu:
        dev = torch.device("cpu")
    else:
        dev = resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
        torch.cuda.set_device(dev)
    return make_host_mesh(args.data_mesh, args.model_mesh,
                          device_type=dev.type), dev


if __name__ == "__main__":
    main()
