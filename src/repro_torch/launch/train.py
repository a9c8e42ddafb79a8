"""Training launcher on one device (port of ``repro.launch.train``):
restore -> step loop -> checkpoints.

    PYTHONPATH=src python -m repro_torch.launch.train --arch exanode-100m \
        --steps 20 --batch 8 --seq 512 [--smoke] [--device cpu] \
        [--ckpt-dir DIR --save-every 50]

Runs on the CUDA card unless ``--device cpu`` is given (then through the
kernels' plain PyTorch versions).  Each step trains on
``synthetic_batch(dcfg, step)`` under a cosine schedule with
``warmup = min(100, steps // 10)``, as the reference's loop does, and logs
step, loss, learning rate, gradient norm and the step's wall time.  As in
the reference, ``--ckpt-dir`` restores the newest checkpoint there
(resuming at its step + 1), saves every ``--save-every`` steps (steps
where ``step % save_every == 0``, written by a background thread, the
newest three kept) and once more after the last step, in the reference's
format (``checkpoint.serialize``); a ``StragglerMonitor`` with the
reference's training thresholds watches step times.

Not ported yet: the reference's preflight (ROADMAP queue 1, item 12) and
its mesh and grad-sync options (item 9).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, synthetic_batch, to_device
from repro_torch.ft.straggler import StragglerMonitor
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedules import make_schedule
from repro_torch.runtime import Runtime


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_loop(cfg, *, steps: int, global_batch: int, seq_len: int,
               microbatches: int = 1, lr: float = 3e-4, ckpt_dir: str = "",
               save_every: int = 50, log_every: int = 10,
               param_dtype=torch.float32, device=None):
    """Train ``cfg`` (a ``ModelConfig`` or a registry name) up to step
    ``steps`` (from the newest checkpoint in ``ckpt_dir`` when there is
    one).  Returns (state, history): one dict per step run with its
    ``step``, ``loss``, ``grad_norm``, ``lr`` and wall ``seconds`` (host
    clock around the step, ending in a device synchronize)."""
    rt = Runtime.create(cfg, shape_kind="train", seq_len=seq_len,
                        param_dtype=param_dtype, device=device)
    print(rt.describe(), flush=True)
    schedule = make_schedule("cosine", peak=lr, warmup=min(100, steps // 10),
                             total=steps)
    step_fn = rt.compile_train_step(schedule=schedule, opt_cfg=AdamWConfig(),
                                    microbatches=microbatches)
    dcfg = DataConfig(vocab_size=rt.cfg.vocab_size, seq_len=seq_len,
                      global_batch=global_batch)
    mgr = (CheckpointManager(ckpt_dir, save_every=save_every) if ckpt_dir
           else None)
    state = rt.init_train_state()
    start = 0
    if mgr is not None:
        restored, at = mgr.restore_latest(state, device=rt.device)
        if restored is not None:
            state, start = restored, at + 1
            print(f"restored checkpoint @ step {at}", flush=True)
    mon = StragglerMonitor()
    history = []
    t_begin = time.perf_counter()
    for step in range(start, steps):
        batch = to_device(synthetic_batch(dcfg, step), rt.device)
        _sync(rt.device)
        t0 = time.perf_counter()
        mon.step_start()
        state, metrics = step_fn(state, batch)
        _sync(rt.device)
        rep = mon.step_end(step)
        if rep.action != "ok":
            print(f"[straggler] step {step}: {rep.step_time:.3f}s "
                  f"({rep.ratio:.1f}x median) -> {rep.action}", flush=True)
        rec = dict(step=step, loss=float(metrics["loss"]),
                   grad_norm=float(metrics["grad_norm"]),
                   lr=float(metrics["lr"]),
                   seconds=time.perf_counter() - t0)
        history.append(rec)
        if mgr is not None:
            mgr.maybe_save(step, state)
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d} loss={rec['loss']:.9g} "
                  f"lr={rec['lr']:.2e} gnorm={rec['grad_norm']:.3f} "
                  f"step_ms={rec['seconds'] * 1e3:.1f}", flush=True)
    if mgr is not None:
        mgr.maybe_save(steps - 1, state, force=True)
        mgr.wait()
    dt = time.perf_counter() - t_begin
    tok = global_batch * seq_len * (steps - start)
    print(f"done: {steps - start} steps, {tok} tokens, "
          f"{tok / max(dt, 1e-9):.0f} tok/s (host wall, data included)",
          flush=True)
    return state, history


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="exanode-100m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--bf16-params", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions (default: the GPU)")
    args = ap.parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    train_loop(cfg, steps=args.steps, global_batch=args.batch,
               seq_len=args.seq, microbatches=args.microbatches, lr=args.lr,
               ckpt_dir=args.ckpt_dir, save_every=args.save_every,
               log_every=args.log_every,
               param_dtype=torch.bfloat16 if args.bf16_params
               else torch.float32, device=args.device)


if __name__ == "__main__":
    main()
