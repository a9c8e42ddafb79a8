"""Training launcher on one device (port of ``repro.launch.train``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch exanode-100m \
        --steps 20 --batch 8 --seq 512 [--smoke] [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given (then through the
kernels' plain PyTorch versions).  Each step trains on
``synthetic_batch(dcfg, step)`` under a cosine schedule with
``warmup = min(100, steps // 10)``, as the reference's loop does, and logs
step, loss, learning rate, gradient norm and the step's wall time.

Not ported yet (ROADMAP queue 1, item 10): the reference's preflight,
checkpoint save/restore and straggler monitor; its mesh and grad-sync
options wait for sharding (item 9).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, synthetic_batch, to_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedules import make_schedule
from repro_torch.runtime import Runtime


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_loop(cfg, *, steps: int, global_batch: int, seq_len: int,
               microbatches: int = 1, lr: float = 3e-4, log_every: int = 10,
               param_dtype=torch.float32, device=None):
    """Train ``cfg`` (a ``ModelConfig`` or a registry name) for ``steps``
    steps.  Returns (state, history): one dict per step with its ``step``,
    ``loss``, ``grad_norm``, ``lr`` and wall ``seconds`` (host clock around
    the step, ending in a device synchronize)."""
    rt = Runtime.create(cfg, shape_kind="train", seq_len=seq_len,
                        param_dtype=param_dtype, device=device)
    print(rt.describe(), flush=True)
    schedule = make_schedule("cosine", peak=lr, warmup=min(100, steps // 10),
                             total=steps)
    step_fn = rt.compile_train_step(schedule=schedule, opt_cfg=AdamWConfig(),
                                    microbatches=microbatches)
    dcfg = DataConfig(vocab_size=rt.cfg.vocab_size, seq_len=seq_len,
                      global_batch=global_batch)
    state = rt.init_train_state()
    history = []
    t_begin = time.perf_counter()
    for step in range(steps):
        batch = to_device(synthetic_batch(dcfg, step), rt.device)
        _sync(rt.device)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        _sync(rt.device)
        rec = dict(step=step, loss=float(metrics["loss"]),
                   grad_norm=float(metrics["grad_norm"]),
                   lr=float(metrics["lr"]),
                   seconds=time.perf_counter() - t0)
        history.append(rec)
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d} loss={rec['loss']:.4f} "
                  f"lr={rec['lr']:.2e} gnorm={rec['grad_norm']:.3f} "
                  f"step_ms={rec['seconds'] * 1e3:.1f}", flush=True)
    dt = time.perf_counter() - t_begin
    tok = global_batch * seq_len * steps
    print(f"done: {steps} steps, {tok} tokens, {tok / max(dt, 1e-9):.0f} "
          f"tok/s (host wall, data included)", flush=True)
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
    ap.add_argument("--bf16-params", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions (default: the GPU)")
    args = ap.parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    train_loop(cfg, steps=args.steps, global_batch=args.batch,
               seq_len=args.seq, microbatches=args.microbatches, lr=args.lr,
               param_dtype=torch.bfloat16 if args.bf16_params
               else torch.float32, device=args.device)


if __name__ == "__main__":
    main()
