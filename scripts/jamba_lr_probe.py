#!/usr/bin/env python3
"""Train jamba-v0.1-52b's ``train_cut()`` (its mamba and attn layers at
full width) for 20 bf16 steps at batch 8 x 512 at each of several peak
learning rates, on one CUDA card, and print each run's losses and its
first-5 minus last-5 mean (the drop ``chip_smoke.py``'s jamba_train phase
gates at TRAIN_LOSS_DROP).

    python3 scripts/jamba_lr_probe.py [--lr 3e-4 4e-4 5e-4 6e-4]

Each run is ``chip_smoke.bf16_train_run`` (the launcher's loop, params
drawn on the card from seed 0, the launch counters read).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lr", type=float, nargs="+",
                    default=[3e-4, 4e-4, 5e-4, 6e-4])
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.configs.jamba_v0_1_52b import train_cut
    for lr in args.lr:
        run, failed = cs.bf16_train_run(torch, train_cut(),
                                        cs.JAMBA_TRAIN_KERNELS, steps=20,
                                        lr=lr, draw_on_device=True)
        print(f"lr {lr:g}: drop {run['drop']:.4f} losses "
              f"{[round(x, 4) for x in run['losses']]} failed {failed} "
              f"[{cs.gpu_line()}]", flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
