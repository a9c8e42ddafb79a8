#!/usr/bin/env python3
"""How much of xlstm-125m's f32 logits gap the mLSTM scan's f32 rounding
explains.

    python scripts/xlstm_logits_gap.py

xlstm-125m at full width with the seeded weights and the two 600-token
prompts of ``chip_smoke.py``'s xlstm phase (f32): prefill logits through
the plain path on the CPU (the f32 chunked scan, ``ref_mlstm_scan``), and
again with every mLSTM layer's scan computed in f64 (its inputs widened,
its outputs rounded back to f32, by the sequential oracle; nothing else
changes), and, where a CUDA device is present, through the kernels on the
card.  Prints the max abs
difference of each pair of logits: plain f32 against the f64 scan is what
the scan's own f32 rounding moves the logits by; the card against the
CPU is the gap ``chip_smoke.py`` gates at 1e-3.

A full-width model: run it on a machine with memory to spare (it holds
three copies of 150 M f32 parameters, one on the card); the CPU prefills
take a minute or two.  ``--smoke`` runs the smoke config (64 wide, 24
tokens) instead, as a quick check of the script.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import argparse

    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models.common import init_params, tree_map
    from repro_torch.models.registry import model_specs
    from repro_torch.runtime import Runtime
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true")
    smoke = ap.parse_args().smoke
    cfg = (get_smoke_config if smoke else get_config)("xlstm-125m").scaled(
        dtype=torch.float32)
    params = init_params(model_specs(cfg), seed=0)
    prompt = 24 if smoke else cs.XLSTM_PROMPT
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, prompt), dtype=np.int32))
    cpu = Runtime.create(cfg, capacity=2048, device="cpu", params=params)
    t0 = time.perf_counter()
    logits = {"plain f32": cpu.prefill(toks)[0]}

    plain_scan = ops.mlstm_scan

    def scan_f64(q, k, v, i_gate, f_log, *, chunk=256, state=None):
        """The scan in f64: the sequential oracle on widened inputs (the
        chunked form and the oracle agree to f64 rounding)."""
        B, H, S, dh = q.shape
        tr = lambda t: t.double().transpose(1, 2)      # noqa: E731
        if state is None:
            state = (q.new_zeros(B, H, dh, dh), q.new_zeros(B, H, dh),
                     q.new_full((B, H), float("-inf")))
        y, carry = ref.ref_mlstm_chunk(
            *(tr(t) for t in (q, k, v, i_gate, f_log)),
            *(t.double() for t in state))
        return (y.transpose(1, 2).float().contiguous(),
                tuple(t.float() for t in carry))

    ops.mlstm_scan = scan_f64
    try:
        logits["f64 scan"] = cpu.prefill(toks)[0]
    finally:
        ops.mlstm_scan = plain_scan
    cpu_s = time.perf_counter() - t0
    gpu = None
    if torch.cuda.is_available():
        gpu = cs.gpu_line()
        card = Runtime.create(cfg, capacity=2048, device="cuda",
                              params=tree_map(lambda t: t.to("cuda"), params))
        logits["card"] = card.prefill(toks.to("cuda"))[0].cpu()

    def gap(a, b):
        return float((logits[a].double() - logits[b].double()).abs().max())

    out = {"config": "smoke" if smoke else "full width",
           "prompts": f"2 x {prompt}", "cpu_seconds": cpu_s,
           # the padded vocabulary's columns hold -1e30
           "max_abs_logit": float(logits["plain f32"].abs()
                                  .masked_fill(logits["plain f32"] <= -1e29, 0)
                                  .max()),
           "plain f32 vs f64 scan": gap("plain f32", "f64 scan")}
    if "card" in logits:
        out["card vs plain f32"] = gap("card", "plain f32")
        out["card vs f64 scan"] = gap("card", "f64 scan")
    out["gpu"] = gpu
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
