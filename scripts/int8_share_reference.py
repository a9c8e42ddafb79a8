#!/usr/bin/env python3
"""The JAX reference's own int8 token agreement at full width, on the CPU.

Serves the first ``--requests`` prompts of ``chip_smoke.paged_prompts``
(the requests ``chip_smoke.py --phases int8_cpu`` serves) with 64 new
tokens each through the reference's paged engine twice, with
``kv_dtype="f32"`` (the working dtype, bf16) and with ``kv_dtype="int8"``,
on exanode-100m at full width with the reference's seeded params
(``Runtime.create(..., seed=0)``), capacity 2048, 16 slots, block size 16,
and prints the share of token positions where the two greedy streams
agree.  That share is the control for the port's int8 gate
(``chip_smoke.INT8_MATCH_MIN``): it says what the reference's own int8
pool gives on the same requests.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/int8_share_reference.py

Runs on the CPU only; takes some minutes (XLA compiles one prefill per
bucket and batch size).
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new", type=int, default=64)
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    from chip_smoke import match_share, paged_prompts
    from repro.runtime import Runtime
    from repro.serve.engine import Request

    streams, walls = {}, {}
    for kv in ("f32", "int8"):
        rt = Runtime.create("exanode-100m", shape_kind="decode",
                            capacity=2048, kv_layout="paged", kv_dtype=kv,
                            seed=0)
        prompts = paged_prompts(rt.cfg.vocab_size)[:args.requests]
        eng = rt.engine(num_slots=16, block_size=16, injector=None,
                        straggler_kw=dict(warn_ratio=1e9, remesh_ratio=1e9,
                                          abort_ratio=1e9))
        t0 = time.perf_counter()
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=args.new))
        stats = eng.run_to_completion()
        walls[kv] = time.perf_counter() - t0
        streams[kv] = {r.rid: list(r.generated) for r in eng.finished}
        print(f"{kv}: {stats.summary}; wall {walls[kv]:.1f} s", flush=True)
    share = match_share(streams["int8"], streams["f32"])
    print(f"reference int8 matches the reference working-dtype paged pool "
          f"on {share:.4f} of token positions (exanode-100m full width, "
          f"{args.requests} requests x {args.new} new tokens, CPU, "
          f"jax {jax.__version__})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
