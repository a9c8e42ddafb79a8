#!/usr/bin/env python3
"""Bit-for-bit comparison of the Mamba scan kernel's serving launch (#12,
``ssm_scan`` without ``keep``) between two checkouts of the repository,
on one CUDA card.

    python3 scripts/ssm_bitwise.py --tree DIR --out A.pt
    python3 scripts/ssm_bitwise.py --compare A.pt B.pt

The first form imports ``repro_torch`` from ``DIR/src`` (building its
kernels into ``DIR/build``), runs ``ssm_scan`` on seeded inputs (the
reference test's recipe: dt = softplus(N(0,1)), A = -exp(N(0,1))) at
jamba-v0.1-52b's prefill width (Di 8192, N 16) and at narrower shapes
with N 8, 5 and 64, from zero and from a start state, with x, B and C in
f32 and bf16, and saves y and the final h.  The second form says, output
by output, whether two such files are equal bit for bit, and exits 1 if
any is not.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

# (B, S, Di, N)
SHAPES = ((4, 1024, 8192, 16), (2, 600, 1024, 16), (1, 77, 200, 64),
          (2, 256, 512, 8), (1, 50, 64, 5))


def run(tree: Path, out: Path) -> None:
    sys.path.insert(0, str(tree.resolve() / "src"))
    import torch
    from repro_torch.kernels import ssm_scan as sk
    outs = {}
    for i, (B, S, Di, N) in enumerate(SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(200 + i)

        def randn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda")
        dt = torch.nn.functional.softplus(randn(B, S, Di))
        A = -torch.exp(randn(Di, N))
        Bs, Cs, x, h0 = randn(B, S, N), randn(B, S, N), randn(B, S, Di), \
            randn(B, Di, N)
        for dtype in (torch.float32, torch.bfloat16):
            ins = (dt, Bs.to(dtype), Cs.to(dtype), x.to(dtype), A)
            for start in (None, h0):
                tag = (f"B{B}_S{S}_Di{Di}_N{N}_{str(dtype).split('.')[1]}_"
                       f"{'zero' if start is None else 'state'}")
                y, h = sk.ssm_scan(*ins, start)
                outs[f"y_{tag}"], outs[f"h_{tag}"] = y, h
    torch.cuda.synchronize()
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.cpu() for k, v in outs.items()}, out)
    print(f"ssm_bitwise: {len(outs)} outputs of {tree} -> {out} "
          f"[{torch.cuda.get_device_name(0)}]")


def compare(a: Path, b: Path) -> int:
    import torch
    x, y = torch.load(a), torch.load(b)
    if x.keys() != y.keys():
        print(f"ssm_bitwise: different outputs {sorted(x)} / {sorted(y)}")
        return 1
    diff = [k for k in x if not torch.equal(x[k], y[k])]
    print(f"ssm_bitwise: {len(x) - len(diff)} of {len(x)} outputs equal "
          f"bit for bit; differing: {diff or 'none'}")
    return 1 if diff else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).parents[1])
    ap.add_argument("--out", type=Path)
    ap.add_argument("--compare", type=Path, nargs=2)
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    if args.out is None:
        ap.error("--out or --compare is needed")
    run(args.tree, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
