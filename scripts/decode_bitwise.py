#!/usr/bin/env python3
"""Bit-for-bit comparison of the split-KV decode kernels (#3, #8, #9)
between two checkouts of the repository, on one CUDA card.

    python3 scripts/decode_bitwise.py --tree DIR --out A.pt
    python3 scripts/decode_bitwise.py --compare A.pt B.pt

The first form imports ``repro_torch`` from ``DIR/src`` (building its
kernels into ``DIR/build``), runs the dense (#3), paged (#8) and int8
paged (#9) decode kernels on seeded inputs at G <= 8 q heads a kv head
(the shapes of the configs the port serves: exanode-100m 12 / 4 heads of
64, llama3.2-3b and jamba-v0.1-52b 24 / 8 and 32 / 8 of 128, gemma-2b
8 / 1 of 256, and G 1 and 2), in f32 and bf16, and saves every output.
The second form says, output by output, whether two such files are equal
bit for bit, and exits 1 if any is not.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

SHAPES = ((12, 4, 64), (24, 8, 128), (32, 8, 128), (8, 1, 256), (4, 4, 64),
          (4, 2, 32))
B, T, BS, N = 16, 2048, 16, 2050


def _inputs(torch, H: int, KV: int, D: int, seed: int) -> dict:
    """Seeded dense and paged decode inputs on the card: 16 rows with
    lengths 64-2048, pools of 2050 blocks of 16 in shuffled order."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, T + 1, B)
    t = np.arange(T)
    kv_pos = np.where(t[None] < lens[:, None], t[None], -1).astype(np.int32)
    M = T // BS
    table = np.zeros((B, M), np.int32)
    pos_pool = np.full((N, BS), -1, np.int32)
    free = list(rng.permutation(np.arange(2, N)))
    for b, L in enumerate(lens):
        for j in range(-(-int(L) // BS)):
            bid = table[b, j] = free.pop()
            e = np.arange(j * BS, (j + 1) * BS)
            pos_pool[bid] = np.where(e < L, e, -1)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    kp, vp = randn(N, BS, KV, D), randn(N, BS, KV, D)
    ks, vs = (x.abs().amax(dim=(1, 3)) / 127.0 for x in (kp, vp))
    kq, vq = (torch.round(x / s[:, None, :, None]).to(torch.int8)
              for x, s in ((kp, ks), (vp, vs)))
    dev = lambda a: torch.from_numpy(a).to("cuda")          # noqa: E731
    return dict(q=randn(B, H, D), k=randn(B, T, KV, D), v=randn(B, T, KV, D),
                kv_pos=dev(kv_pos), pos=dev((lens - 1).astype(np.int32)),
                kp=kp, vp=vp, kq=kq, vq=vq, ks=ks, vs=vs,
                pos_pool=dev(pos_pool), table=dev(table))


def run(tree: Path, out: Path) -> None:
    sys.path.insert(0, str(tree.resolve() / "src"))
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_attention as pa
    outs = {}
    for i, (H, KV, D) in enumerate(SHAPES):
        x = _inputs(torch, H, KV, D, seed=100 + i)
        for dt in (torch.float32, torch.bfloat16):
            tag = f"H{H}_KV{KV}_D{D}_{str(dt).split('.')[1]}"
            q = x["q"].to(dt)
            outs[f"decode_{tag}"] = da.decode_attention(
                q, x["k"].to(dt), x["v"].to(dt), x["kv_pos"], x["pos"])
            outs[f"paged_{tag}"] = pa.paged_decode_attention(
                q, x["kp"].to(dt), x["vp"].to(dt), x["pos_pool"],
                x["table"], x["pos"])
            outs[f"paged_q8_{tag}"] = pa.paged_decode_attention_q8(
                q, x["kq"], x["vq"], x["ks"], x["vs"], x["pos_pool"],
                x["table"], x["pos"])
    torch.cuda.synchronize()
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.cpu() for k, v in outs.items()}, out)
    print(f"decode_bitwise: {len(outs)} outputs of {tree} -> {out} "
          f"[{torch.cuda.get_device_name(0)}]")


def compare(a: Path, b: Path) -> int:
    import torch
    x, y = torch.load(a), torch.load(b)
    if x.keys() != y.keys():
        print(f"decode_bitwise: different outputs {sorted(x)} / {sorted(y)}")
        return 1
    diff = [k for k in x if not torch.equal(x[k], y[k])]
    print(f"decode_bitwise: {len(x) - len(diff)} of {len(x)} outputs equal "
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
