#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py                    # every phase, as a check
    python3 chip_smoke.py --phases kernels   # a subset, while iterating

Phases, in order, each printing one line:

  gpu      the card's name and power limit, as nvidia-smi reports them;
  build    builds the three Hopper kernels from src/repro_torch/csrc;
  kernels  holds each kernel against its plain PyTorch version on the card
           at the serving path's shapes, in f32 and bf16, and times the
           kernel, the plain version and one PyTorch library call that
           computes the same function (a yardstick the port never calls);
  model    exanode-100m at full width in f32 with seeded weights: prefill
           and four decode ticks' logits, kernels on the card against the
           plain path on the CPU;
  serve    Runtime.create("exanode-100m", capacity=2048).engine(num_slots=16)
           serves 32 seeded requests in bf16, once cold as a warm-up and
           once warm on a fresh engine, with every kernel's launch counter
           zeroed just before the warm run and read just after.

Then one JSON line {"kernels": [...]} and, last, {"ok": true, "device":
...}.  Any failed check raises before the last line.  Without a CUDA
device, or without the repository beside it, the script fails.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

PHASES = ("kernels", "model", "serve")      # the build always runs

# NVIDIA H100 SXM data sheet, dense: HBM3 bytes/s and bf16 tensor-core
# FLOP/s.  Rates assume the full 700 W power limit.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12}

# Tolerances: the reference's own (tests/test_kernels.py).
TOL = {"flash_attention": {"float32": 2e-5, "bfloat16": 2e-2},
       "fused_ffn": {"float32": 1e-5, "bfloat16": 3e-2},
       "decode_attention": {"float32": 2e-5, "bfloat16": 2e-2}}
MODEL_LOGITS_TOL = 1e-3


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


class Timer:
    """Per-launch CUDA-event timing with L2 flushed between launches (the
    serving path meets weights and caches cold: its working set is many
    times the 50 MB L2)."""

    def __init__(self, torch, iters: int):
        self.torch, self.iters = torch, iters
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(self.iters):
            self.flush.zero_()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            total += e0.elapsed_time(e1)
        return total / self.iters


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(nb: int, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes, t_ops = nb / PEAK_BYTES_S, flops / PEAK_FLOPS[dtype]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def check(name: str, got, want, dtype: str, what: str) -> float:
    """Max |got - want|; raises unless every element is within
    tol + tol * |want| (numpy's allclose with atol = rtol = tol)."""
    tol = TOL[name][dtype]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not bool((err <= tol + tol * want.abs()).all()) or \
            not bool(got.isfinite().all()):
        raise AssertionError(f"{name} {what} {dtype}: max abs err "
                             f"{float(err.max()):.3g} over tol {tol}")
    return float(err.max())


def kernels_phase(torch, timer) -> dict:
    """Each kernel against its plain version; returns the JSON entries
    (without ``launches``) keyed by kernel name."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_ffn as ffn
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    out = {}

    # flash attention: prefill of 4 prompts x 1024 tokens, q in the
    # [B,S,H,D] -> [B,H,S,D] view the model passes, grouped K/V
    B, S, H, KV, D = 4, 1024, 12, 4, 64
    q32 = randn(B, S, H, D).transpose(1, 2)
    k32 = randn(B, S, KV, D).transpose(1, 2)
    v32 = randn(B, S, KV, D).transpose(1, 2)
    errs = {}
    for dt in (f32, bf16):
        q, k, v = (t.to(dt) for t in (q32, k32, v32))
        o, lse = fa.flash_attention(q, k, v, causal=True)
        wo, wlse = ref.ref_attention(q, k, v, causal=True)
        name = str(dt).split(".")[1]
        errs[name] = check("flash_attention", o, wo, name, "causal")
        check("flash_attention", lse, wlse, "float32", f"causal lse {name}")
    for S2, causal, window in ((1024, True, 256), (1000, False, 0)):
        q, k, v = q32[:, :, :S2], k32[:, :, :S2], v32[:, :, :S2]
        o, _ = fa.flash_attention(q, k, v, causal=causal, window=window)
        wo, _ = ref.ref_attention(q, k, v, causal=causal, window=window)
        check("flash_attention", o, wo, "float32",
              f"S={S2} causal={causal} window={window}")
    q, k, v = (t.to(bf16) for t in (q32, k32, v32))
    flops = 4 * B * H * D * S * (S + 1) / 2            # causal pairs only
    b_ms, b_by = bound(nbytes(q, k, v, q) + B * H * S * 4, flops, "bfloat16")
    out["flash_attention"] = dict(
        shape=f"q [{B},{H},{S},{D}] k/v [{B},{KV},{S},{D}] causal bf16",
        max_abs_err=errs["bfloat16"], max_abs_err_f32=errs["float32"],
        ms=timer.ms(lambda: fa.flash_attention(q, k, v, causal=True)),
        plain_ms=timer.ms(lambda: ref.ref_attention(q, k, v, causal=True)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)),
        library="torch.nn.functional.scaled_dot_product_attention")

    # fused SwiGLU: prefill rows (4 x 1024) and one decode tick (16 slots)
    D, Fd = 768, 2048
    w32 = [randn(D, Fd, scale=D ** -0.5), randn(D, Fd, scale=D ** -0.5),
           randn(Fd, D, scale=Fd ** -0.5)]
    entries = {}
    for N in (4096, 16):
        x32 = randn(N, D)
        errs = {}
        for dt in (f32, bf16):
            x, wg, wu, wd = (t.to(dt) for t in [x32] + w32)
            name = str(dt).split(".")[1]
            errs[name] = check("fused_ffn", ffn.swiglu_ffn(x, wg, wu, wd),
                               ref.ref_swiglu_ffn(x, wg, wu, wd), name,
                               f"N={N}")
        x, wg, wu, wd = (t.to(bf16) for t in [x32] + w32)
        b_ms, b_by = bound(nbytes(x, wg, wu, wd, x), 6 * N * D * Fd,
                           "bfloat16")
        entries[N] = dict(
            shape=f"x [{N},{D}] Wg/Wu [{D},{Fd}] Wd [{Fd},{D}] bf16",
            max_abs_err=errs["bfloat16"], max_abs_err_f32=errs["float32"],
            ms=timer.ms(lambda: ffn.swiglu_ffn(x, wg, wu, wd)),
            plain_ms=timer.ms(lambda: ref.ref_swiglu_ffn(x, wg, wu, wd)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=timer.ms(lambda: torch.matmul(
                F.silu(torch.matmul(x, wg)) * torch.matmul(x, wu), wd)),
            library="three torch.matmul + torch.nn.functional.silu")
    out["fused_ffn"] = dict(entries[4096], decode=entries[16])

    # flash-decode: 16 slots against a 2048-entry cache, part empty
    B, T, KV, G, D = 16, 2048, 4, 3, 64
    H = KV * G
    lens = torch.randint(64, T + 1, (B,), generator=gen, device="cuda")
    t_idx = torch.arange(T, device="cuda")
    kv_pos = torch.where(t_idx[None] < lens[:, None], t_idx[None],
                         -1).to(torch.int32).contiguous()
    pos = (lens - 1).to(torch.int32)
    q32, k32, v32 = randn(B, H, D), randn(B, T, KV, D), randn(B, T, KV, D)
    errs = {}
    for dt in (f32, bf16):
        q, k, v = (t.to(dt) for t in (q32, k32, v32))
        name = str(dt).split(".")[1]
        errs[name] = check(
            "decode_attention", da.decode_attention(q, k, v, kv_pos, pos),
            ref.ref_decode_attention(q, k, v, kv_pos, pos), name,
            "part-empty cache")
    q, k, v = (t.to(bf16) for t in (q32, k32, v32))
    # the function reads only the valid K/V rows (every valid entry is at
    # or before its slot's pos): count those, not the whole cache
    valid = int(lens.sum())
    b_ms, b_by = bound(nbytes(q, kv_pos, pos, q)
                       + 2 * valid * KV * D * k.element_size(),
                       4 * H * D * valid, "bfloat16")
    mask = ((kv_pos >= 0) & (kv_pos <= pos[:, None]))[:, None, None, :]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    out["decode_attention"] = dict(
        shape=f"q [{B},{H},{D}] k/v [{B},{T},{KV},{D}] bf16, "
              f"{valid} of {B * T} entries valid",
        max_abs_err=errs["bfloat16"], max_abs_err_f32=errs["float32"],
        ms=timer.ms(lambda: da.decode_attention(q, k, v, kv_pos, pos)),
        plain_ms=timer.ms(
            lambda: ref.ref_decode_attention(q, k, v, kv_pos, pos)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True)),
        library="torch.nn.functional.scaled_dot_product_attention")
    return out


def model_phase(torch) -> str:
    """Full-width f32 logits: kernels on the card vs plain path on CPU."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.common import init_params, tree_map
    from repro_torch.models.registry import model_specs
    from repro_torch.runtime import Runtime
    cfg = get_config("exanode-100m").scaled(dtype=torch.float32)
    cpu_params = init_params(model_specs(cfg), seed=0)
    gpu_params = tree_map(lambda t: t.to("cuda"), cpu_params)
    sides = {dev: Runtime.create(cfg, capacity=256, device=dev, params=p)
             for dev, p in (("cpu", cpu_params), ("cuda", gpu_params))}
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 128),
                                             dtype=np.int32)
    logits, caches = {}, {}
    for dev, rt in sides.items():
        logits[dev], caches[dev] = rt.prefill(torch.from_numpy(toks).to(dev))
    errs = [float((logits["cuda"].cpu() - logits["cpu"]).abs().max())]
    nxt = logits["cpu"][:, -1].argmax(-1).to(torch.int32)[:, None]
    pos = torch.full((2,), 128, dtype=torch.int32)
    for _ in range(4):
        for dev, rt in sides.items():
            logits[dev] = rt.decode_step(nxt.to(dev), caches[dev],
                                         pos.to(dev))
        errs.append(float((logits["cuda"].cpu() - logits["cpu"]).abs()
                          .max()))
        nxt = logits["cpu"][:, -1].argmax(-1).to(torch.int32)[:, None]
        pos = pos + 1
    if not max(errs) <= MODEL_LOGITS_TOL:
        raise AssertionError(f"model logits max abs err {errs} over "
                             f"{MODEL_LOGITS_TOL}")
    return (f"model: exanode-100m f32, 2 prompts x 128 tokens; max abs "
            f"logits err prefill {errs[0]:.3g}, decode ticks "
            f"{[float(f'{e:.3g}') for e in errs[1:]]} (tol "
            f"{MODEL_LOGITS_TOL})")


def serve_phase(torch, gpu: str) -> tuple[str, dict]:
    """Serves the 32 requests twice, each time on a fresh engine: first
    cold, as a warm-up that meets every prefill bucket and batch size of
    the run (allocator growth, cuBLAS set-up), then warm, with the launch
    counters zeroed just before.  The warm run's figures are the phase's;
    the cold run's wall and prefill are printed beside them."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.runtime import Runtime
    from repro_torch.serve.engine import Request
    rt = Runtime.create("exanode-100m", capacity=2048)
    rng = np.random.default_rng(2)
    n_req, new = 32, 64
    prompts = [rng.integers(0, rt.cfg.vocab_size, int(n), dtype=np.int32)
               for n in rng.integers(64, 1025, n_req)]

    def serve():
        eng = rt.engine(num_slots=16)
        prefill, prefill_s = eng._prefill, [0.0]

        def timed_prefill(*args):
            t0 = time.perf_counter()
            res = prefill(*args)
            torch.cuda.synchronize()
            prefill_s[0] += time.perf_counter() - t0
            return res

        eng._prefill = timed_prefill
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=new))
        stats = eng.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        if stats.finished != n_req or any(len(r.generated) != new
                                          for r in eng.finished):
            counts = sorted(len(r.generated) for r in eng.finished)
            raise AssertionError(f"serve: {stats.summary}; token counts "
                                 f"{counts}")
        return eng, wall, prefill_s[0], launches

    _, cold_wall, cold_prefill, _ = serve()
    eng, wall, prefill_s, launches = serve()
    if not all(launches.values()):
        raise AssertionError(f"serve: a kernel never launched: {launches}")
    stats, lat = eng.stats, eng.latency_summary()
    line = (f"serve: exanode-100m bf16 capacity=2048 slots=16, {n_req} "
            f"requests x {new} new tokens, prompts 64-1024 ({stats.summary});"
            f" warm run after one identical cold run (cold: wall "
            f"{cold_wall:.3f} s, prefill {cold_prefill:.3f} s); wall "
            f"{wall:.3f} s of which prefill {prefill_s:.3f} s; decode "
            f"{stats.tokens_out / (wall - prefill_s):.1f} tok/s; TTFT p50 "
            f"{lat['ttft_p50'] * 1e3:.1f} ms p95 {lat['ttft_p95'] * 1e3:.1f}"
            f" ms; ITL p50 {lat['itl_p50'] * 1e3:.2f} ms p95 "
            f"{lat['itl_p95'] * 1e3:.2f} ms; launches {launches} "
            f"[{gpu}]")
    return line, launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    ap.add_argument("--iters", type=int, default=10,
                    help="timed launches per kernel measurement")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import _build

    gpu = gpu_line()
    print(gpu, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.3f} s for "
          f"{', '.join(_build.SOURCES)} (nvcc, sm_90a)", flush=True)
    # f32 comparisons run in full f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    entries = {}
    if "kernels" in phases:
        entries = kernels_phase(torch, Timer(torch, args.iters))
        print("kernels: " + "; ".join(
            f"{n} {e['ms']:.3f} ms (plain {e['plain_ms']:.3f}, library "
            f"{e['library_ms']:.3f}, bound {e['bound_ms']:.4f} "
            f"{e['bound_by']}) err {e['max_abs_err']:.3g}"
            for n, e in entries.items()) + f"; tolerances {TOL} [{gpu}]",
            flush=True)
    if "model" in phases:
        print(model_phase(torch), flush=True)
    launches = {}
    if "serve" in phases:
        line, launches = serve_phase(torch, gpu)
        print(line, flush=True)
    if entries:
        sources = {"flash_attention": "src/repro/kernels/flash_attention.py:67",
                   "fused_ffn": "src/repro/kernels/fused_ffn.py:50",
                   "decode_attention":
                       "src/repro/kernels/decode_attention.py:28"}
        print(json.dumps({"kernels": [
            dict(name=n, route="cuda",
                 source=f"src/repro_torch/csrc/{n}.cu", replaces=sources[n],
                 launches=launches.get(n), kernel_ms=e["ms"], gpu=gpu, **e)
            for n, e in entries.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
