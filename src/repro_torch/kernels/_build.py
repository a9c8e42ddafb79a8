"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process into a
shared library with a plain C interface (``-gencode
arch=compute_90a,code=sm_90a``), loaded with ``ctypes``.  All missing
libraries are built together, in parallel, at the first launch of any
kernel.  The output lands in ``build/repro_torch/<name>-<hash>/`` at the
root of the checkout (listed in ``.gitignore``), keyed by a hash of the
sources and the flags, so an edited source is rebuilt and an unchanged one
is loaded as it is.

Nothing here runs at import: ``import repro_torch`` works on a machine
without ``nvcc``.  A missing ``nvcc`` or a failed build raises; the
kernels never fall back to their plain versions.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

SOURCES = ("flash_attention", "flash_attention_bwd", "fused_ffn",
           "fused_ffn_bwd", "decode_attention", "paged_attention",
           "mlstm_scan", "mlstm_scan_bwd", "quant", "ssm_scan",
           "ssm_scan_bwd")
CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``nvcc`` on PATH, else the toolkit's
    default location.  Raises when there is none."""
    path = shutil.which("nvcc")
    if path is None and os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: repro_torch builds its CUDA kernels from "
            "src/repro_torch/csrc at first use and needs the CUDA toolkit "
            "(sm_90a support) on PATH or under /usr/local/cuda")
    return path


def _inputs(name: str) -> list[Path]:
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _inputs(name):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def build_all() -> float:
    """Compile every kernel library that is not built yet, one ``nvcc`` per
    source, all started together.  Returns the wall seconds spent; the
    compiler's report (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside each library as ``build.log``."""
    todo = {n: lib_path(n) for n in SOURCES if not lib_path(n).exists()}
    if not todo:
        return 0.0
    exe = nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, out in todo.items():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        (out.parent / "build.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n"
                          f"{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built first if needed)."""
    if name not in SOURCES:
        raise KeyError(f"no kernel source {name!r}; SOURCES: {SOURCES}")
    if name not in _libs:
        if not lib_path(name).exists():
            build_all()
        lib = ctypes.CDLL(str(lib_path(name)))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


def check(name: str, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (the C entry points return
    ``cudaGetLastError()`` right after their launches)."""
    if code != 0:
        msg = library(name).repro_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


_CURRENT = contextlib.nullcontext()
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_handle(dev) -> int:
    """The ``cudaStream_t`` of ``dev``'s current stream, as an int: from
    PyTorch's raw accessor where the build has one (the public
    ``torch.cuda.current_stream`` builds a ``Stream`` object a call, a few
    microseconds of a short kernel's enqueue)."""
    if _RAW_STREAM is None:
        return torch.cuda.current_stream(dev).cuda_stream
    return _RAW_STREAM(torch.cuda.current_device() if dev.index is None
                       else dev.index)


def on_device(dev) -> contextlib.AbstractContextManager:
    """The device guard a launch on ``dev`` needs: none when ``dev`` is
    the current device (a launch's common case, where entering
    ``torch.cuda.device`` would set the device twice for nothing)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return _CURRENT
    return torch.cuda.device(dev)
