"""Device health checks (port of ``repro.ft.health`` for torch devices).

``check_devices`` runs a short proof-of-work on every device it is given
(``x @ x.T`` summed over a 256 x 256 ``arange / n²``, whose checksum is
known) and reports per-device pass/fail + latency with a structured
:class:`HealthReason`.  Serving runs it on the engine's health cadence
(``ServeEngine(health_every=...)``); a failed device makes the engine
evacuate, which on one device is an in-place rebuild.

The proof of work is not a kernel of the reference either (it is a jnp
matmul), so it runs as a plain ``torch.matmul`` on each device.  The
reference checksum is computed once per process and device type and
cached: the gate runs every few ticks on the serving hot path.
"""
from __future__ import annotations

import enum
import time
from dataclasses import dataclass

import torch


class HealthReason(enum.Enum):
    """Structured failure cause, read by the serve engine's escalation log
    (no string parsing between watchdog and policy)."""
    OK = "ok"
    CHECKSUM_MISMATCH = "checksum_mismatch"
    TIMEOUT = "timeout"
    EXECUTION_ERROR = "execution_error"
    INJECTED = "injected_fault"
    # silent data corruption: a registered fingerprint (params checksum,
    # sealed KV block) no longer matches — ft/integrity.py detection,
    # escalated by the engine's scrub / health gate
    DATA_CORRUPTION = "data_corruption"


@dataclass
class DeviceHealth:
    device: str
    ok: bool
    latency_s: float
    reason: HealthReason = HealthReason.OK
    detail: str = ""

    @property
    def error(self) -> str:
        """Legacy formatted-string view of (reason, detail)."""
        return "" if self.ok else f"{self.reason.value}: {self.detail}"


def device_id(device) -> int:
    """The id a fault plan's ``device=`` names: the CUDA index, 0 for the
    CPU (the reference's single CPU device is id 0 too)."""
    d = torch.device(device)
    return d.index if d.index is not None else 0


def _proof_of_work(device, n: int = 256) -> float:
    x = (torch.arange(n * n, dtype=torch.float32, device=device)
         .reshape(n, n) / (n * n))
    return float(torch.sum(x @ x.T))


# one reference checksum per device type for the process
_POW_EXPECT: dict = {}


def _pow_expect(device) -> float:
    kind = torch.device(device).type
    if kind not in _POW_EXPECT:
        _POW_EXPECT[kind] = _proof_of_work(device)
    return _POW_EXPECT[kind]


def default_devices() -> list:
    """Every CUDA device, else the CPU."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def check_devices(devices=None, timeout_s: float = 30.0) -> list[DeviceHealth]:
    devices = [torch.device(d) for d in (devices or default_devices())]
    out = []
    for d in devices:
        t0 = time.perf_counter()
        try:
            expect = _pow_expect(d)
            got = _proof_of_work(d)
            dt = time.perf_counter() - t0
            if abs(got - expect) >= 1e-3 * max(abs(expect), 1.0):
                out.append(DeviceHealth(
                    str(d), False, dt, HealthReason.CHECKSUM_MISMATCH,
                    f"checksum {got} != {expect}"))
            elif dt >= timeout_s:
                out.append(DeviceHealth(
                    str(d), False, dt, HealthReason.TIMEOUT,
                    f"proof-of-work took {dt:.3f}s >= {timeout_s}s"))
            else:
                out.append(DeviceHealth(str(d), True, dt))
        except Exception as e:  # noqa: BLE001 - any failure = unhealthy
            out.append(DeviceHealth(str(d), False,
                                    time.perf_counter() - t0,
                                    HealthReason.EXECUTION_ERROR, repr(e)))
    return out


def all_healthy(reports: list[DeviceHealth]) -> bool:
    return all(r.ok for r in reports)

