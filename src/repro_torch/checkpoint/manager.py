"""Checkpoint lifecycle: rotation, async writes, latest-checkpoint restore
(port of ``repro.checkpoint.manager``).

The training loop calls ``maybe_save(step, state)`` every step; the manager
decides (save_every), copies the state to host memory at once (the port's
train step updates its tensors in place), lets a background thread do the
file I/O while the device keeps stepping, enforces the keep-last-N
rotation, and finds the newest intact checkpoint on restart: kill the
process at any point and ``restore_latest`` resumes from the last durable
step.  ``EngineSnapshot`` is the serving side's warm-restart record, in
the reference's file format.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import zlib
from dataclasses import asdict, dataclass, field
from typing import Any, Optional

import torch

from repro_torch.checkpoint import serialize

_STEP_RE = re.compile(r"^step_(\d{9})$")


def _host_copy(x):
    """A host copy of a tensor leaf that later in-place updates miss."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return x


class CheckpointManager:
    def __init__(self, directory: str, *, save_every: int = 100,
                 keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.save_every = save_every
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- paths ---------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}")

    def checkpoints(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 "MANIFEST.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    # -- save ----------------------------------------------------------------

    def maybe_save(self, step: int, state: Any, *, force: bool = False,
                   extra_meta: Optional[dict] = None) -> bool:
        if not force and (self.save_every <= 0
                          or step % self.save_every != 0):
            return False
        self.wait()                          # one in-flight write at a time
        # snapshot to host NOW: the train step updates tensors in place
        host_state = serialize.map_with_path(state,
                                             lambda _, x: _host_copy(x))

        def write():
            serialize.save_pytree(self._step_dir(step), host_state,
                                  step=step, extra_meta=extra_meta)
            self._rotate()

        if self.async_save:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
        return True

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _rotate(self):
        steps = self.checkpoints()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ---------------------------------------------------------------

    def restore_latest(self, like: Any, *, device=None):
        """-> (state, step) from the newest intact checkpoint, or
        (None, -1) when none exists."""
        steps = self.checkpoints()
        if not steps:
            return None, -1
        step = steps[-1]
        state = serialize.load_pytree(self._step_dir(step), like,
                                      device=device)
        return state, step


# ---------------------------------------------------------------------------
# Engine snapshots: warm restart for the serving side
# ---------------------------------------------------------------------------

_SNAP_FILE = "ENGINE_SNAPSHOT.json"


@dataclass
class EngineSnapshot:
    """Portable serve-engine state: every in-flight and queued request in
    replay-ready form (the tokens to re-prefill + the tokens already
    streamed), plus the engine's cumulative stats and sizing for sanity
    checks at restore.

    This is the serving analog of a train-state checkpoint: the device
    state (KV caches, slot arrays) is deliberately *not* captured — it is
    reconstructed by replaying each request's ``prompt`` through the
    prefill path, which is also exactly how live evacuation replays streams
    (serve/engine._evacuate).  ``requests[i]`` holds
    ``prompt`` (original prompt + every generated token — the replay
    prefix), ``generated`` (tokens already streamed, preserved so the
    restored request keeps counting toward ``max_new_tokens``), ``rid``,
    ``max_new_tokens`` and ``eos_id``.
    """
    requests: list = field(default_factory=list)    # replay-ready dicts
    stats: dict = field(default_factory=dict)
    meta: dict = field(default_factory=dict)        # arch/kv_layout/sizing

    # -- persistence (same tmp+rename crash safety as serialize.save_pytree:
    #    a crash mid-write never corrupts an existing snapshot) -------------

    def save(self, directory: str) -> str:
        tmp = directory + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        # canonical payload JSON + its CRC32, so a snapshot that rotted on
        # disk (or was truncated by a torn copy) fails loud at load
        payload = json.dumps(asdict(self), sort_keys=True,
                             separators=(",", ":"))
        doc = {"crc32": zlib.crc32(payload.encode()), "payload": payload}
        with open(os.path.join(tmp, _SNAP_FILE), "w") as f:
            json.dump(doc, f, indent=1)
        if os.path.exists(directory):
            shutil.rmtree(directory)
        os.rename(tmp, directory)
        return directory

    @classmethod
    def load(cls, directory: str) -> "EngineSnapshot":
        path = os.path.join(directory, _SNAP_FILE)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no engine snapshot at {directory!r} (missing {_SNAP_FILE})")
        with open(path) as f:
            raw = json.load(f)
        if "payload" in raw:       # integrity-wrapped (current) format
            got = zlib.crc32(raw["payload"].encode())
            if got != raw.get("crc32"):
                raise serialize.ChecksumError(
                    f"engine snapshot {path}: stored CRC32 "
                    f"{raw.get('crc32'):#010x} != {got:#010x} — the "
                    f"snapshot is corrupt")
            raw = json.loads(raw["payload"])
        return cls(requests=raw.get("requests", []),
                   stats=raw.get("stats", {}), meta=raw.get("meta", {}))
