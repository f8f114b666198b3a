"""JSON cache of winning configurations, keyed by (kernel, shape, device):
a copy of the JAX package's ``autotune/cache.py`` with its file format, so
either package reads a file the other wrote.

The ``tuned=True`` paths in ``hpl/linpack.py`` and the GEMM op consult
this cache instead of hard-coded constants; on a miss the analytic tuner
runs once and the winner is memoized (and, when a cache file is
configured, persisted).  The port's device keys are the card's name
(``torch.cuda.get_device_name``) and ``torch-cpu``, never the reference's
``cpu`` or ``tpu``, so the two packages' entries do not collide.

File format (version 1)::

    {"version": 1,
     "entries": {
        "dgemm|1024x256x1024|NVIDIA H100 80GB HBM3": {
            "config": {"bm": 64, "bn": 128, "bk": 16},
            "perf_gflops": ..., "power_w": ..., "mflops_per_w": ...,
            "model": "analytic", "perf_loss": ...},
        ...}}

The cache path resolves from, in order: an explicit ``path`` argument,
the ``REPRO_TORCH_AUTOTUNE_CACHE`` environment variable, or in-memory only
(no file I/O) — CI and tests stay hermetic by default.
"""
from __future__ import annotations

import json
import os
import threading
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple, Union

ENV_CACHE_PATH = "REPRO_TORCH_AUTOTUNE_CACHE"
CACHE_VERSION = 1


@dataclass(frozen=True)
class CacheEntry:
    config: Dict[str, Any]
    perf_gflops: float = 0.0
    power_w: float = 0.0
    mflops_per_w: float = 0.0
    model: str = "analytic"        # analytic | measured
    perf_loss: float = 0.0         # vs the searcher's peak-perf point


def cache_key(kernel: str, shape: Sequence[int], device: str) -> str:
    dims = "x".join(str(int(d)) for d in shape)
    return f"{kernel}|{dims}|{device}"


class TuneCache:
    """Thread-safe (kernel, shape, device) → :class:`CacheEntry` store
    with JSON round-tripping."""

    def __init__(self, path: Union[str, Path, None] = None):
        self.path = Path(path) if path is not None else None
        # reentrant: put() holds the lock across its save()
        self._lock = threading.RLock()
        self._entries: Dict[str, CacheEntry] = {}
        if self.path is not None and self.path.exists():
            self.load(self.path)

    # -- access -------------------------------------------------------------
    def get(self, kernel: str, shape: Sequence[int],
            device: str) -> Optional[CacheEntry]:
        with self._lock:
            return self._entries.get(cache_key(kernel, shape, device))

    def put(self, kernel: str, shape: Sequence[int], device: str,
            entry: CacheEntry, *, persist: bool = True) -> None:
        with self._lock:
            self._entries[cache_key(kernel, shape, device)] = entry
            if persist and self.path is not None:
                self.save(self.path)

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._entries))

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    # -- persistence --------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            return {"version": CACHE_VERSION,
                    "entries": {k: asdict(v)
                                for k, v in sorted(self._entries.items())}}

    def save(self, path: Union[str, Path, None] = None) -> Path:
        path = Path(path) if path is not None else self.path
        if path is None:
            raise ValueError("no cache path configured")
        with self._lock:            # snapshot + write serialized together
            path.parent.mkdir(parents=True, exist_ok=True)
            # pid-unique tmp: concurrent processes never share a scratch
            # file; the final rename is atomic on POSIX either way
            tmp = path.with_suffix(path.suffix + f".{os.getpid()}.tmp")
            tmp.write_text(json.dumps(self.to_dict(), indent=1,
                                      sort_keys=True))
            tmp.replace(path)
        return path

    def load(self, path: Union[str, Path]) -> "TuneCache":
        raw = json.loads(Path(path).read_text())
        if raw.get("version") != CACHE_VERSION:
            raise ValueError(f"unsupported cache version "
                             f"{raw.get('version')!r} in {path}")
        entries = {k: CacheEntry(**v) for k, v in raw["entries"].items()}
        with self._lock:
            self._entries.update(entries)
        return self


# ---------------------------------------------------------------------------
# Process-wide default cache (what tuned=True consults)
# ---------------------------------------------------------------------------

_default: Optional[TuneCache] = None
_default_lock = threading.Lock()


def default_cache() -> TuneCache:
    """The singleton cache behind the ``tuned=True`` paths.  File-backed
    iff ``REPRO_TORCH_AUTOTUNE_CACHE`` names a path; in-memory otherwise."""
    global _default
    with _default_lock:
        if _default is None:
            _default = TuneCache(os.environ.get(ENV_CACHE_PATH) or None)
        return _default


def set_default_cache(cache: Optional[TuneCache]) -> None:
    """Swap the singleton (tests; None re-resolves from the env)."""
    global _default
    with _default_lock:
        _default = cache
