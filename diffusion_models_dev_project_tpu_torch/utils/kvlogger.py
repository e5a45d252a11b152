"""Key-value metrics logger with timing helpers.

The port's own copy of the JAX package's `utils/kvlogger.py` (which imports
no JAX; the port imports nothing of that package): `logkv`/`logkv_mean`/
`dumpkvs` accumulation, human/JSONL/CSV writers, and `profile_kv`/
`@profile` wall-time helpers, counterpart of the reference's vendored
OpenAI-baselines logger.
"""
from __future__ import annotations

import contextlib
import csv
import functools
import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional

__all__ = ["KVLogger", "configure", "logkv", "logkv_mean", "dumpkvs",
           "profile_kv", "profile", "get_current"]


class KVLogger:
    def __init__(self, log_dir: Optional[str] = None,
                 formats: tuple = ("stdout", "jsonl")):
        self.log_dir = log_dir
        self._kv: Dict[str, float] = {}
        self._sums: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        self._files = {}
        self._csv_keys = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            if "jsonl" in formats:
                self._files["jsonl"] = open(
                    os.path.join(log_dir, "progress.jsonl"), "a")
            if "csv" in formats:
                self._files["csv"] = open(
                    os.path.join(log_dir, "progress.csv"), "a", newline="")
        self._stdout = "stdout" in formats

    def logkv(self, key: str, val) -> None:
        self._kv[key] = float(val)

    def logkv_mean(self, key: str, val) -> None:
        """Running mean until the next dump (reference logger.py:logkv_mean)."""
        self._sums[key] += float(val)
        self._counts[key] += 1
        self._kv[key] = self._sums[key] / self._counts[key]

    def dumpkvs(self) -> Dict[str, float]:
        kv = dict(sorted(self._kv.items()))
        if self._stdout and kv:
            width = max(len(k) for k in kv)
            lines = [f"| {k.ljust(width)} | {v:<12.6g} |" for k, v in kv.items()]
            sep = "-" * len(lines[0])
            print("\n".join([sep, *lines, sep]))
        if "jsonl" in self._files and kv:
            self._files["jsonl"].write(json.dumps({**kv, "_time": time.time()})
                                       + "\n")
            self._files["jsonl"].flush()
        if "csv" in self._files and kv:
            f = self._files["csv"]
            if self._csv_keys != list(kv):
                self._csv_keys = list(kv)
                csv.writer(f).writerow(self._csv_keys)
            csv.writer(f).writerow([kv[k] for k in self._csv_keys])
            f.flush()
        self._kv.clear()
        self._sums.clear()
        self._counts.clear()
        return kv

    @contextlib.contextmanager
    def profile_kv(self, name: str):
        """Accumulate wall time under `time/<name>` (logger.py:profile_kv)."""
        t0 = time.time()
        try:
            yield
        finally:
            self._sums[f"time/{name}"] += time.time() - t0
            self._counts[f"time/{name}"] = 1
            self._kv[f"time/{name}"] = self._sums[f"time/{name}"]


_CURRENT = KVLogger()


def configure(log_dir: Optional[str] = None,
              formats: tuple = ("stdout", "jsonl")) -> KVLogger:
    global _CURRENT
    _CURRENT = KVLogger(log_dir, formats)
    return _CURRENT


def get_current() -> KVLogger:
    return _CURRENT


def logkv(key, val):
    _CURRENT.logkv(key, val)


def logkv_mean(key, val):
    _CURRENT.logkv_mean(key, val)


def dumpkvs():
    return _CURRENT.dumpkvs()


def profile_kv(name):
    return _CURRENT.profile_kv(name)


def profile(name_or_fn):
    """Decorator timing every call under `time/<name>` (logger.py:@profile)."""
    if callable(name_or_fn):
        return profile(name_or_fn.__name__)(name_or_fn)

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with _CURRENT.profile_kv(name_or_fn):
                return fn(*a, **kw)
        return wrapped

    return deco
