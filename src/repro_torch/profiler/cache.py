"""Persistent specialization cache: compiled variants that survive restarts.

Keyed by ``(source hash, type signature, backend)``. Each entry holds the
generated variant sources plus the schedule metadata ``core/codegen.py``
produced, so a warm process rebuilds the multi-version dispatcher by
``exec``-ing stored source — skipping parse → SCoP → dependence →
schedule → codegen entirely. This is what turns the per-script compiler
into a serving-grade system: cold compile once, warm-start everywhere.

Everything stored is either generated Python source (text) or plain
dataclasses (``Schedule``/TIR/``TypeInfo`` — no callables), so pickle is
safe and stable. Writes are atomic (tempfile + ``os.replace``) so
concurrent processes sharing one cache directory never observe torn
entries; last-writer-wins is fine because entries are deterministic
functions of their key.
"""

from __future__ import annotations

import hashlib
import inspect
import json
import os
import pickle
import tempfile
import textwrap
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

_PICKLE_PROTO = 4
_FORMAT_VERSION = 1


def source_hash(fn_or_src) -> str:
    """Stable digest of a kernel's (dedented) source text."""
    if callable(fn_or_src):
        src = textwrap.dedent(inspect.getsource(fn_or_src))
    else:
        src = textwrap.dedent(str(fn_or_src))
    return hashlib.sha256(src.encode()).hexdigest()[:16]


def cache_key(src_hash: str, type_sig: str, backend: str) -> str:
    raw = f"v{_FORMAT_VERSION}|{src_hash}|{type_sig}|{backend}"
    return hashlib.sha256(raw.encode()).hexdigest()[:24]


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    puts: int = 0
    errors: int = 0
    # compiles that were skipped entirely thanks to a hit
    codegen_skipped: int = 0
    # entries evicted by prune()/auto-prune
    pruned: int = 0
    # hits satisfied from / entries published to the shared store
    shared_hits: int = 0
    shared_puts: int = 0

    def as_dict(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "puts": self.puts, "errors": self.errors,
                "codegen_skipped": self.codegen_skipped,
                "pruned": self.pruned,
                "shared_hits": self.shared_hits,
                "shared_puts": self.shared_puts}


@dataclass
class CacheEntry:
    """One compiled kernel: schedule + generated variant sources."""

    fn_name: str
    src_hash: str
    type_sig: str
    backend: str
    params: List[Tuple[str, Any]]       # (name, TypeInfo)
    sched: Any                          # core.schedule.Schedule
    generated: Dict[str, Any]           # variant name → GeneratedVariant
    compile_s: float = 0.0              # cold compile wall time
    created_at: float = field(default_factory=time.time)


class VariantCache:
    """On-disk store of :class:`CacheEntry` objects.

    A fresh ``VariantCache(same_dir)`` in a new process sees every entry
    the old process put — that is the whole point.
    """

    def __init__(self, cache_dir: str, max_entries: Optional[int] = None,
                 max_bytes: Optional[int] = None,
                 shared_dir: Optional[str] = None):
        self.cache_dir = os.path.abspath(os.path.expanduser(cache_dir))
        os.makedirs(self.cache_dir, exist_ok=True)
        self.stats = CacheStats()
        # size caps enforced on put (LRU eviction); None = unbounded
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self._puts_since_sweep = 0
        # two-tier shared store (ROADMAP "cross-node cache sharing"):
        # ``shared_dir`` names a fleet-wide directory (NFS mount, synced
        # volume, container-image bake). Local misses fall through to it
        # (fetched entries are copied local), local puts publish to it —
        # so one cold compile anywhere warm-starts every node.
        self.shared_dir = None
        if shared_dir is not None:
            self.shared_dir = os.path.abspath(
                os.path.expanduser(shared_dir))
            os.makedirs(self.shared_dir, exist_ok=True)

    # -- paths ----------------------------------------------------------
    def _path(self, key: str) -> str:
        return os.path.join(self.cache_dir, f"{key}.pkl")

    # -- core API -------------------------------------------------------
    def get(self, src_hash: str, type_sig: str,
            backend: str) -> Optional[CacheEntry]:
        key = cache_key(src_hash, type_sig, backend)
        path = self._path(key)
        if not os.path.exists(path):
            if not self._fetch_shared(key):
                self.stats.misses += 1
                return None
        try:
            with open(path, "rb") as f:
                entry = pickle.load(f)
        except Exception:
            # corrupt/stale entry: treat as miss, drop it
            self.stats.errors += 1
            self.stats.misses += 1
            try:
                os.unlink(path)
            except OSError:
                pass
            return None
        self.stats.hits += 1
        try:
            os.utime(path, None)  # LRU touch: mtime = last use
        except OSError:
            pass
        return entry

    def put(self, entry: CacheEntry) -> str:
        key = cache_key(entry.src_hash, entry.type_sig, entry.backend)
        path = self._path(key)
        fd, tmp = tempfile.mkstemp(dir=self.cache_dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump(entry, f, protocol=_PICKLE_PROTO)
            os.replace(tmp, path)
        except Exception:
            self.stats.errors += 1
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self.stats.puts += 1
        self._publish_shared(key)
        self._auto_prune()
        return key

    # -- shared-store backend -------------------------------------------
    def _shared_path(self, key: str) -> Optional[str]:
        if self.shared_dir is None:
            return None
        return os.path.join(self.shared_dir, f"{key}.pkl")

    def _fetch_shared(self, key: str) -> bool:
        """Local miss → pull the entry from the shared store (atomic
        copy into the local tier). Returns True when the local file now
        exists."""
        spath = self._shared_path(key)
        if spath is None or not os.path.exists(spath):
            return False
        try:
            with open(spath, "rb") as f:
                data = f.read()
            fd, tmp = tempfile.mkstemp(dir=self.cache_dir, suffix=".tmp")
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, self._path(key))
            self.stats.shared_hits += 1
            return True
        except OSError:
            self.stats.errors += 1
            return False

    def _publish_shared(self, key: str) -> None:
        spath = self._shared_path(key)
        if spath is None or os.path.exists(spath):
            return
        try:
            with open(self._path(key), "rb") as f:
                data = f.read()
            fd, tmp = tempfile.mkstemp(dir=self.shared_dir,
                                       suffix=".tmp")
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, spath)
            self.stats.shared_puts += 1
        except OSError:
            self.stats.errors += 1

    def _auto_prune(self) -> None:
        """Enforce the constructor caps. Eviction goes 10% below the cap
        so the stat() sweep amortizes over many puts instead of running
        on every insertion once the store sits at capacity; a byte-only
        cap (whose check itself needs the sweep) is polled every 16th
        put rather than on each one."""
        if self.max_entries is None and self.max_bytes is None:
            return
        self._puts_since_sweep += 1
        if self.max_entries is not None:
            over = len(self.entries()) > self.max_entries
        else:
            over = self._puts_since_sweep >= 16
        if over:
            self._puts_since_sweep = 0
            self.prune(
                max_entries=None if self.max_entries is None
                else max(1, int(self.max_entries * 0.9)),
                max_bytes=None if self.max_bytes is None
                else max(1, int(self.max_bytes * 0.9)))

    # -- maintenance ----------------------------------------------------
    def entries(self) -> List[str]:
        return sorted(k[:-4] for k in os.listdir(self.cache_dir)
                      if k.endswith(".pkl"))

    def clear(self) -> int:
        n = 0
        for name in os.listdir(self.cache_dir):
            if name.endswith(".pkl"):
                os.unlink(os.path.join(self.cache_dir, name))
                n += 1
        return n

    def prune(self, max_entries: Optional[int] = None,
              max_bytes: Optional[int] = None,
              max_age_s: Optional[float] = None) -> int:
        """LRU/size-cap eviction; returns the number of entries removed.

        Ordering comes from the same timestamps ``index.json`` reports:
        each entry's last-used time (file mtime, bumped on every hit by
        :meth:`get`, falling back to ``created_at``). ``max_age_s`` drops
        entries idle longer than the given age; ``max_entries`` /
        ``max_bytes`` then evict least-recently-used entries until the
        store fits. The sweep is stat()-based — entries are never
        deserialized — and an existing ``index.json`` has the evicted
        keys filtered out in place (a full metadata rebuild is
        :meth:`dump_index`); auto-prune additionally evicts 10% below
        the cap so this sweep amortizes across puts."""
        infos = []
        for key in self.entries():
            path = self._path(key)
            try:
                st = os.stat(path)
                infos.append((st.st_mtime, st.st_size, key, path))
            except OSError:
                continue
        infos.sort()  # oldest last-use first
        now = time.time()
        drop = []
        if max_age_s is not None:
            drop.extend(i for i in infos if now - i[0] > max_age_s)
        dropped = {i[2] for i in drop}
        kept = [i for i in infos if i[2] not in dropped]
        if max_entries is not None:
            while len(kept) > max_entries:
                drop.append(kept.pop(0))
        if max_bytes is not None:
            total = sum(i[1] for i in kept)
            while kept and total > max_bytes:
                victim = kept.pop(0)
                total -= victim[1]
                drop.append(victim)
        removed = 0
        dropped_keys = set()
        for _, _, key, path in drop:
            try:
                os.unlink(path)
                removed += 1
                dropped_keys.add(key)
            except OSError:
                pass
        if removed:
            self.stats.pruned += removed
            self._drop_from_index(dropped_keys)
        return removed

    def _drop_from_index(self, keys: set) -> None:
        """Filter evicted keys out of an existing index.json (cheap; a
        full rebuild with fresh metadata is :meth:`dump_index`)."""
        path = os.path.join(self.cache_dir, "index.json")
        if not os.path.exists(path):
            return
        try:
            with open(path) as f:
                idx = json.load(f)
            idx = [e for e in idx if e.get("key") not in keys]
            with open(path, "w") as f:
                json.dump(idx, f, indent=2)
        except Exception:
            pass  # index is advisory; never break eviction over it

    def telemetry(self) -> Dict[str, Any]:
        return {"dir": self.cache_dir,
                "entries": len(self.entries()),
                **self.stats.as_dict()}

    def dump_index(self) -> str:
        """Write a human-readable index.json next to the entries."""
        idx = []
        for key in self.entries():
            try:
                path = self._path(key)
                with open(path, "rb") as f:
                    e = pickle.load(f)
                idx.append({"key": key, "fn": e.fn_name,
                            "type_sig": e.type_sig, "backend": e.backend,
                            "compile_s": round(e.compile_s, 4),
                            "created_at": e.created_at,
                            "last_used": os.stat(path).st_mtime})
            except Exception:
                continue
        path = os.path.join(self.cache_dir, "index.json")
        with open(path, "w") as f:
            json.dump(idx, f, indent=2)
        return path
