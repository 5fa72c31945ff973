"""Background specializer: promote hot call sites to pinned fast paths.

Watches the dispatch statistics every :class:`~repro_torch.core.multiversion.
CompiledKernel` already collects (per shape-signature call counts and the
decision the tree made for each), and when a signature crosses the hot
threshold, installs a :class:`Specialization` — the fully resolved
dispatch decision (variant + precomputed FLOP estimate) — into the
kernel's decision tree. Subsequent calls with that exact signature skip
legality matching and FLOP estimation entirely.

Correctness guarantee (paper §4.1) is preserved by construction: a
specialization only fires on an *exact* signature match, the decision it
replays was produced by the full legality→profitability tree for that
same signature, and every non-matching call — including the first call of
any new shape — still walks the original tree with the user's function as
the terminal fallback.

The thread is optional: ``scan_once()`` gives deterministic, test-friendly
promotion; ``start()`` runs the same scan on an interval.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class Specialization:
    """A pinned dispatch decision for one exact call signature."""

    sig: Tuple
    variant_name: str
    flops: float
    legality_ok: bool
    tier: str = "exact"
    promoted_at: float = field(default_factory=time.monotonic)
    hits: int = 0
    latency_ema: Optional[float] = None   # maintained by CompiledKernel


class Specializer:
    """Registry + promotion loop over compiled kernels.

    ``hot_threshold`` is the call count at which a signature is considered
    hot. Kernels are registered by name; the same registry doubles as the
    serving engine's kernel telemetry source.
    """

    def __init__(self, hot_threshold: int = 16,
                 interval_s: float = 0.05,
                 max_specializations_per_kernel: int = 64,
                 demote_cold_scans: int = 3,
                 cold_after_s: float = 10.0,
                 regress_factor: float = 1.5,
                 min_hits_for_regress: int = 8):
        self.hot_threshold = hot_threshold
        self.interval_s = interval_s
        self.max_per_kernel = max_specializations_per_kernel
        # demotion policy: a pin is dropped when its signature goes cold
        # (no new hits across ``demote_cold_scans`` consecutive scans
        # AND at least ``cold_after_s`` of wall time — the time guard
        # keeps a fast background scan interval from thrashing pins of
        # slow-but-steady callers) or when its per-call latency EMA
        # regresses ``regress_factor``× against the full decision tree's
        # EMA for the same signature
        self.demote_cold_scans = demote_cold_scans
        self.cold_after_s = cold_after_s
        self.regress_factor = regress_factor
        self.min_hits_for_regress = min_hits_for_regress
        self.kernels: Dict[str, Any] = {}
        self.promotions: List[Tuple[str, Specialization]] = []
        self.demotions: List[Tuple[str, Tuple, str]] = []
        # (kernel, sig) → (hits at last scan, consecutive stale scans,
        #                  time the hit count last changed)
        self._hit_marks: Dict[Tuple[str, Tuple],
                              Tuple[int, int, float]] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()

    # -- registry -------------------------------------------------------
    def register(self, kernel, name: Optional[str] = None) -> None:
        with self._lock:
            self.kernels[name or kernel.__name__] = kernel

    def unregister(self, name: str) -> None:
        with self._lock:
            self.kernels.pop(name, None)

    # -- promotion ------------------------------------------------------
    def scan_once(self) -> List[Specialization]:
        """One promotion sweep; returns newly installed specializations."""
        promoted: List[Specialization] = []
        with self._lock:
            kernels = list(self.kernels.items())
        for kname, ck in kernels:
            counts = getattr(ck, "shape_counts", None)
            decisions = getattr(ck, "last_decisions", None)
            installed = getattr(ck, "specializations", None)
            if counts is None or decisions is None or installed is None:
                continue
            # demote first: it can free pin slots for hotter signatures
            self._demote_sweep(kname, ck)
            if len(installed) >= self.max_per_kernel:
                continue
            # snapshot to tolerate concurrent dispatch
            for sig, n in list(counts.items()):
                if n < self.hot_threshold or sig in installed:
                    continue
                dec = decisions.get(sig)
                if dec is None:
                    continue
                variant_name, flops, legality_ok = dec
                spec = Specialization(sig, variant_name, flops,
                                      legality_ok)
                ck.install_specialization(spec)
                self._hit_marks[(kname, sig)] = (0, 0, time.monotonic())
                promoted.append(spec)
                self.promotions.append((kname, spec))
                if len(installed) >= self.max_per_kernel:
                    break
        return promoted

    def _demote_sweep(self, kname: str, ck) -> None:
        """Drop pins that went cold or regressed (ROADMAP demotion item).

        Demoted signatures get their hot-counter reset, so a workload
        that comes back later re-earns its pin through the normal
        promotion path — demotion is a reversible cooldown, not a ban."""
        installed = getattr(ck, "specializations", None)
        if installed is None:
            return
        now = time.monotonic()
        for sig, spec in list(installed.items()):
            reason = None
            key = (kname, sig)
            last_hits, stale, changed_t = self._hit_marks.get(
                key, (0, 0, now))
            if spec.hits == last_hits:
                stale += 1
            else:
                stale, changed_t = 0, now
            self._hit_marks[key] = (spec.hits, stale, changed_t)
            if (stale >= self.demote_cold_scans
                    and now - changed_t >= self.cold_after_s):
                reason = "cold"
            else:
                tree = getattr(ck, "tree_latency", {}).get(sig)
                ema = getattr(spec, "latency_ema", None)
                if (tree is not None and ema is not None
                        and spec.hits >= self.min_hits_for_regress
                        and ema > self.regress_factor * tree):
                    reason = "latency_regression"
            if reason is None:
                continue
            ck.drop_specialization(sig)
            counts = getattr(ck, "shape_counts", None)
            if counts is not None and sig in counts:
                counts[sig] = 0
            self._hit_marks.pop(key, None)
            self.demotions.append((kname, sig, reason))

    # -- background thread ----------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.scan_once()
                except Exception:
                    # promotion is best-effort; never kill the app thread
                    pass

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="automphc-specializer")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=2.0)
        self._thread = None

    def __enter__(self) -> "Specializer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- telemetry ------------------------------------------------------
    def telemetry(self) -> Dict[str, Any]:
        with self._lock:
            kernels = list(self.kernels.items())
        out: Dict[str, Any] = {
            "hot_threshold": self.hot_threshold,
            "promotions": len(self.promotions),
            "demoted": len(self.demotions),
            "running": self._thread is not None,
            "kernels": {},
        }
        for name, ck in kernels:
            stats = ck.stats() if hasattr(ck, "stats") else {}
            out["kernels"][name] = stats
        return out
