"""Process-wide device-dispatch counter: a copy of
perceive_tpu/utils/dispatchmeter.py, with its sites in the port.

Each served request should cost as few device round trips as possible:
the uncontended hot path is ONE fused encode + sweep per request, with
the highlight chunks answered from the warmed cache.  This counter
instruments the dispatch chokepoints so that /metrics exports the real
dispatches-per-request ratio, and a new code path that sneaks in an extra
round trip shows up on a dashboard instead of in a latency histogram.

Sites counted (each is one launch sequence read back to the host):

  searcher._device_scan           one sweep
  searcher.search_fused           the fused encode + sweep (+ aux encode)
  model._dispatch_chunk           a dispatched document/query encode
  model.encode_token_batch        a blocking batch encode: a non-fused
                                  query encode, a highlight chunk batch

The JAX package counts neither of the last site's two uses, so its
dispatches-per-request reads low whenever a query is encoded outside the
fused path or a highlight misses the chunk cache; the port counts both.

The counter is advisory telemetry: a plain int under a lock.
"""

from __future__ import annotations

import contextlib
import threading

_lock = threading.Lock()
_counts: dict[str, int] = {"total": 0}
_local = threading.local()


@contextlib.contextmanager
def attributed(site: str):
    """Re-attribute every dispatch on THIS thread to ``site`` while the
    context is active: the serve warm-up wraps itself in
    ``attributed("warmup")`` and the background refresh in
    ``attributed("refresh")``, so that neither pollutes the serving
    dispatches-per-request ratio."""
    prev = getattr(_local, "override", None)
    _local.override = site
    try:
        yield
    finally:
        _local.override = prev


def current_site():
    """This thread's ``attributed`` site, or None outside one (a thread
    that works for another, such as an ingest stage, takes it over)."""
    return getattr(_local, "override", None)


def count(site: str, n: int = 1) -> None:
    """Record ``n`` device dispatches attributed to ``site`` (or to the
    thread's ``attributed`` override when one is active)."""
    site = getattr(_local, "override", None) or site
    with _lock:
        _counts["total"] = _counts.get("total", 0) + n
        _counts[site] = _counts.get(site, 0) + n


def total() -> int:
    with _lock:
        return _counts.get("total", 0)


def snapshot() -> dict[str, int]:
    """Copy of all per-site counters (plus "total")."""
    with _lock:
        return dict(_counts)


def reset() -> None:
    """Tests only: zero every counter."""
    with _lock:
        _counts.clear()
        _counts["total"] = 0
