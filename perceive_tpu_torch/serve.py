"""HTTP service: port of perceive_tpu/serve.py, the desktop-app host analog.

The reference's Tauri host exposes three commands to its webview
(load_status, get_sources, search; src-tauri/main.rs:25-55).  Here they are
a small JSON-over-HTTP API on the stdlib threading server:

    GET  /status              -> {"model_loaded": bool, "searcher_built": bool, ...}
    GET  /events              -> SSE: load_status on connect and at readiness
    GET  /sources             -> [{id, name, type, location, status}, ...]
    GET  /search?q=...&k=10   -> [{id, score, title, url, snippet, source, time}, ...]
    POST /search {"q": ...}   -> same
    GET  /metrics             -> Prometheus text

Models and the searcher load on a background thread at startup (the
AsyncBuilder pattern, src-tauri/app_state.rs:75-127): requests before
readiness get 503 {"status": "loading"} rather than blocking.

Readiness covers the kernels: the warm-up before it builds the kernel
library (an nvcc run on a fresh build directory) and launches the text
query's sweep, and a failure there sets ``error``, so that /status reports
it and every gated route answers 503.  The JAX package prints such a
failure and declares itself ready, to answer every query with a 500.  Only
the background warmers after readiness are best-effort.
"""

from __future__ import annotations

import json
import os
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional
from urllib.parse import parse_qs, urlsplit

import numpy as np

from .utils import dispatchmeter

# The search page (the reference shipped a SvelteKit webview: a debounced
# search box, a result list and a load-status banner).  A copy of the JAX
# package's page, loaded once at import so that a missing data file fails
# at startup, not on the first page hit.
_INDEX_HTML = Path(__file__).with_name("serve_ui.html").read_text(encoding="utf-8")

# dispatch sites that are not serving traffic: subtracted from the
# dispatches-per-request ratio
_NOT_SERVED = ("warmup", "refresh")


class ServeState:
    """Readiness-gated holder (AsyncBuilder analog).

    Once the app is built, a BatchingSearchExecutor coalesces concurrent
    /search requests into shared device sweeps (the scan cost is per sweep,
    not per query: see index/executor.py).  ``stop`` ends the refresh loop
    and the warmers, closes the executor and the highlight batcher, and
    joins every thread this holder started."""

    def __init__(
        self,
        builder,
        refresh_interval: Optional[float] = None,
        refresh_prune: bool = False,
    ):
        self.ready = threading.Event()
        self.error: Optional[str] = None
        self.app = None
        self.executor = None
        self.highlighter = None  # coalesces highlight chunk-encodes
        self.refresh_scans_total = 0
        self.refresh_errors_total = 0
        self.highlight_warmed_total = 0
        # dispatch-counter baseline at readiness: warm-up and refresh
        # dispatches must not pollute the serving dispatches-per-request
        self.dispatches_at_ready: Optional[dict] = None
        self._stop_refresh = threading.Event()
        # the background warmers started at readiness (joinable)
        self.warmers: list[threading.Thread] = []

        def build():
            try:
                self.app = builder()
                if self.app is not None and self.app.searcher is not None and not self._stop_refresh.is_set():
                    from .index import BatchingSearchExecutor
                    from .models.highlight import highlight_batch
                    from .utils.coalesce import CoalescingBatcher

                    self.executor = BatchingSearchExecutor(
                        self.app.searcher,
                        model=self.app.model,
                        aux_model=self.app.highlights_model,
                    )
                    # N concurrent queries' highlights share ONE chunk
                    # encode (models/highlight.highlight_batch); each request
                    # carries the query embedding the fused search already
                    # computed, and repeat documents hit the chunk cache: a
                    # fully warm query highlights with ZERO device dispatches
                    hl_model = self.app.highlights_model
                    self.highlighter = CoalescingBatcher(
                        lambda batch: highlight_batch(
                            hl_model,
                            [(q, d) for q, d, _ in batch],
                            [e for _, _, e in batch],
                        ),
                        name="highlight-batcher",
                    )
                    self._warm()
            except Exception as e:  # noqa: BLE001 — reported by /status, gated by 503
                self.error = str(e) or type(e).__name__
                print(f"serve: not ready: {self.error}", file=sys.stderr)
            finally:
                self.dispatches_at_ready = dispatchmeter.snapshot()
                self.ready.set()
            if self.app is not None and self.error is None and not self._stop_refresh.is_set():
                # background, after readiness: pre-fill the highlight chunk
                # cache (most recently accessed items first) so that
                # FIRST-seen queries also highlight without a dispatch, and
                # run the coalesced-load shapes once
                for target, name in ((self._warm_highlights, "serve-warm-highlights"),
                                     (self._warm_batch_shapes, "serve-warm-batch-shapes")):
                    t = threading.Thread(target=target, daemon=True, name=name)
                    self.warmers.append(t)
                    t.start()
            if self.app is not None and self.error is None and refresh_interval:
                with dispatchmeter.attributed("refresh"):
                    self._refresh_loop(refresh_interval, refresh_prune)

        self._build_thread = threading.Thread(target=build, daemon=True, name="serve-build")
        self._build_thread.start()

    def _refresh_loop(self, interval: float, prune: bool) -> None:
        """Background due-source rescans so that the served index stays
        fresh (the reference's desktop host had none: its `refresh` command
        was a stub, cmd.rs:31).  Ingest and the query executor share the
        device safely: the matrix lock covers capture through launch
        (index/matrix.device_view).  Runs under ``attributed("refresh")``:
        its encodes and sweeps are not served dispatches.

        Failures are isolated PER SOURCE: one broken source must not stop
        the others from refreshing, and a failed scan counts as an error
        (its status goes to "error" via _run_scan), not a success."""
        from .cli.commands import _due_sources, _run_scan

        first = True
        # sources already overdue at startup rescan right after readiness
        # instead of waiting out a full interval
        while first or not self._stop_refresh.wait(interval):
            first = False
            try:
                due = _due_sources(self.app)
            except Exception as e:  # noqa: BLE001 — keep serving on failure
                self.refresh_errors_total += 1
                print(f"background refresh failed: {e}", file=sys.stderr)
                continue
            m = self.app.searcher.matrix if self.app.searcher else None
            pre_key = None if m is None else (m.sweep_rows, m.quant_bits, m.coarse_trusted)
            for src in due:
                if self._stop_refresh.is_set():
                    return
                try:
                    ok = _run_scan(self.app, src, None, prune, quiet=True)
                except Exception as e:  # noqa: BLE001
                    ok = False
                    print(f"background refresh of {src.name} failed: {e}", file=sys.stderr)
                if ok:
                    self.refresh_scans_total += 1
                else:
                    self.refresh_errors_total += 1
            # a rescan that grew the sweep across a bucket or re-tiered the
            # matrix changes the served route: warm it here, off the request
            # path.  Best-effort: the server is already serving
            if due and pre_key is not None and (m.sweep_rows, m.quant_bits, m.coarse_trusted) != pre_key:
                try:
                    self._warm()
                except Exception as e:  # noqa: BLE001
                    print(f"serve re-warm failed (continuing): {e}", file=sys.stderr)

    def _warm_batch_shapes(self) -> None:
        """Run the concurrent-serving shapes once in the background: batched
        query encodes at both short-query sequence buckets, the matching
        coalesced sweeps, the aux (highlights) model's batch encodes and a
        larger highlight chunk batch.  Off with
        PERCEIVE_TPU_WARM_BATCH_SHAPES=0."""
        if os.environ.get("PERCEIVE_TPU_WARM_BATCH_SHAPES", "") == "0":
            return
        app = self.app
        if app is None or app.searcher is None or not len(app.searcher.matrix):
            return
        with dispatchmeter.attributed("warmup"):
            self._warm_batch_shapes_inner(app)

    def _warm_batch_shapes_inner(self, app) -> None:
        try:
            short = "warm {}"
            longer = ("warm up the next query length bucket with a sentence "
                      "of around twenty five tokens in total number {}")
            for qn in (8, 64):
                for text in (short, longer):
                    if self._stop_refresh.is_set():
                        return
                    vecs = app.model.encode([text.format(i) for i in range(qn)])
                    app.searcher.search_vectors_batch(np.asarray(vecs, np.float32), 10)
                    if app.highlights_model is not app.model:
                        app.highlights_model.encode([text.format(i) for i in range(qn)])
            # concurrent highlight loads coalesce many docs' chunks into
            # one encode: touch a larger chunk-count bucket too
            app.highlights_model.highlight("warmup", ["warm the chunk ladder " * 12] * 24)
        except Exception as e:  # noqa: BLE001 — after readiness, warming is best-effort
            print(f"batch-shape warmup failed (continuing): {e}", file=sys.stderr)

    def _warm_highlights(self) -> None:
        """Pre-fill the highlight chunk cache from the corpus, most recently
        accessed first, up to the cache's doc/byte budget.  With the cache
        warm, EVERY query (not just ones whose result documents repeat)
        costs a single fused dispatch.  Off with
        PERCEIVE_TPU_WARM_HIGHLIGHTS=0."""
        if os.environ.get("PERCEIVE_TPU_WARM_HIGHLIGHTS", "") == "0":
            return
        with dispatchmeter.attributed("warmup"):
            self._warm_highlights_inner()

    def _warm_highlights_inner(self) -> None:
        try:
            from .models.highlight import _cache_for, precompute_chunks

            model = self.app.highlights_model
            cache = _cache_for(model)
            if cache is None or self.app.searcher is None:
                return
            rows = self.app.db.read().execute(
                """SELECT content FROM items
                   WHERE hidden_at IS NULL AND skipped IS NULL
                     AND content IS NOT NULL AND content != ''
                   ORDER BY COALESCE(last_accessed, 0) DESC, id DESC
                   LIMIT ?""",
                (cache.max_docs,),
            ).fetchall()
            ev0 = cache.evictions
            for s in range(0, len(rows), 64):  # stop-responsive slices
                if self._stop_refresh.is_set():
                    return
                self.highlight_warmed_total += precompute_chunks(model, [r[0] for r in rows[s : s + 64]])
                if cache.evictions > ev0:
                    return  # cache at capacity: deeper warming only cycles it
        except Exception as e:  # noqa: BLE001 — after readiness, warming is best-effort
            print(f"highlight warmup failed (continuing): {e}", file=sys.stderr)

    def _warm(self) -> None:
        """Run the serving path BEFORE declaring readiness: on a CUDA
        matrix, build (or load) the kernel library, then the fused text
        query at two sequence buckets, the separate encode + sweep pair
        that backs escalations and coalesced batches, and two highlight
        chunk batches.  A failure raises: the caller records it as
        ``error`` and the server never reports ready."""
        with dispatchmeter.attributed("warmup"):
            app = self.app
            if app.searcher is None:
                return
            if app.searcher.matrix.device.type == "cuda":
                from .ops import _cuda

                _cuda.library()
            if not len(app.searcher.matrix):
                return
            app.searcher.search_fused(app.model, "warmup", 10, aux_model=app.highlights_model)
            app.searcher.search_fused(
                app.model, "warm up the next query length bucket "
                "with a sentence of around twenty five tokens total", 10,
                aux_model=app.highlights_model,
            )
            vec = app.model.encode_query("warmup")
            app.searcher.search_vector(vec, 10)
            app.highlights_model.highlight("warmup", ["warm up the chunk encoder"])
            app.highlights_model.highlight("warmup", ["warm up the chunk encoder " * 8] * 10)

    def stop(self) -> None:
        """Stop the refresh loop and the warmers, close the executor and the
        highlight batcher, and join every thread started here (each join
        bounded by a minute: a refresh scan in flight ends at its next
        source)."""
        self._stop_refresh.set()
        self._build_thread.join(60)
        for t in list(self.warmers):
            t.join(60)
        if self.executor is not None:
            self.executor.close()
        if self.highlighter is not None:
            self.highlighter.close()


def _result_json(r) -> dict:
    return {
        "id": r.item.id,
        "score": r.score,
        "title": r.item.metadata.name or r.item.external_id,
        "url": r.item.external_id,
        "source": r.source_name,
        "snippet": r.highlight or (r.item.content or "")[:240],
        "time": r.item.metadata.mtime if r.item.metadata.mtime is not None
                else r.item.metadata.atime,
    }


def make_handler(holder: ServeState):
    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, payload) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

        MAX_K = 256
        # POST body ceiling: a /search payload is a short query + filters;
        # 1 MB is orders of magnitude of headroom (see _do_post clamp)
        MAX_BODY_BYTES = 1 << 20

        def _search(
            self, query: str, k, source: Optional[str], type_tag: Optional[str] = None,
            after=None, before=None,
        ):
            try:
                k = int(k)
            except (TypeError, ValueError):
                return self._json(400, {"error": "k must be an integer"})
            if not 1 <= k <= self.MAX_K:
                return self._json(400, {"error": f"k must be in [1, {self.MAX_K}]"})
            app = holder.app
            if app.searcher is None:  # AppState(build_searcher=False)
                return self._json(
                    503, {"error": "no search index in this server's state"}
                )
            if holder.executor is None:  # stop() ran before the build ended
                return self._json(503, {"error": "the server is stopping"})
            from .cli.commands import (
                UnknownSource,
                filter_results_by_time,
                parse_when,
                resolve_source_filter,
            )

            try:  # the same resolver as the CLI (semantics can't drift)
                source_ids = resolve_source_filter(app, source, type_tag)
            except UnknownSource:
                return self._json(404, {"error": f"no source {source}"})
            except ValueError:
                return self._json(400, {"error": f"bad type {type_tag}"})
            def _parse_time(value):
                # `not in (None, "")`, NOT truthiness: epoch 0 is a valid
                # "since 1970" timestamp a truthy check silently drops,
                # diverging from the CLI's `is not None`; the empty string
                # keeps meaning "absent" for blank GET params.  Numeric JSON
                # values are already epochs: don't round-trip them through
                # parse_when's 9-digit string rule, which rejects 0 and
                # anything before ~1973
                if value in (None, ""):
                    return None
                if isinstance(value, bool):
                    raise ValueError(f"can't parse time {value!r}")
                if isinstance(value, (int, float)):
                    return int(value)
                return parse_when(str(value))

            try:  # same time-window grammar as the CLI's --after/--before
                after = _parse_time(after)
                before = _parse_time(before)
            except ValueError as e:
                return self._json(400, {"error": str(e)})
            # time filtering happens host-side after retrieve: over-fetch so
            # a narrow window still fills k (CLI search() does the same)
            time_filtered = after is not None or before is not None
            fetch_k = min(4 * k, self.MAX_K) if time_filtered else k
            # text rides the executor: uncontended -> ONE fused
            # encode+sweep dispatch that ALSO embeds the query with the
            # highlights model; concurrent -> batched encodes + coalesced
            # sweeps (index/executor.py)
            hits, hl_q = holder.executor.search_text(
                query, fetch_k, source_ids, want_aux=True
            )
            results = app.searcher.retrieve(app.db, hits)
            results = filter_results_by_time(results, after, before)[:k]
            docs = [r.item.content or "" for r in results]
            if docs:
                hs = holder.highlighter.call((query, docs, hl_q))
                for r, h in zip(results, hs):
                    r.highlight = h
            self._json(200, [_result_json(r) for r in results])

        def _metrics(self) -> None:
            """Prometheus text exposition (the reference exported no metrics)."""
            lines = [
                "# TYPE perceive_ready gauge",
                f"perceive_ready {int(holder.ready.is_set() and holder.error is None)}",
            ]
            app, ex = holder.app, holder.executor
            if app is not None and app.searcher is not None:
                m = app.searcher.matrix
                lines += [
                    "# TYPE perceive_index_rows gauge",
                    f"perceive_index_rows {len(m)}",
                    "# TYPE perceive_index_capacity gauge",
                    f"perceive_index_capacity {m.capacity}",
                ]
            lines += [
                "# TYPE perceive_refresh_scans_total counter",
                f"perceive_refresh_scans_total {holder.refresh_scans_total}",
                "# TYPE perceive_refresh_errors_total counter",
                f"perceive_refresh_errors_total {holder.refresh_errors_total}",
            ]
            from .models.highlight import HighlightCache

            hl = getattr(app, "highlights_model", None) if app else None
            cache = getattr(hl, "_highlight_cache", None)
            if isinstance(cache, HighlightCache):  # empty cache is falsy!
                lines += [
                    "# TYPE perceive_highlight_cache_docs gauge",
                    f"perceive_highlight_cache_docs {len(cache)}",
                    "# TYPE perceive_highlight_cache_bytes gauge",
                    f"perceive_highlight_cache_bytes {cache.nbytes}",
                    "# TYPE perceive_highlight_cache_hits_total counter",
                    f"perceive_highlight_cache_hits_total {cache.hits}",
                    "# TYPE perceive_highlight_cache_misses_total counter",
                    f"perceive_highlight_cache_misses_total {cache.misses}",
                ]
            # a ServeState counter, independent of the cache object: inside
            # the isinstance block its availability would flap with the
            # cache-disabling env var, showing "no data" instead of 0
            lines += [
                "# TYPE perceive_highlight_warmed_total counter",
                f"perceive_highlight_warmed_total {holder.highlight_warmed_total}",
            ]
            if ex is not None:
                lines += [
                    "# TYPE perceive_search_queries_total counter",
                    f"perceive_search_queries_total {ex.queries_total}",
                    "# TYPE perceive_search_query_errors_total counter",
                    f"perceive_search_query_errors_total {ex.query_errors_total}",
                    "# TYPE perceive_search_sweeps_total counter",
                    f"perceive_search_sweeps_total {ex.sweeps_total}",
                    "# TYPE perceive_search_sweep_seconds_total counter",
                    f"perceive_search_sweep_seconds_total {ex.sweep_seconds_total:.6f}",
                    "# TYPE perceive_result_cache_hits_total counter",
                    f"perceive_result_cache_hits_total {ex.result_cache_hits}",
                    "# TYPE perceive_result_cache_misses_total counter",
                    f"perceive_result_cache_misses_total {ex.result_cache_misses}",
                ]
            s = holder.app.searcher if holder.app else None
            if s is not None:
                lines += [
                    # floor-check re-fetches in the quantized tiers: a rising
                    # rate means the coarse depth / noise margin needs
                    # retuning for this corpus (index/searcher._scan)
                    "# TYPE perceive_search_escalations_total counter",
                    f"perceive_search_escalations_total {s.escalations}",
                    "# TYPE perceive_search_scan_calls_total counter",
                    f"perceive_search_scan_calls_total {s.scan_calls}",
                ]
            # device-dispatch accounting: the serving ratio (dispatches
            # since readiness / queries) is the latency story; the
            # uncontended fused path targets ~1
            dcounts = dispatchmeter.snapshot()
            lines += [
                "# TYPE perceive_device_dispatches_total counter",
                f"perceive_device_dispatches_total {dcounts.get('total', 0)}",
            ]
            for site in sorted(k for k in dcounts if k != "total"):
                lines += [
                    f'perceive_device_dispatches_total{{site="{site}"}} '
                    f"{dcounts[site]}",
                ]
            if ex is not None and holder.dispatches_at_ready is not None:
                base = holder.dispatches_at_ready
                # warm-up and background-refresh dispatches are not served
                # traffic (the JAX package subtracts warm-up's only)
                served = max(
                    dcounts.get("total", 0) - base.get("total", 0)
                    - sum(dcounts.get(s, 0) - base.get(s, 0) for s in _NOT_SERVED),
                    0,
                )
                lines += [
                    "# TYPE perceive_dispatches_per_request gauge",
                    "perceive_dispatches_per_request "
                    f"{served / max(ex.queries_total, 1):.3f}",
                ]
            body = ("\n".join(lines) + "\n").encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _status_payload(self) -> dict:
            out = {
                "model_loaded": holder.ready.is_set() and holder.error is None,
                "searcher_built": bool(holder.app and holder.app.searcher),
                "rows": len(holder.app.searcher.matrix)
                if holder.app and holder.app.searcher
                else 0,
                "error": holder.error,
            }
            s = holder.app.searcher if holder.app else None
            if s is not None:
                out["tier"] = s.matrix.tier_name
                out["escalations"] = s.escalations
                out["scan_calls"] = s.scan_calls
            if s and s.coarse_audit and s.matrix.packed2:
                # 'trusted' reflects the LIVE routing flag
                out["coarse_audit"] = {
                    **s.coarse_audit, "trusted": s.matrix.coarse_trusted,
                }
            return out

        def _events(self) -> None:
            """Server-PUSHED load status (SSE), as the reference's Tauri host
            pushes load_status to its webview when loading finishes
            (src-tauri/main.rs:80-102).  Subscribers get an event on connect
            and another when readiness flips; the stream then closes (the
            page re-opens it if it wants more)."""
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()

            def push() -> None:
                body = json.dumps(self._status_payload())
                self.wfile.write(f"event: load_status\ndata: {body}\n\n".encode())
                self.wfile.flush()

            try:
                # capture readiness BEFORE the first push: if it flips while
                # that payload is being built/sent, the second push must
                # still fire or the subscriber never learns of readiness
                was_ready = holder.ready.is_set()
                push()
                if not was_ready:
                    holder.ready.wait(600)
                    push()
            except (BrokenPipeError, ConnectionResetError):
                pass  # subscriber went away

        def _gate(self) -> bool:
            # holder.error also gates: a failure AFTER the app was assigned
            # (executor/highlighter construction, the kernel build or the
            # first launch in the warm-up) must not serve traffic that
            # /status and /metrics report as down
            if (
                not holder.ready.is_set()
                or holder.app is None
                or holder.error is not None
            ):
                self._json(503, {"status": "loading", "error": holder.error})
                return False
            return True

        def do_GET(self):
            try:
                self._do_get()
            except Exception as e:  # noqa: BLE001 — a 500 beats a dropped socket
                try:
                    self._json(500, {"error": str(e)})
                except Exception:  # noqa: BLE001 — response already started
                    pass

        def _do_get(self):
            parts = urlsplit(self.path)
            if parts.path in ("/", "/index.html"):
                body = _INDEX_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif parts.path == "/status":
                self._json(200, self._status_payload())
            elif parts.path == "/events":
                self._events()
            elif parts.path == "/sources":
                if not self._gate():
                    return
                holder.app.refresh_sources()
                self._json(
                    200,
                    [
                        {
                            "id": s.id,
                            "name": s.name,
                            "type": s.source_type,
                            "location": s.location,
                            "status": s.status.status,
                        }
                        for s in holder.app.sources
                    ],
                )
            elif parts.path == "/metrics":
                self._metrics()
            elif parts.path == "/search":
                if not self._gate():
                    return
                q = parse_qs(parts.query)
                query = (q.get("q") or [""])[0]
                if not query:
                    return self._json(400, {"error": "missing q"})
                self._search(
                    query,
                    (q.get("k") or ["10"])[0],
                    (q.get("source") or [None])[0],
                    (q.get("type") or [None])[0],
                    after=(q.get("after") or [None])[0],
                    before=(q.get("before") or [None])[0],
                )
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            try:
                self._do_post()
            except Exception as e:  # noqa: BLE001 — a 500 beats a dropped socket
                try:
                    self._json(500, {"error": str(e)})
                except Exception:  # noqa: BLE001
                    pass

        def _do_post(self):
            parts = urlsplit(self.path)
            if parts.path != "/search":
                return self._json(404, {"error": "not found"})
            if not self._gate():
                return
            try:
                n = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                return self._json(400, {"error": "bad content-length"})
            # clamp BEFORE reading: a negative length would rfile.read(-1)
            # until client EOF (a held socket pins this handler thread and
            # its fd forever — no socket timeout is set), and an absurd
            # positive one would buffer an unbounded body
            if not 0 <= n <= self.MAX_BODY_BYTES:
                return self._json(413, {"error": "body too large"})
            try:
                payload = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError):
                return self._json(400, {"error": "bad json"})
            if not isinstance(payload, dict):
                return self._json(400, {"error": "body must be a JSON object"})
            query = payload.get("q") or payload.get("query")
            if not query or not isinstance(query, str):
                return self._json(400, {"error": "missing q"})
            self._search(
                query, payload.get("k", 10), payload.get("source"), payload.get("type"),
                after=payload.get("after"), before=payload.get("before"),
            )

    return Handler


def _make_server(
    builder, host: str, port: int,
    refresh_interval: Optional[float], refresh_prune: bool,
) -> ThreadingHTTPServer:
    """Shared wiring for both serving entries: ServeState + handler +
    ThreadingHTTPServer, with the state reachable from the server object
    (tests and signal handlers need it for a graceful stop)."""
    holder = ServeState(builder, refresh_interval=refresh_interval, refresh_prune=refresh_prune)
    server = ThreadingHTTPServer((host, port), make_handler(holder))
    server.perceive_state = holder
    return server


def start_server(
    builder, host: str = "127.0.0.1", port: int = 5807,
    refresh_interval: Optional[float] = None,
    refresh_prune: bool = False,
) -> ThreadingHTTPServer:
    """Start serving in the background; returns the server (``.server_address``
    has the bound port when port=0).  ``refresh_interval`` turns on the
    background due-source rescan loop."""
    server = _make_server(builder, host, port, refresh_interval, refresh_prune)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def serve(
    state, host: str = "127.0.0.1", port: int = 5807,
    refresh_interval: Optional[float] = None,
    refresh_prune: bool = False,
    open_browser: bool = False,
) -> None:
    """Blocking CLI entry (``serve`` / ``app``) over the AppState given,
    which stays on its device: the CLI's is on ``cuda:0`` and raises
    without CUDA.

    ``open_browser`` is the desktop-app mode (the Tauri analog, reference
    perceive-tauri/src-tauri/main.rs:57-106): once the models and searcher
    are ready, the embedded search UI opens in the system browser: the same
    page the Tauri webview hosted, over the same three RPCs
    (status/sources/search) plus the SSE load_status push."""
    server = _make_server(
        lambda: state, host, port, refresh_interval, refresh_prune
    )
    holder = server.perceive_state
    url = f"http://{host}:{server.server_address[1]}"
    print(f"Serving on {url}")
    if open_browser:
        def _open():
            holder.ready.wait()
            if holder.error is None:
                import webbrowser

                try:
                    webbrowser.open(url)
                except Exception as e:  # noqa: BLE001 — headless host
                    print(f"could not open a browser ({e}); visit {url}",
                          file=sys.stderr)

        threading.Thread(target=_open, daemon=True).start()
    # production kill signal: drain like Ctrl-C instead of dying mid-request
    # (SQLite WAL + per-batch txns make an unclean death safe: DB replay
    # rebuilds any unsaved snapshot delta; but a clean stop closes the
    # coalescing executor and the refresh loop without half-written
    # responses).  serve_forever must be shut down from another thread.
    import signal

    def _on_term(signum, frame):  # noqa: ARG001
        threading.Thread(target=server.shutdown, daemon=True).start()

    try:
        prev_term = signal.signal(signal.SIGTERM, _on_term)
    except ValueError:  # not the main thread (embedded use): skip the hook
        prev_term = None
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        holder.stop()
        server.server_close()  # release the listening socket (in-process reuse)
        if prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)
