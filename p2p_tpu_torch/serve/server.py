"""The HTTP frontend over the engine (counterpart of
``p2p_tpu/serve/server.py:62-683``; stdlib ``ThreadingHTTPServer``, no web
framework).

Endpoints:

- ``POST /v1/{model}/translate``: the body is a PNG (the port decodes PNG
  only), the response the translated image as PNG. ``{model}`` is a
  tenant alias of the :class:`~p2p_tpu_torch.serve.tenancy.ModelRegistry`.
  Status codes: 404 unknown tenant or route; 411 no or bad
  Content-Length; 413 body over 32 MiB; 422 the body failed decode
  ``max_attempts`` times; 429 queue full (depth or byte budget) or the
  tenant at its ``tenant_quota`` (``Retry-After: 1``); 503 draining; 504
  deadline passed before dispatch (or no answer within the response
  timeout); 500 dispatch or response encode failed.
- ``GET /healthz``: per-tenant JSON (step, buckets, warm-ups, swaps,
  queue depth); 200 serving, 503 draining.
- ``GET /metrics``: the registry in the Prometheus text format.
- ``POST /admin/reload?tenant=X[&step=N]`` (or a JSON body): hot-swap;
  200 swapped, 409 rejected (the old weights keep serving), 404 unknown
  tenant.

Handler threads admit requests into the tenant's
:class:`~p2p_tpu_torch.serve.batcher.ContinuousBatcher` and wait on a
per-request event; one dispatch thread per tenant forms groups and runs
the shared :class:`~p2p_tpu_torch.serve.frontend.DispatchLoop`; one
responder pool copies each batch to the host once and PNG-encodes it,
completing the waiting handlers. SIGTERM/SIGINT (a
:class:`~p2p_tpu_torch.resilience.PreemptionGuard`) stops admission
(new requests get 503), runs every queue and the pool down, and
:func:`run_server` returns 0 after one summary per tenant.
"""

from __future__ import annotations

import dataclasses
import json
import re
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from itertools import count
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, unquote, urlsplit

import numpy as np

from p2p_tpu_torch.resilience.queue import BoundedRequestQueue, Request
from p2p_tpu_torch.serve.batcher import ContinuousBatcher
from p2p_tpu_torch.serve.frontend import DispatchLoop
from p2p_tpu_torch.serve.io import encode_png, to_host
from p2p_tpu_torch.serve.tenancy import HotSwapRejected, ModelRegistry, \
    Tenant

_TRANSLATE_RE = re.compile(r"^/v1/([^/]+)/translate$")

#: request bodies above this are refused with 413 before any decode work
MAX_BODY_BYTES = 32 * 1024 * 1024
#: byte budget of one tenant's queued request bodies (429 past it): depth
#: alone would admit max_queue × MAX_BODY_BYTES of host RAM before a shed
QUEUE_BYTES = 256 * 1024 * 1024
#: how long a handler waits for its answer past the request deadline
#: (or at all, without a deadline) before it answers 504 itself
RESPONSE_GRACE_S = 30.0
NO_DEADLINE_RESPONSE_S = 120.0


class TenantQuotaExceeded(RuntimeError):
    """Admission refused: the tenant already has ``quota`` requests in
    flight (admitted and not yet answered). The per-tenant fairness
    guard — one tenant's burst can fill the shared responder pool and
    its own queue, but it cannot consume every OTHER tenant's admission
    slots. Maps to 429 +
    ``serve_quota_rejected_total``."""

    def __init__(self, tenant: str, quota: int):
        self.tenant = tenant
        self.quota = quota
        super().__init__(
            f"tenant {tenant!r} quota exceeded ({quota} in flight)")


@dataclasses.dataclass
class HttpRequest(Request):
    """A queued HTTP request: the body bytes ride in ``payload``; the
    handler thread blocks on ``done`` until the dispatch side calls
    :meth:`complete` (first completion wins — a late duplicate, e.g. a
    drain-500 racing the responder, is a no-op)."""

    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    status: int = 0
    out_body: bytes = b""
    out_type: str = "application/json"
    out_headers: Dict[str, str] = dataclasses.field(default_factory=dict)
    # fired exactly once on the FIRST completion, whichever path answers
    # (responder 200, poison 422, deadline 504, drain 503, engine 500) —
    # the quota accounting's release hook (see ServeApp.submit)
    on_complete: Optional[Any] = None

    def complete(self, status: int, body: bytes,
                 content_type: str = "application/json",
                 headers: Optional[Dict[str, str]] = None) -> None:
        if self.done.is_set():
            return
        self.status = int(status)
        self.out_body = body
        self.out_type = content_type
        if headers:
            self.out_headers = dict(headers)
        self.done.set()
        cb = self.consume_on_complete()
        if cb is not None:
            cb(self)

    def consume_on_complete(self):
        """Atomically take (and disarm) the completion hook. ``dict.pop``
        is a single C call under the GIL, so a double-complete race (the
        handler's response-timeout claim vs the responder's 200) hands
        the hook to exactly ONE caller — the quota slot can never be
        released twice for one acquisition. After the pop, attribute
        lookup falls back to the dataclass default (None)."""
        return self.__dict__.pop("on_complete", None)


def _json_body(payload: Dict[str, Any]) -> bytes:
    return (json.dumps(payload) + "\n").encode()


class _TenantRuntime:
    """Per-tenant serving wiring: queue + batcher + dispatch loop +
    the HTTP-side DispatchLoop callbacks."""

    def __init__(self, app: "ServeApp", tenant: Tenant,
                 max_queue: int, deadline_s: Optional[float],
                 linger_s: float, group_cap: Optional[int],
                 max_attempts: int, retry_delay_s: float,
                 quota: Optional[int] = None):
        self.tenant = tenant
        # per-tenant admission quota (None = unlimited): in-flight =
        # admitted and not yet completed; counted under its own lock
        # (handler threads admit, responder/dispatch threads release)
        self.quota = quota
        self.inflight = 0
        self._quota_lock = threading.Lock()
        self.queue = BoundedRequestQueue(
            max_depth=max_queue, deadline_s=deadline_s,
            registry=app.registry, tenant=tenant.alias,
            max_bytes=QUEUE_BYTES)
        self.batcher = ContinuousBatcher(
            self.queue, tenant.engine.buckets,
            group_cap=group_cap, linger_s=linger_s)
        h, w = tenant.cfg.image_hw
        as_uint8 = tenant.cfg.data.uint8_pipeline

        def decode(req: Request) -> np.ndarray:
            # same chaos seam as the directory frontend: chaos drills at
            # `decode` rehearse the retry/poison ladder over HTTP too
            from p2p_tpu_torch.data.pipeline import load_image_bytes
            from p2p_tpu_torch.resilience.chaos import chaos_point

            chaos_point("decode")
            return load_image_bytes(req.payload, h, w, as_uint8=as_uint8)

        alias = tenant.alias
        self._poisoned = app.registry.counter(
            "serve_quarantined_total", tenant=alias)
        self._quota_rejected = app.registry.counter(
            "serve_quota_rejected_total", tenant=alias)
        self._latency = app.registry.histogram(
            "serve_request_latency_seconds", tenant=alias)
        # responder time (D2H copy + PNG encodes), summed over batches
        self._encode_sec = app.registry.counter(
            "serve_encode_seconds_total", tenant=alias)
        self._rate = app.registry.ewma(
            "serve_requests_per_sec", tenant=alias)

        def deliver(reqs, pred, n_real):
            app.submit_response(self, reqs, pred)

        def on_poison(req, exc):
            self._poisoned.inc()
            req.complete(422, _json_body({
                "error": "undecodable request body",
                "detail": repr(exc)[:200],
                "attempts": req.attempts}))

        def on_expired(req):
            req.complete(504, _json_body({
                "error": "deadline expired before dispatch"}))

        def on_retry_shed(req):
            # same 429 contract as the admission-shed path, Retry-After
            # included — a client backs off identically on both flavors
            req.complete(429, _json_body({
                "error": "queue full (decode retry shed)"}),
                headers={"Retry-After": "1"})

        def on_engine_error(reqs, exc):
            # an engine/deliver failure must answer, not hang, the
            # waiting handlers; the loop hands us ONLY the decoded group
            # (decode-failed members were requeued and will be retried)
            for req in reqs:
                req.complete(500, _json_body(
                    {"error": "dispatch failed",
                     "detail": repr(exc)[:200]}))

        self.loop = DispatchLoop(
            tenant.engine, self.batcher,
            decode=decode, deliver=deliver, on_poison=on_poison,
            on_expired=on_expired, on_retry_shed=on_retry_shed,
            on_engine_error=on_engine_error,
            max_attempts=max_attempts, retry_delay_s=retry_delay_s,
            registry=app.registry, tenant=alias, group_cap=group_cap)
        self.on_expired = on_expired
        self.thread: Optional[threading.Thread] = None

    def try_acquire_slot(self) -> bool:
        """Take one in-flight slot; False = the tenant is at quota."""
        with self._quota_lock:
            if self.quota is not None and self.inflight >= self.quota:
                self._quota_rejected.inc()
                return False
            self.inflight += 1
            return True

    def release_slot(self, _req=None) -> None:
        with self._quota_lock:
            if self.inflight > 0:
                self.inflight -= 1

    def status(self) -> Dict[str, Any]:
        s = self.tenant.status()
        s["queue_depth"] = len(self.batcher)
        s["served"] = self.loop.served
        s["inflight"] = self.inflight
        return s


class ServeApp:
    """The serving application: tenant registry + per-tenant runtimes +
    responder pool + drain choreography. The HTTP handler below is a
    thin parser over this object, so tests drive it without sockets."""

    def __init__(self, registry=None, io_threads: int = 4,
                 max_queue: int = 512, deadline_ms: float = 0.0,
                 linger_ms: float = 10.0, group_cap: Optional[int] = None,
                 max_attempts: int = 3, retry_delay_ms: float = 1000.0,
                 tenant_quota: Optional[int] = None):
        if registry is None:
            from p2p_tpu_torch.obs import get_registry

            registry = get_registry()
        self.registry = registry
        self.tenants = ModelRegistry()
        self._runtimes: Dict[str, _TenantRuntime] = {}
        self._rt_kw = dict(
            max_queue=max_queue,
            deadline_s=(deadline_ms / 1e3) if deadline_ms > 0 else None,
            linger_s=linger_ms / 1e3, group_cap=group_cap,
            max_attempts=max_attempts,
            retry_delay_s=retry_delay_ms / 1e3,
            # per-tenant in-flight cap (429 + serve_quota_rejected_total)
            # so one tenant's burst cannot starve the others' slots
            quota=tenant_quota)
        self.response_timeout_s = (
            deadline_ms / 1e3 + RESPONSE_GRACE_S if deadline_ms > 0
            else NO_DEADLINE_RESPONSE_S)
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, io_threads),
            thread_name_prefix="p2p-http-io")
        # backpressure on the responder pool: every queued batch pins its
        # device prediction until fetched — same rationale as
        # AsyncImageWriter.max_pending
        self._pending = threading.BoundedSemaphore(4 * max(1, io_threads))
        self._draining = threading.Event()
        self._stop = threading.Event()
        self._seq = count()
        self.httpd: Optional["ServeHTTPServer"] = None

    # --------------------------------------------------------- tenants
    def add_tenant(self, tenant: Tenant) -> Tenant:
        self.tenants.add(tenant)
        self._runtimes[tenant.alias] = _TenantRuntime(
            self, tenant, **self._rt_kw)
        return tenant

    def runtime(self, alias: str) -> _TenantRuntime:
        return self._runtimes[alias]

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    # -------------------------------------------------------- requests
    def submit(self, alias: str, body: bytes) -> Optional[HttpRequest]:
        """Admit one translate request; None = shed/draining (the
        handler maps via :attr:`draining`); raises
        :class:`TenantQuotaExceeded` when the tenant is at its in-flight
        cap (``--tenant_quota``). The slot is released on the request's
        FIRST completion — whichever path answers it — via the
        ``on_complete`` hook; a shed request never entered the system,
        so its slot releases here."""
        rt = self._runtimes[alias]
        if not rt.try_acquire_slot():
            raise TenantQuotaExceeded(alias, rt.quota)
        req = HttpRequest(name=f"{alias}/{next(self._seq)}",
                          enqueued_at=0.0, payload=body,
                          on_complete=rt.release_slot)
        out = rt.batcher.submit_request(req)
        if out is None:
            # atomically disarm the hook and release here: a future path
            # that answers a shed request via complete() must not
            # release the same acquisition twice
            if req.consume_on_complete() is not None:
                rt.release_slot(req)
        else:
            rt._rate.mark()
        return out  # type: ignore[return-value]

    def submit_response(self, rt: _TenantRuntime, reqs, pred) -> None:
        """Hand one dispatched batch to the responder pool: ONE D2H
        fetch for the whole prediction, then per-request PNG encode +
        completion — off the dispatch thread, overlapping the next
        group's device compute."""
        self._pending.acquire()
        try:
            self._pool.submit(self._respond_batch, rt, list(reqs), pred)
        except BaseException:
            self._pending.release()
            raise

    def _respond_batch(self, rt: _TenantRuntime, reqs, pred) -> None:
        t0 = time.perf_counter()
        try:
            arr = to_host(pred[:len(reqs)])  # one D2H copy a batch
            now = time.monotonic()
            for i, req in enumerate(reqs):
                rt._latency.observe(max(now - req.enqueued_at, 0.0))
                req.complete(200, encode_png(arr[i]), "image/png")
        except BaseException as e:
            for req in reqs:
                req.complete(500, _json_body(
                    {"error": "response encode failed",
                     "detail": repr(e)[:200]}))
        finally:
            rt._encode_sec.inc(time.perf_counter() - t0)
            self._pending.release()

    # -------------------------------------------------- dispatch/drain
    def start(self) -> None:
        """Warm every tenant's buckets, then start one dispatch thread
        each."""
        for alias, rt in self._runtimes.items():
            rt.tenant.warmup()
            rt.thread = threading.Thread(
                target=self._dispatch_loop, args=(rt,),
                name=f"p2p-dispatch-{alias}", daemon=True)
            rt.thread.start()

    def _dispatch_loop(self, rt: _TenantRuntime) -> None:
        while True:
            try:
                ready, expired = rt.batcher.next_group(timeout=0.1)
                for req in expired:
                    rt.on_expired(req)
                if ready:
                    rt.loop.dispatch(ready)  # engine errors → callback
                    continue
                if rt.batcher.closed:
                    if len(rt.batcher) == 0:
                        return
                    if self._stop.is_set():
                        # drain timeout: answer the stragglers honestly —
                        # flush() pulls backoff-window holdouts too, which
                        # take() would hand straight back
                        for req in rt.batcher.flush():
                            req.complete(503, _json_body(
                                {"error": "server shutting down"}))
                        return
                    time.sleep(0.01)  # backoff-window stragglers
            except Exception:
                time.sleep(0.01)  # never let the tenant loop die

    def drain(self, timeout_s: float = 30.0) -> None:
        """Stop admitting, run every queue down, flush the responder
        pool. Stragglers past ``timeout_s`` (stuck in decode-retry
        backoff) are answered 503 rather than abandoned."""
        self._draining.set()
        for rt in self._runtimes.values():
            rt.batcher.close()
        deadline = time.monotonic() + timeout_s
        for rt in self._runtimes.values():
            if rt.thread is not None:
                rt.thread.join(max(deadline - time.monotonic(), 0.1))
        self._stop.set()
        for rt in self._runtimes.values():
            if rt.thread is not None:
                rt.thread.join(timeout=5.0)
        self._pool.shutdown(wait=True)

    def summaries(self) -> List[Dict[str, Any]]:
        """One ``serve_summary``-shaped record per tenant (the HTTP twin
        of cli/serve.py's summary line)."""
        out = []
        for alias, rt in self._runtimes.items():
            e = rt.tenant.engine
            occ = rt.loop.occupancy_mean
            out.append({
                "kind": "serve_summary", "tenant": alias,
                "served": rt.loop.served,
                "step": int(rt.tenant.step),
                "buckets": list(e.buckets),
                "n_warmups": int(e.n_warmups),
                "shed": rt.queue.shed_count,
                "deadline_expired": rt.queue.expired_count,
                "quarantined": int(rt._poisoned.value),
                "decode_retries": rt.loop.decode_retries,
                "quota_rejected": int(rt._quota_rejected.value),
                "hot_swaps": rt.tenant.swap_count,
                "batch_occupancy_mean": round(occ, 4)
                if occ is not None else None,
                "padded_images": rt.loop.padded_images,
                "encode_sec": round(rt._encode_sec.value, 4),
            })
        return out


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "p2p-tpu-torch-serve/1.0"

    # served by ThreadingHTTPServer subclass below
    @property
    def app(self) -> ServeApp:
        return self.server.app  # type: ignore[attr-defined]

    def log_message(self, fmt, *args):  # stdlib default spams stderr
        pass

    def _send(self, status: int, body: bytes,
              content_type: str = "application/json",
              extra: Optional[Dict[str, str]] = None) -> None:
        try:
            # error responses close the connection: several error paths
            # answer BEFORE consuming the request body, and a kept-alive
            # socket would parse the unread body bytes as the next
            # request line — closing resyncs the client cheaply
            close = status >= 400
            if close:
                self.close_connection = True
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            if close:
                self.send_header("Connection", "close")
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away; nothing to salvage
        code_tags = {"code": str(status)}
        self.app.registry.counter("serve_http_responses_total",
                                  **code_tags).inc()

    # ------------------------------------------------------------- GET
    def do_GET(self):
        path = urlsplit(self.path).path
        if path == "/healthz":
            app = self.app
            status = "draining" if app.draining else "ok"
            body = _json_body({
                "status": status,
                "tenants": {alias: app.runtime(alias).status()
                            for alias in app.tenants.aliases()},
            })
            self._send(503 if app.draining else 200, body)
            return
        if path == "/metrics":
            from p2p_tpu_torch.obs import prometheus_exposition

            text = prometheus_exposition(self.app.registry).encode()
            self._send(200, text,
                       "text/plain; version=0.0.4; charset=utf-8")
            return
        self._send(404, _json_body({"error": f"no route {path!r}"}))

    # ------------------------------------------------------------ POST
    def _read_body(self) -> Optional[bytes]:
        length = self.headers.get("Content-Length")
        if length is None:
            self._send(411, _json_body({"error": "Content-Length required"}))
            return None
        try:
            n = int(length)
        except ValueError:
            n = -1
        if n < 0:
            # negative would turn rfile.read into read-to-EOF — a blocked
            # handler thread per request (remote thread exhaustion)
            self._send(411, _json_body(
                {"error": f"bad Content-Length {length!r}"}))
            return None
        if n > MAX_BODY_BYTES:
            self._send(413, _json_body(
                {"error": f"body exceeds {MAX_BODY_BYTES} bytes"}))
            return None
        return self.rfile.read(n)

    def do_POST(self):
        split = urlsplit(self.path)
        path = split.path
        if path == "/admin/reload":
            self._admin_reload(split.query)
            return
        m = _TRANSLATE_RE.match(path)
        if not m:
            self._send(404, _json_body({"error": f"no route {path!r}"}))
            return
        alias = unquote(m.group(1))
        app = self.app
        if alias not in app.tenants:
            self._send(404, _json_body(
                {"error": f"unknown tenant {alias!r}",
                 "tenants": list(app.tenants.aliases())}))
            return
        if app.draining:
            self._send(503, _json_body({"error": "draining"}),
                       extra={"Retry-After": "1"})
            app.registry.counter("serve_http_requests_total",
                                 tenant=alias, code="503").inc()
            return
        body = self._read_body()
        if body is None:
            return
        try:
            req = app.submit(alias, body)
        except TenantQuotaExceeded as e:
            # per-tenant fairness refusal: same 429/Retry-After contract
            # as the shed path, its own counter + error body so a tenant
            # can tell "server full" from "YOU are at quota"
            self._send(429, _json_body(
                {"error": f"tenant quota exceeded "
                          f"({e.quota} requests in flight)"}),
                extra={"Retry-After": "1"})
            app.registry.counter("serve_http_requests_total",
                                 tenant=alias, code="429").inc()
            return
        if req is None:
            if app.draining:
                code = "503"
                self._send(503, _json_body({"error": "draining"}),
                           extra={"Retry-After": "1"})
            else:
                code = "429"
                self._send(429, _json_body(
                    {"error": "queue full — request shed"}),
                    extra={"Retry-After": "1"})
            # the shed/drain refusals ARE the error-rate SLO feed — they
            # must land on the same per-tenant series as completions
            app.registry.counter("serve_http_requests_total",
                                 tenant=alias, code=code).inc()
            return
        if not req.done.wait(app.response_timeout_s):
            req.complete(504, b"")  # claim it so a late responder no-ops
            self._send(504, _json_body(
                {"error": "response timeout", "name": req.name}))
            app.registry.counter("serve_http_requests_total",
                                 tenant=alias, code="504").inc()
            return
        self._send(req.status, req.out_body, req.out_type,
                   extra=req.out_headers or None)
        app.registry.counter("serve_http_requests_total", tenant=alias,
                             code=str(req.status)).inc()

    def _admin_reload(self, query: str) -> None:
        app = self.app
        params = parse_qs(query)
        body = self._read_body()
        if body is None:
            return
        payload: Dict[str, Any] = {}
        if body:
            try:
                payload = json.loads(body)
            except json.JSONDecodeError:
                self._send(400, _json_body(
                    {"error": "reload body must be JSON"}))
                return
        alias = payload.get("tenant") or (params.get("tenant") or [None])[0]
        step = payload.get("step")
        if step is None and "step" in params:
            step = params["step"][0]
        if alias is None:
            self._send(400, _json_body(
                {"error": "tenant required (body JSON or ?tenant=)"}))
            return
        if alias not in app.tenants:
            self._send(404, _json_body(
                {"error": f"unknown tenant {alias!r}"}))
            return
        try:
            result = app.tenants.get(alias).reload(
                step=int(step) if step is not None else None)
        except HotSwapRejected as e:
            self._send(409, _json_body(
                {"error": str(e), "tenant": alias, "swapped": False}))
            return
        except ValueError as e:
            self._send(400, _json_body({"error": str(e)}))
            return
        self._send(200, _json_body(result))


class ServeHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer carrying the :class:`ServeApp` reference.
    ``daemon_threads``: idle keep-alive connections must not block the
    drained process's exit (all REQUESTS are answered before shutdown —
    the drain completes every in-flight event first)."""

    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr: Tuple[str, int], app: ServeApp):
        super().__init__(addr, _Handler)
        self.app = app


def run_server(app: ServeApp, host: str = "127.0.0.1", port: int = 8000,
               guard=None, drain_timeout_s: float = 30.0,
               ready_event: Optional[threading.Event] = None) -> int:
    """Serve until SIGTERM/SIGINT (or a programmatic ``guard.request()``),
    then drain gracefully and return 0 — the PreemptionGuard protocol
    applied to serving: signal sets a flag (+ flush hooks), policy runs
    at the loop boundary.

    ``guard=None`` installs a fresh :class:`PreemptionGuard` (real signal
    handlers — the production path); tests pass their own un-installed
    guard and trigger ``guard.request()``."""
    from p2p_tpu_torch.resilience import PreemptionGuard

    own_guard = guard is None
    if own_guard:
        guard = PreemptionGuard(registry=app.registry).install()
    guard.add_flush_hook(app.registry.flush)
    app.start()
    httpd = ServeHTTPServer((host, port), app)
    app.httpd = httpd  # bound address (port 0 → ephemeral) for callers
    http_thread = threading.Thread(
        target=httpd.serve_forever, kwargs={"poll_interval": 0.1},
        name="p2p-http-accept", daemon=True)
    http_thread.start()
    bound = httpd.server_address
    print(f"serving {len(app.tenants)} tenant(s) "
          f"{list(app.tenants.aliases())} on http://{bound[0]}:{bound[1]} "
          f"(POST /v1/<tenant>/translate)", flush=True)
    if ready_event is not None:
        ready_event.set()
    try:
        while not guard.requested:
            time.sleep(0.05)
    finally:
        print("drain: stopped admitting; running queues down...",
              flush=True)
        app.drain(timeout_s=drain_timeout_s)
        httpd.shutdown()
        # the drain completed every in-flight event; give the (daemon)
        # handler threads a beat to flush those last responses before
        # the sockets close under them
        time.sleep(0.25)
        httpd.server_close()
        for rec in app.summaries():
            app.registry.record(rec, force=True)
            print(json.dumps(rec), flush=True)
        if own_guard:
            guard.uninstall()
    return 0
