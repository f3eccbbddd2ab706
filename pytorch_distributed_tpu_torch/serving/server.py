"""Asyncio HTTP/SSE front door over the replica router.

The port of the JAX package's ``serving/server.py``: a minimal HTTP/1.1
server on raw asyncio streams, stdlib only. One background task drives
``router.step`` in a worker thread (the step waits on the card; the event
loop must not); every router call — submit, abort, admin actions, the
step itself — runs in a worker thread under one lock, so the router keeps
its single-dispatcher contract under concurrent clients. The step runs on
whichever pool thread picks it up: CUDA's current stream is per thread,
and the paged kernels keep one workspace per (device, stream), so that is
safe.

Endpoints:

- ``POST /v1/generate`` — body ``{"prompt": [ids...],
  "max_new_tokens": n, "temperature"?, "top_k"?, "top_p"?, "seed"?,
  "eos_id"?, "timeout_s"?, "stream"?, "priority"?, "tenant"?,
  "session"?}``. ``priority`` is the SLO tier (interactive/standard/batch,
  ``serving/scheduler``), ``tenant`` a registered LoRA adapter id
  (``serving/adapters``; ``serve --tenants``), ``session`` a sid from
  ``/v1/session/open``; unknown classes, unregistered tenants and
  diverged session resubmissions reject 400 with the engine's diagnostic.
  ``timeout_s`` maps onto ``submit(timeout_s=)``, enforced on the engine
  clock while queued and mid-decode. A sampled request without a
  ``seed`` gets a fresh random one. Plain requests block until terminal
  and return ``{"rid", "state", "tokens", "reason"}``; with ``"stream":
  true`` the response is
  Server-Sent Events: one ``data: {"token": t}`` per generated token as
  the scheduler produces it, then ``event: done`` carrying the terminal
  result. A client that disconnects mid-stream ABORTS its request.
- ``POST /v1/abort`` — ``{"rid": n}`` -> ``{"aborted": bool}``.
- ``POST /v1/session/open`` -> ``{"session": sid}`` /
  ``POST /v1/session/close`` ``{"session": sid}`` — the multi-turn chat
  surface: the router pins the session to one replica (its pages are the
  locality) and re-homes it on failover.
- ``GET /healthz`` — the router's ``stats()`` snapshot (replica states,
  queue and page pressure, counters).
- ``POST /admin/kill|drain|restart`` — ``{"replica": i}``: the operator's
  chaos and maintenance handles (kill a replica mid-stream and watch the
  SSE stream keep going).

Overload: ``RouterOverloaded`` maps to ``429`` with a ``Retry-After``
header (integer seconds, ceiling) and the machine-readable
``retry_after_s`` in the JSON body.
"""

from __future__ import annotations

import asyncio
import json
import math
import os
import threading
from typing import Any

import numpy as np

from pytorch_distributed_tpu_torch.serving.lifecycle import RouterOverloaded
from pytorch_distributed_tpu_torch.utils.logging import get_logger

_MAX_BODY = 1 << 22  # 4 MiB of JSON prompt is already absurd


class _HTTPError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


_STATUS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 408: "Request Timeout",
    413: "Payload Too Large", 429: "Too Many Requests",
    500: "Internal Server Error",
}


class ServingServer:
    """See the module docstring. ``router`` is a ``ReplicaRouter`` sharing
    ``params``; ``port=0`` binds an ephemeral port (read it off
    ``server.port`` after ``start``). ``idle_poll_s``
    bounds how long the drive loop sleeps when no work is queued, i.e.
    the worst-case latency from an empty router to the first prefill of
    a fresh request."""

    def __init__(
        self,
        router,
        params,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        default_max_new: int = 32,
        idle_poll_s: float = 0.02,
    ) -> None:
        self.router = router
        self.params = params
        self.host = host
        self.port = port
        self.default_max_new = int(default_max_new)
        self.idle_poll_s = float(idle_poll_s)
        self._lock = threading.Lock()  # serialises ALL router access
        self._server: asyncio.AbstractServer | None = None
        self._drive_task: asyncio.Task | None = None
        self._running = False
        # Terminal-result wakeups (one event per in-flight rid) + one
        # broadcast event per tick for SSE progress pollers.
        self._done_events: dict[int, asyncio.Event] = {}
        self._tick_event = asyncio.Event()
        self._work_event = asyncio.Event()
        self._log = get_logger("pdtpu.serving")

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> tuple[str, int]:
        self._running = True
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        self._drive_task = asyncio.create_task(self._drive_loop())
        self._log.info(
            f"serving on http://{self.host}:{self.port} "
            f"({len(self.router.replica_states())} replicas)"
        )
        return self.host, self.port

    async def stop(self) -> None:
        self._running = False
        self._work_event.set()
        if self._drive_task is not None:
            await self._drive_task
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def serve_forever(self) -> None:
        await self.start()
        try:
            await self._server.serve_forever()
        finally:
            await self.stop()

    # -- scheduler drive ----------------------------------------------------

    def _locked(self, fn, *args, **kw):
        with self._lock:
            return fn(*args, **kw)

    async def _router_call(self, fn, *args, **kw):
        """Run one router operation in a worker thread under the lock —
        never block the event loop on the lock (a step mid-dispatch
        holds it for a whole engine tick)."""
        return await asyncio.to_thread(self._locked, fn, *args, **kw)

    async def _drive_loop(self) -> None:
        while self._running:
            has_work = await self._router_call(self.router.has_work)
            if not has_work:
                self._work_event.clear()
                try:
                    await asyncio.wait_for(
                        self._work_event.wait(), self.idle_poll_s
                    )
                except (asyncio.TimeoutError, TimeoutError):
                    pass
                continue
            try:
                finished = await self._router_call(
                    self.router.step, self.params
                )
            except Exception:  # a dead fleet must not kill the server
                self._log.exception("router step failed")
                await asyncio.sleep(self.idle_poll_s)
                continue
            for rid in finished:
                ev = self._done_events.pop(rid, None)
                if ev is not None:
                    ev.set()
            tick_ev, self._tick_event = self._tick_event, asyncio.Event()
            tick_ev.set()

    # -- HTTP plumbing ------------------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            method, path, body = await self._read_request(reader)
            await self._route(method, path, body, writer)
        except _HTTPError as err:
            await self._send_json(
                writer, err.status, {"error": str(err)}
            )
        except (ConnectionResetError, BrokenPipeError, asyncio.IncompleteReadError):
            pass
        except Exception as err:  # noqa: BLE001 — wire boundary
            self._log.exception("request handler failed")
            try:
                await self._send_json(
                    writer, 500, {"error": f"{type(err).__name__}: {err}"}
                )
            except Exception:
                pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _read_request(self, reader):
        line = await reader.readline()
        if not line:
            raise _HTTPError(400, "empty request")
        parts = line.decode("latin-1").strip().split()
        if len(parts) != 3:
            raise _HTTPError(400, f"malformed request line {line!r}")
        method, path, _version = parts
        headers = {}
        while True:
            hline = await reader.readline()
            if hline in (b"\r\n", b"\n", b""):
                break
            name, _, value = hline.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
        length = int(headers.get("content-length", 0))
        if length > _MAX_BODY:
            raise _HTTPError(413, f"body {length} bytes > {_MAX_BODY}")
        raw = await reader.readexactly(length) if length else b""
        body: Any = None
        if raw:
            try:
                body = json.loads(raw)
            except json.JSONDecodeError as err:
                raise _HTTPError(400, f"invalid JSON body: {err}") from None
        return method, path, body

    async def _send_json(self, writer, status: int, obj,
                         extra_headers: tuple = ()) -> None:
        payload = json.dumps(obj).encode()
        head = [
            f"HTTP/1.1 {status} {_STATUS.get(status, 'Unknown')}",
            "Content-Type: application/json",
            f"Content-Length: {len(payload)}",
            "Connection: close",
            *extra_headers,
        ]
        writer.write(
            ("\r\n".join(head) + "\r\n\r\n").encode() + payload
        )
        await writer.drain()

    # -- routing ------------------------------------------------------------

    async def _route(self, method, path, body, writer) -> None:
        if path == "/healthz":
            if method != "GET":
                raise _HTTPError(405, "healthz is GET")
            stats = await self._router_call(self.router.stats)
            await self._send_json(writer, 200, stats)
        elif path == "/v1/generate":
            if method != "POST":
                raise _HTTPError(405, "generate is POST")
            await self._generate(body or {}, writer)
        elif path == "/v1/abort":
            if method != "POST":
                raise _HTTPError(405, "abort is POST")
            await self._abort(body or {}, writer)
        elif path == "/v1/session/open":
            if method != "POST":
                raise _HTTPError(405, "session/open is POST")
            try:
                sid = await self._router_call(self.router.open_session)
            except RouterOverloaded as err:
                retry = err.retry_after_s or 1.0
                await self._send_json(
                    writer, 429,
                    {"error": str(err), "retry_after_s": retry},
                    extra_headers=(f"Retry-After: {math.ceil(retry)}",),
                )
                return
            await self._send_json(writer, 200, {"session": sid})
        elif path == "/v1/session/close":
            sid = (body or {}).get("session")
            if method != "POST":
                raise _HTTPError(405, "session/close is POST")
            if not isinstance(sid, int):
                raise _HTTPError(400, "close needs an integer session")
            try:
                await self._router_call(self.router.close_session, sid)
            except ValueError as err:  # unknown sid
                raise _HTTPError(404, str(err)) from None
            await self._send_json(
                writer, 200, {"session": sid, "closed": True}
            )
        elif path.startswith("/admin/"):
            if method != "POST":
                raise _HTTPError(405, "admin actions are POST")
            await self._admin(path[len("/admin/"):], body or {}, writer)
        else:
            raise _HTTPError(404, f"no route for {path}")

    def _submit_kwargs(self, body: dict) -> tuple[np.ndarray, int, dict]:
        prompt = body.get("prompt")
        if not isinstance(prompt, list) or not prompt or not all(
            isinstance(t, int) for t in prompt
        ):
            raise _HTTPError(
                400, "prompt must be a non-empty list of token ids"
            )
        max_new = int(body.get("max_new_tokens", self.default_max_new))
        kw: dict = {}
        for k in ("temperature", "top_k", "top_p", "eos_id", "timeout_s",
                  "priority", "tenant", "session"):
            if body.get(k) is not None:
                kw[k] = body[k]
        if "session" in kw and not isinstance(kw["session"], int):
            raise _HTTPError(
                400, "session must be an integer sid from "
                     "POST /v1/session/open"
            )
        if "priority" in kw and not isinstance(kw["priority"], str):
            raise _HTTPError(
                400, "priority must be one of "
                     "'interactive'/'standard'/'batch'"
            )
        if kw.get("temperature"):
            # "seed" is optional on the wire: a sampled request without
            # one draws a fresh seed here.
            seed = body.get("seed")
            if seed is None:
                seed = int.from_bytes(os.urandom(4), "little")
            if not isinstance(seed, int):
                raise _HTTPError(400, "seed must be an integer")
            kw["seed"] = seed
        return np.asarray(prompt, np.int32), max_new, kw

    async def _generate(self, body, writer) -> None:
        prompt, max_new, kw = self._submit_kwargs(body)
        try:
            rid = await self._router_call(
                self.router.submit, prompt, max_new, **kw
            )
        except RouterOverloaded as err:
            retry = err.retry_after_s or 1.0
            await self._send_json(
                writer, 429,
                {"error": str(err), "retry_after_s": retry},
                extra_headers=(f"Retry-After: {math.ceil(retry)}",),
            )
            return
        except ValueError as err:  # bad budgets/args reject loudly
            raise _HTTPError(400, str(err)) from None
        ev = asyncio.Event()
        self._done_events[rid] = ev
        self._work_event.set()
        if body.get("stream"):
            await self._stream_sse(rid, len(prompt), writer)
        else:
            await ev.wait()
            res = await self._router_call(self.router.pop_result, rid)
            await self._send_json(writer, 200, self._result_json(res))

    def _result_json(self, res) -> dict:
        return {
            "rid": int(res.rid),
            "state": res.state,
            "tokens": [int(t) for t in np.asarray(res.tokens)],
            "reason": res.reason,
        }

    async def _stream_sse(self, rid: int, prompt_len: int,
                          writer) -> None:
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\n"
            b"Connection: close\r\n\r\n"
        )
        sent = prompt_len
        try:
            while True:
                tokens = await self._router_call(self.router.progress, rid)
                done = await self._router_call(
                    lambda: rid in self.router.results
                )
                if tokens is not None:
                    for t in np.asarray(tokens)[sent:]:
                        writer.write(
                            f"data: {json.dumps({'token': int(t)})}\n\n"
                            .encode()
                        )
                    sent = max(sent, len(tokens))
                    await writer.drain()  # raises if the client left
                if done:
                    res = await self._router_call(
                        self.router.pop_result, rid
                    )
                    # Flush the tail from the RESULT itself: the
                    # request may have finished between the progress
                    # read above and the done check, and every
                    # generated token owes the client one data event.
                    final = np.asarray(res.tokens)
                    for t in final[sent:]:
                        writer.write(
                            f"data: {json.dumps({'token': int(t)})}\n\n"
                            .encode()
                        )
                    writer.write(
                        ("event: done\ndata: "
                         + json.dumps(self._result_json(res))
                         + "\n\n").encode()
                    )
                    await writer.drain()
                    return
                # Wait for the next scheduler tick (or the idle poll —
                # a parked/queued rid makes no progress between ticks).
                tick = self._tick_event
                try:
                    await asyncio.wait_for(tick.wait(), 0.25)
                except (asyncio.TimeoutError, TimeoutError):
                    pass
        except (ConnectionResetError, BrokenPipeError):
            # Client hung up mid-stream: abort the request — the row
            # frees, the partial result delivers and is discarded.
            try:
                aborted = await self._router_call(self.router.abort, rid)
                if aborted or rid in self.router.results:
                    await self._router_call(self.router.pop_result, rid)
            except KeyError:
                pass
        finally:
            self._done_events.pop(rid, None)

    async def _abort(self, body, writer) -> None:
        rid = body.get("rid")
        if not isinstance(rid, int):
            raise _HTTPError(400, "abort needs an integer rid")
        try:
            aborted = await self._router_call(self.router.abort, rid)
        except KeyError as err:
            raise _HTTPError(404, str(err)) from None
        if aborted:
            # abort() delivers the terminal result directly (outside a
            # step tick), so the drive loop will never signal it — wake
            # any handler blocked on this rid ourselves.
            ev = self._done_events.pop(rid, None)
            if ev is not None:
                ev.set()
        await self._send_json(writer, 200, {"rid": rid, "aborted": aborted})

    async def _admin(self, action: str, body, writer) -> None:
        replica = body.get("replica")
        if not isinstance(replica, int):
            raise _HTTPError(400, f"admin/{action} needs an integer replica")
        try:
            if action == "kill":
                await self._router_call(self.router.kill, replica)
            elif action == "drain":
                await self._router_call(
                    self.router.drain, replica,
                    migrate=bool(body.get("migrate", False)),
                )
            elif action == "restart":
                await self._router_call(
                    self.router.restart, replica, self.params
                )
            else:
                raise _HTTPError(404, f"unknown admin action {action!r}")
        except (RuntimeError, IndexError) as err:
            raise _HTTPError(400, str(err)) from None
        self._work_event.set()
        states = await self._router_call(self.router.replica_states)
        await self._send_json(
            writer, 200, {"action": action, "replica": replica,
                          "states": states},
        )
