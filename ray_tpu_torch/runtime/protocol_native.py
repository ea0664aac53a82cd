"""Native transport binding: RpcServer/RpcClient over the C++ epoll loop.

protocol.py re-exports these classes as the runtime's only transport. All
socket IO, framing, and buffering run in the native library's event loop (src/transport.cc —
role of the reference's C++ rpc layer, src/ray/rpc/grpc_server.h). One
Python dispatcher thread per process drains inbound messages in batches
(rt_poll returns many events per ctypes call), runs inline handlers and
client completions directly, and hands the rest to each server's pool —
replacing the thread-per-connection + wakeup-per-message model that
dominates small-host profiles.

Dispatcher contract: client completion callbacks (Future.set_result /
call_batch_cb callbacks) run ON the dispatcher thread and must not issue
blocking RPCs — a blocked dispatcher can't process the reply it would be
waiting for. Handlers outside `inline_methods` run on the pool and may
block freely.
"""

from __future__ import annotations

import ctypes
import os
import pickle
import struct
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.core import config as config_mod

_REPLY_BIT = 1 << 63
_FAST_BIT = 1 << 62  # binary KV fast-path frame, served inside the C loop

_MSG, _ACCEPT, _DISCONNECT = 1, 2, 3
_POLL_BATCH = 512

# fast-path ops (mirror transport.cc FastOp)
FAST_PUT, FAST_GET, FAST_DEL, FAST_PING = 1, 2, 3, 4
FAST_LEASE_ACQ, FAST_LEASE_REL = 5, 6
_FAST_REQ = struct.Struct("<BBIQ")  # op, flags, klen, vlen
_FAST_REP = struct.Struct("<BQ")    # status, vlen
_U64 = struct.Struct("<Q")


class _RtEvent(ctypes.Structure):
    _fields_ = [
        ("type", ctypes.c_uint8),
        ("conn_id", ctypes.c_uint64),
        ("req_id", ctypes.c_uint64),
        ("len", ctypes.c_uint64),
        ("data", ctypes.c_void_p),
    ]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.rt_loop_new.restype = ctypes.c_void_p
    lib.rt_loop_free.argtypes = [ctypes.c_void_p]
    lib.rt_listen.restype = ctypes.c_uint64
    lib.rt_listen.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.rt_listen_port.restype = ctypes.c_int
    lib.rt_listen_port.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.rt_connect.restype = ctypes.c_uint64
    lib.rt_connect.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.rt_send.restype = ctypes.c_int
    lib.rt_send.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
                            ctypes.c_char_p, ctypes.c_uint64]
    lib.rt_close_conn.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.rt_close_listener.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.rt_poll.restype = ctypes.c_int
    lib.rt_poll.argtypes = [ctypes.c_void_p, ctypes.POINTER(_RtEvent),
                            ctypes.c_int, ctypes.c_int]
    lib.rt_fastpath_enable.restype = ctypes.c_int
    lib.rt_fastpath_enable.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                       ctypes.c_uint64]
    lib.rt_fastpath_put.restype = ctypes.c_int
    lib.rt_fastpath_put.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int]
    lib.rt_fastpath_get.restype = ctypes.c_int
    lib.rt_fastpath_get.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint64)]
    lib.rt_fastpath_del.restype = ctypes.c_int
    lib.rt_fastpath_del.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                    ctypes.c_char_p, ctypes.c_uint32]
    lib.rt_fastpath_version.restype = ctypes.c_uint64
    lib.rt_fastpath_version.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.rt_fastpath_dump.restype = ctypes.c_int64
    lib.rt_fastpath_dump.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint64)]
    lib.rt_fastpath_keys.restype = ctypes.c_int64
    lib.rt_fastpath_keys.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint64)]
    lib.rt_fastlease_stock.restype = ctypes.c_int
    lib.rt_fastlease_stock.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_uint64]
    lib.rt_fastlease_unstock.restype = ctypes.c_int
    lib.rt_fastlease_unstock.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_uint64)]
    lib.rt_fastlease_invalidate.restype = ctypes.c_int
    lib.rt_fastlease_invalidate.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64]
    lib.rt_fastlease_reclaim_conn.restype = ctypes.c_int64
    lib.rt_fastlease_reclaim_conn.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint64)]
    lib.rt_fastlease_pooled.restype = ctypes.c_int64
    lib.rt_fastlease_pooled.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint64)]
    lib.rt_fastlease_stats.restype = ctypes.c_int
    lib.rt_fastlease_stats.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64)]
    lib.rt_fastlease_depth.restype = ctypes.c_int64
    lib.rt_fastlease_depth.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64]
    lib.rt_buf_free.argtypes = [ctypes.c_void_p]
    return lib


class _Transport:
    """Per-process singleton: one C++ loop + one Python dispatcher."""

    _instance: Optional["_Transport"] = None
    _instance_lock = threading.Lock()

    @classmethod
    def get(cls) -> "_Transport":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def __init__(self):
        from ray_tpu_torch._native.build import build as _build
        path = _build()
        # Two bindings over one library: CDLL releases the GIL around every
        # call — mandatory for rt_poll (it sleeps) and for huge sends (big
        # memcpy / possible backpressure wait), but for microsecond calls
        # like rt_send of a small frame the GIL handoff costs ~100x the
        # call itself under thread contention (the caller re-queues for the
        # GIL behind the switch interval). PyDLL keeps the GIL held for
        # those fast paths.
        self.lib = _bind(ctypes.CDLL(path))
        self.fastlib = _bind(ctypes.PyDLL(path))
        self.loop = self.lib.rt_loop_new()
        self._reg_lock = threading.Lock()
        # conn routing: conn_id -> ("client", RpcClient) | ("server", conn)
        self._routes: Dict[int, tuple] = {}
        self._listeners: Dict[int, "RpcServer"] = {}
        self._evbuf = (_RtEvent * _POLL_BATCH)()
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        daemon=True, name="rt-dispatch")
        self._thread.start()

    # -- registration (all under _reg_lock so the dispatcher never sees a
    # conn before its owner is routable) --

    def listen(self, server: "RpcServer", host: str, port: int) -> int:
        # bind + register atomically: the listening fd is live in epoll the
        # moment rt_listen returns, and an accept raced against a separate
        # registration step would be dropped by the dispatcher
        with self._reg_lock:
            listener_id = self.lib.rt_listen(self.loop, host.encode(), port)
            if listener_id:
                self._listeners[listener_id] = server
        return listener_id

    def unregister_listener(self, listener_id: int) -> None:
        with self._reg_lock:
            self._listeners.pop(listener_id, None)

    def connect(self, client: "RpcClient", host: str, port: int) -> int:
        with self._reg_lock:
            conn = self.lib.rt_connect(self.loop, host.encode(), port)
            if conn:
                self._routes[conn] = ("client", client)
        return conn

    def drop_route(self, conn_id: int) -> None:
        with self._reg_lock:
            self._routes.pop(conn_id, None)

    def send(self, conn_id: int, req_id: int, data: bytes) -> int:
        # Small frames stay under the GIL (no handoff tax); bigger ones
        # release it. The cutoff MUST match transport.cc's backpressure
        # exemption (len >= 65536 may block in rt_send): a GIL-holding
        # sender waiting on backpressure would freeze the dispatcher that
        # is the only flusher.
        lib = self.fastlib if len(data) < 65536 else self.lib
        return lib.rt_send(self.loop, conn_id, req_id, data, len(data))

    # -- dispatch --

    def _dispatch_loop(self) -> None:
        lib, loop, evbuf = self.lib, self.loop, self._evbuf
        fast_poll = self.fastlib.rt_poll
        string_at = ctypes.string_at
        while True:
            # opportunistic GIL-held poll first (returns queued events with
            # no GIL handoff); only sleep in the GIL-releasing variant when
            # the queue is actually empty
            n = fast_poll(loop, evbuf, _POLL_BATCH, 0)
            if n == 0:
                n = lib.rt_poll(loop, evbuf, _POLL_BATCH, 200)
            for i in range(n):
                ev = evbuf[i]
                kind = ev.type
                try:
                    if kind == _MSG:
                        route = self._routes.get(ev.conn_id)
                        if route is None:
                            route = self._late_route(ev.conn_id)
                            if route is None:
                                continue
                        payload = string_at(ev.data, ev.len) if ev.len \
                            else b""
                        if route[0] == "client":
                            route[1]._on_reply_frame(ev.req_id, payload)
                        else:
                            route[1].server._on_frame(route[1], ev.req_id,
                                                      payload)
                    elif kind == _ACCEPT:
                        server = self._listeners.get(ev.req_id)
                        if server is None:
                            server = self._late_listener(ev.req_id)
                            if server is None:
                                self.lib.rt_close_conn(self.loop, ev.conn_id)
                                continue
                        peer = string_at(ev.data, ev.len).decode(
                            "utf-8", "replace")
                        conn = _ServerConn(server, ev.conn_id, peer)
                        with self._reg_lock:
                            self._routes[ev.conn_id] = ("server", conn)
                        server._conns[ev.conn_id] = conn
                    elif kind == _DISCONNECT:
                        with self._reg_lock:
                            route = self._routes.pop(ev.conn_id, None)
                        if route is None:
                            route = (None,)
                        if route[0] == "client":
                            route[1]._on_disconnect()
                        elif route[0] == "server":
                            route[1].server._on_conn_closed(route[1])
                except Exception:  # noqa: BLE001 — dispatcher must survive
                    import traceback
                    traceback.print_exc()

    def _late_route(self, conn_id: int) -> Optional[tuple]:
        # a frame can race the registration done right after rt_connect;
        # taking the lock guarantees any in-flight registration completed
        with self._reg_lock:
            return self._routes.get(conn_id)

    def _late_listener(self, listener_id: int) -> Optional["RpcServer"]:
        with self._reg_lock:
            return self._listeners.get(listener_id)


# ---------------------------------------------------------------------------
# server


class HandlerContext:
    """Passed to every handler; allows deferred replies and peer identity."""

    __slots__ = ("_conn", "_req_id", "peer", "replied", "slot_ids")

    def __init__(self, conn: "_ServerConn", req_id: int):
        self._conn = conn
        self._req_id = req_id
        self.peer = conn.peer
        self.replied = False
        # combined frames with pre-allocated per-slot reply ids (eager
        # per-task replies — see call_combined_cb); None on plain requests
        self.slot_ids = None

    def reply(self, value: Any = None,
              error: Optional[BaseException] = None) -> None:
        if self.replied:
            return
        self.replied = True
        self._conn.send_reply(self._req_id, value, error)

    def reply_to(self, req_id: int, value: Any = None,
                 error: Optional[BaseException] = None) -> None:
        """Reply to one pre-allocated slot id of a combined frame (the
        caller registered a pending entry per slot). Unlike reply(),
        callable many times — once per distinct slot."""
        self._conn.send_reply(req_id, value, error)


class _ServerConn:
    __slots__ = ("server", "conn_id", "peer", "alive")

    def __init__(self, server: "RpcServer", conn_id: int, peer: str):
        self.server = server
        self.conn_id = conn_id
        self.peer = peer
        self.alive = True

    def send_reply(self, req_id: int, value: Any,
                   error: Optional[BaseException]) -> None:
        if req_id == 0:  # oneway — no reply expected
            return
        from ray_tpu_torch.runtime.protocol import RpcError
        try:
            payload = pickle.dumps((value, error), protocol=5)
        except Exception as e:  # unpicklable result
            payload = pickle.dumps(
                (None, RpcError(f"unpicklable reply: {e!r}")), protocol=5)
        t = self.server._transport
        t.send(self.conn_id, req_id | _REPLY_BIT, payload)

    def close(self) -> None:
        self.alive = False
        t = self.server._transport
        t.drop_route(self.conn_id)
        t.lib.rt_close_conn(t.loop, self.conn_id)


class RpcServer:
    """Native-transport RPC server.

    Handlers: dict method -> fn(payload, ctx). A handler returns a value
    (replied immediately), raises (error reply), or returns DEFERRED and
    calls ctx.reply() later from any thread. `inline_methods` run on the
    dispatcher thread in per-connection arrival order.
    """

    def __init__(self, handlers: Dict[str, Callable[[Any, Any], Any]],
                 host: str = "127.0.0.1", port: int = 0,
                 max_workers: int = 16, name: str = "rpc",
                 inline_methods: Optional[set] = None):
        self.handlers = dict(handlers)
        self.inline_methods = set(inline_methods or ())
        self._transport = _Transport.get()
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix=f"{name}-h")
        self._conns: Dict[int, _ServerConn] = {}
        self._stopped = False
        self.on_disconnect: Optional[Callable[[Any], None]] = None
        # (conn_id, peer) variant — the head uses conn_id to reclaim
        # native-fastpath lease grants held by the dropped connection
        self.on_disconnect_conn: Optional[Callable[[int, Any], None]] = None
        self._listener = self._transport.listen(self, host, port)
        if not self._listener:
            raise OSError(f"cannot listen on {host}:{port}")
        self.host = host
        self.port = self._transport.lib.rt_listen_port(
            self._transport.loop, self._listener)
        self.address = f"{self.host}:{self.port}"

    # -- dispatcher entry points --

    def _on_frame(self, conn: _ServerConn, req_id: int,
                  payload: bytes) -> None:
        from ray_tpu_torch.runtime.protocol import RpcError
        try:
            msg = pickle.loads(payload)
        except BaseException as e:  # noqa: BLE001
            HandlerContext(conn, req_id).reply(
                None, error=RpcError(f"bad request: {e!r}"))
            return
        method = msg[0]
        if method == "__batch__":
            # batched frame: [(req_id, method, body), ...] — dispatch each
            # as an individual request (replies flow per inner id and are
            # re-coalesced by the C++ writer)
            for rid, m, body in msg[1]:
                self._dispatch_one(conn, rid, m, body)
            return
        # (method, body) or (method, body, slot_ids) — the 3rd element
        # carries pre-allocated per-slot reply ids of an eager combined
        # call; old 2-tuple frames stay accepted
        slot_ids = list(msg[2]) if len(msg) > 2 and msg[2] else None
        self._dispatch_one(conn, req_id, method, msg[1], slot_ids)

    def _dispatch_one(self, conn: _ServerConn, req_id: int, method: str,
                      body: Any, slot_ids=None) -> None:
        if method in self.inline_methods:
            self._run_handler(conn, req_id, method, body, slot_ids)
        else:
            self._pool.submit(self._run_handler, conn, req_id, method, body,
                              slot_ids)

    def _run_handler(self, conn: _ServerConn, req_id: int, method: str,
                     body: Any, slot_ids=None) -> None:
        from ray_tpu_torch.runtime.protocol import DEFERRED, RpcError
        ctx = HandlerContext(conn, req_id)
        ctx.slot_ids = slot_ids
        try:
            handler = self.handlers.get(method)
            if handler is None:
                raise RpcError(f"no handler for {method!r}")
            result = handler(body, ctx)
            if result is DEFERRED:
                return
            ctx.reply(result)
        except BaseException as e:  # noqa: BLE001
            ctx.reply(None, error=e)

    # -- native KV fast-path (host-side access) --

    def enable_kv_fastpath(self, incarnation: int = 0) -> bool:
        """Serve FAST_* frames on this listener entirely inside the C
        loop. The host process reads/writes the SAME table via the
        kv_fast_* methods below (role of the reference's C++
        GcsInternalKVManager with Python-side accessors)."""
        t = self._transport
        return t.lib.rt_fastpath_enable(t.loop, self._listener,
                                        incarnation) == 0

    def kv_fast_put(self, key: bytes, val: bytes,
                    overwrite: bool = True) -> bool:
        t = self._transport
        rc = t.fastlib.rt_fastpath_put(t.loop, self._listener, key,
                                       len(key), val, len(val),
                                       1 if overwrite else 0)
        return rc == 1  # newly created

    def kv_fast_get(self, key: bytes) -> Optional[bytes]:
        t = self._transport
        out = ctypes.c_void_p()
        out_len = ctypes.c_uint64()
        rc = t.fastlib.rt_fastpath_get(t.loop, self._listener, key,
                                       len(key), ctypes.byref(out),
                                       ctypes.byref(out_len))
        if rc != 1:
            return None
        try:
            return ctypes.string_at(out.value, out_len.value)
        finally:
            t.fastlib.rt_buf_free(out)

    def kv_fast_del(self, key: bytes) -> bool:
        t = self._transport
        return t.fastlib.rt_fastpath_del(t.loop, self._listener, key,
                                         len(key)) == 1

    def kv_fast_keys(self, prefix: bytes = b"") -> list:
        """Keys matching prefix — filtered C-side so values (possibly
        megabytes of export blobs) never cross the boundary."""
        t = self._transport
        out = ctypes.c_void_p()
        out_len = ctypes.c_uint64()
        n = t.fastlib.rt_fastpath_keys(t.loop, self._listener, prefix,
                                       len(prefix), ctypes.byref(out),
                                       ctypes.byref(out_len))
        if n < 0:
            return []
        try:
            buf = ctypes.string_at(out.value, out_len.value)
        finally:
            t.fastlib.rt_buf_free(out)
        keys = []
        off = 0
        for _ in range(n):
            (klen,) = struct.unpack_from("<I", buf, off)
            off += 4
            keys.append(buf[off:off + klen])
            off += klen
        return keys

    def kv_fast_version(self) -> int:
        t = self._transport
        return t.fastlib.rt_fastpath_version(t.loop, self._listener)

    def kv_fast_items(self) -> Dict[bytes, bytes]:
        t = self._transport
        out = ctypes.c_void_p()
        out_len = ctypes.c_uint64()
        n = t.lib.rt_fastpath_dump(t.loop, self._listener,
                                   ctypes.byref(out), ctypes.byref(out_len))
        if n < 0:
            return {}
        try:
            buf = ctypes.string_at(out.value, out_len.value)
        finally:
            t.fastlib.rt_buf_free(out)
        items: Dict[bytes, bytes] = {}
        off = 0
        for _ in range(n):
            (klen,) = struct.unpack_from("<I", buf, off)
            off += 4
            key = buf[off:off + klen]
            off += klen
            (vlen,) = struct.unpack_from("<Q", buf, off)
            off += 8
            items[key] = buf[off:off + vlen]
            off += vlen
        return items

    # -- native lease pool (host-side policy access; served peer-side by
    # FOP_LEASE_ACQ/REL inside the C loop — see transport.cc FastLease) --

    def lease_stock(self, sig: int, lease_key: int, grant: bytes) -> bool:
        t = self._transport
        return t.fastlib.rt_fastlease_stock(
            t.loop, self._listener, sig, lease_key, grant, len(grant)) == 0

    def lease_unstock(self, sig: int) -> Optional[tuple]:
        """Pop one pooled grant: (lease_key, grant_bytes) or None."""
        t = self._transport
        out_key = ctypes.c_uint64()
        out = ctypes.c_void_p()
        out_len = ctypes.c_uint64()
        rc = t.fastlib.rt_fastlease_unstock(
            t.loop, self._listener, sig, ctypes.byref(out_key),
            ctypes.byref(out), ctypes.byref(out_len))
        if rc != 1:
            return None
        try:
            return out_key.value, ctypes.string_at(out.value, out_len.value)
        finally:
            t.fastlib.rt_buf_free(out)

    def lease_invalidate(self, lease_key: int) -> int:
        """2 = was held, 1 = was pooled, 0 = unknown, -1 = no fastpath."""
        t = self._transport
        return t.fastlib.rt_fastlease_invalidate(t.loop, self._listener,
                                                 lease_key)

    def lease_reclaim_conn(self, conn_id: int) -> list:
        """All grants held by a disconnected conn: [(lease_key, sig,
        grant_bytes)], removed from the C-side table."""
        t = self._transport
        out = ctypes.c_void_p()
        out_len = ctypes.c_uint64()
        n = t.fastlib.rt_fastlease_reclaim_conn(
            t.loop, self._listener, conn_id, ctypes.byref(out),
            ctypes.byref(out_len))
        if n <= 0:
            if n > -1 and out.value:
                t.fastlib.rt_buf_free(out)
            return []
        try:
            buf = ctypes.string_at(out.value, out_len.value)
        finally:
            t.fastlib.rt_buf_free(out)
        items = []
        off = 0
        for _ in range(n):
            lkey, sig, blen = struct.unpack_from("<QQQ", buf, off)
            off += 24
            items.append((lkey, sig, buf[off:off + blen]))
            off += blen
        return items

    def lease_pooled_keys(self) -> list:
        """Lease keys currently POOLED (grantable, un-held) — their
        resources are reclaimable in one drain and therefore reported as
        available by the head."""
        t = self._transport
        out = ctypes.c_void_p()
        out_len = ctypes.c_uint64()
        n = t.fastlib.rt_fastlease_pooled(
            t.loop, self._listener, ctypes.byref(out),
            ctypes.byref(out_len))
        if n <= 0:
            if n > -1 and out.value:
                t.fastlib.rt_buf_free(out)
            return []
        try:
            buf = ctypes.string_at(out.value, out_len.value)
        finally:
            t.fastlib.rt_buf_free(out)
        keys = []
        for off in range(0, len(buf), 16):
            _sig, lkey = struct.unpack_from("<QQ", buf, off)
            keys.append(lkey)
        return keys

    def lease_stats(self) -> Optional[dict]:
        t = self._transport
        out = (ctypes.c_uint64 * 4)()
        if t.fastlib.rt_fastlease_stats(t.loop, self._listener, out) != 0:
            return None
        return {"hits": out[0], "misses": out[1], "pooled": out[2],
                "held": out[3]}

    def lease_depth(self, sig: int) -> int:
        t = self._transport
        return max(0, t.fastlib.rt_fastlease_depth(t.loop, self._listener,
                                                   sig))

    def _on_conn_closed(self, conn: _ServerConn) -> None:
        conn.alive = False
        self._conns.pop(conn.conn_id, None)
        if not self._stopped and self.on_disconnect_conn is not None:
            try:
                self.on_disconnect_conn(conn.conn_id, conn.peer)
            except Exception:  # noqa: BLE001
                pass
        if self.on_disconnect is not None and not self._stopped:
            try:
                self.on_disconnect(conn.peer)
            except Exception:  # noqa: BLE001
                pass

    def stop(self) -> None:
        self._stopped = True
        self._transport.unregister_listener(self._listener)
        self._transport.lib.rt_close_listener(self._transport.loop,
                                              self._listener)
        for conn in list(self._conns.values()):
            conn.close()
        self._conns.clear()
        self._pool.shutdown(wait=False, cancel_futures=True)


# ---------------------------------------------------------------------------
# client


class RpcClient:
    """Native-transport client.

    Many calls pipeline over one connection; completions are resolved by
    the process-wide dispatcher thread. call_batch_cb() sends many requests
    in ONE frame (one pickle, one send) with per-request completion
    callbacks — the task submitters' hot path.
    """

    def __init__(self, address: str, name: str = "client"):
        self.address = address
        host, port = address.rsplit(":", 1)
        self._host, self._port = host, int(port)
        self._name = name
        self._transport = _Transport.get()
        self._conn: Optional[int] = None
        self._conn_lock = threading.Lock()
        self._pending: Dict[int, Any] = {}  # req_id -> Future | callback
        self._pending_lock = threading.Lock()
        self._next_id = 0
        self._id_lock = threading.Lock()
        self._closed = False

    # -- connection management --

    def _connect(self) -> int:
        from ray_tpu_torch.runtime.protocol import RpcError
        with self._conn_lock:
            if self._conn is not None:
                return self._conn
            if self._closed:
                raise RpcError("client closed")
            conn = self._transport.connect(self, self._host, self._port)
            if not conn:
                raise RpcError(f"cannot resolve {self.address}")
            self._conn = conn
            return conn

    def _on_disconnect(self) -> None:
        from ray_tpu_torch.runtime.protocol import RpcError
        self._fail_all(RpcError(f"connection to {self.address} lost"))

    def _fail_all(self, exc: Exception) -> None:
        with self._conn_lock:
            conn, self._conn = self._conn, None
        if conn is not None:
            self._transport.drop_route(conn)
        with self._pending_lock:
            pending = list(self._pending.values())
            self._pending.clear()
        for entry in pending:
            self._complete(entry, None, exc)

    # -- completion plumbing (dispatcher thread) --

    @staticmethod
    def _complete(entry: Any, value: Any, error: Optional[BaseException]
                  ) -> None:
        if isinstance(entry, Future):
            if entry.done():
                return
            if error is not None:
                entry.set_exception(error)
            else:
                entry.set_result(value)
        else:
            try:
                entry(value, error)
            except Exception:  # noqa: BLE001
                import traceback
                traceback.print_exc()

    def _on_reply_frame(self, req_id: int, payload: bytes) -> None:
        from ray_tpu_torch.runtime.protocol import RpcError
        req_id &= ~_REPLY_BIT
        fast = bool(req_id & _FAST_BIT)
        req_id &= ~_FAST_BIT
        with self._pending_lock:
            entry = self._pending.pop(req_id, None)
        if entry is None:
            return
        if fast:
            # binary fast-path reply: (status, value bytes). A peer that
            # answered via the Python path instead (conn accepted before
            # rt_fastpath_enable, or head restarted without the fastpath)
            # sends a pickled tuple here — its first byte (0x80) is not a
            # valid status, so validate the frame shape and surface a
            # transport error rather than returning garbage as a KV miss.
            ok = len(payload) >= _FAST_REP.size
            if ok:
                status, vlen = _FAST_REP.unpack_from(payload)
                ok = status in (0, 1) and vlen == len(payload) - _FAST_REP.size
            if not ok:
                from ray_tpu_torch.runtime.protocol import FastPathUnavailable
                self._complete(entry, None, FastPathUnavailable(
                    "fast-path reply malformed (peer likely served the "
                    "Python path); use the pickle path"))
                return
            self._complete(entry, (status, payload[_FAST_REP.size:]), None)
            return
        try:
            value, error = pickle.loads(payload)
        except BaseException as e:  # noqa: BLE001
            self._complete(entry, None, RpcError(f"bad reply: {e!r}"))
            return
        self._complete(entry, value, error)

    # -- calls --

    def _alloc_id(self) -> int:
        with self._id_lock:
            self._next_id += 1
            return self._next_id

    def _send(self, conn: int, req_id: int, data: bytes) -> bool:
        return self._transport.send(conn, req_id, data) == 0

    def call_async(self, method: str, payload: Any = None) -> Future:
        from ray_tpu_torch.runtime.protocol import (ChaosInjectedError, RpcError,
                                              _chaos_should_fail)
        fut: Future = Future()
        if _chaos_should_fail(method):
            fut.set_exception(ChaosInjectedError(f"chaos: {method}"))
            return fut
        cfg = config_mod.GlobalConfig
        if cfg.testing_rpc_delay_ms:
            time.sleep(cfg.testing_rpc_delay_ms / 1000.0)
        req_id = self._alloc_id()
        fut._rtpu_req_id = req_id  # lets call() reap on timeout
        with self._pending_lock:
            self._pending[req_id] = fut
        try:
            conn = self._connect()
            data = pickle.dumps((method, payload), protocol=5)
            if not self._send(conn, req_id, data):
                raise RpcError(f"connection to {self.address} lost")
        except BaseException as e:  # noqa: BLE001
            with self._pending_lock:
                self._pending.pop(req_id, None)
            if not fut.done():
                fut.set_exception(
                    e if isinstance(e, RpcError) else RpcError(repr(e)))
        return fut

    def call_combined_cb(self, method: str, payloads: list,
                         callback: Callable[
                             [int, Any, Optional[BaseException]], None]
                         ) -> None:
        """Send N sub-payloads as ONE request frame, with a pre-allocated
        reply id per slot shipped alongside (3rd frame element). An eager
        peer replies per slot the moment that slot finishes — so a slot
        whose result a batchmate depends on is never withheld behind
        unfinished batchmates — then closes with _COMBINED_DONE on the
        main id. A peer that instead replies once with a list of N
        (value, error) pairs (old single-reply servers, plain handlers)
        is equally accepted. Either way callback(i, value, error) fires
        exactly once per slot, on the dispatcher thread (must not block).
        On transport failure every not-yet-fired callback fires with the
        error, same contract as call_batch_cb."""
        from ray_tpu_torch.runtime.protocol import (ChaosInjectedError,
                                              RpcError, _COMBINED_DONE,
                                              _chaos_should_fail)
        cfg = config_mod.GlobalConfig
        if cfg.testing_rpc_delay_ms:
            time.sleep(cfg.testing_rpc_delay_ms / 1000.0)
        n = len(payloads)
        lock = threading.Lock()
        done = [False] * n

        def fire(i, value, error):
            with lock:
                if done[i]:
                    return
                done[i] = True
            callback(i, value, error)

        slot_ids = [self._alloc_id() for _ in range(n)]
        req_id = self._alloc_id()

        def fanout(value, error):
            # main-request reply: drop the slot entries first so a peer
            # that answered with one combined list (or an error) doesn't
            # leak N pending entries
            with self._pending_lock:
                for rid in slot_ids:
                    self._pending.pop(rid, None)
            if error is None:
                if isinstance(value, list) and len(value) == n:
                    for i, (v, e) in enumerate(value):
                        fire(i, v, e)
                    return
                if value == _COMBINED_DONE:
                    # all slots should have their own replies by now (the
                    # marker is sent last on the same ordered connection);
                    # any still-unfired slot means the peer lost one
                    error = RpcError(
                        f"combined call {method}: peer finished without "
                        f"replying to every slot")
                else:
                    error = RpcError(
                        f"malformed combined reply for {method}: "
                        f"expected list of {n}, got {type(value).__name__}")
            for i in range(n):
                fire(i, None, error)

        with self._pending_lock:
            for i, rid in enumerate(slot_ids):
                self._pending[rid] = (lambda v, e, i=i: fire(i, v, e))
            self._pending[req_id] = fanout
        try:
            if _chaos_should_fail(method):
                raise ChaosInjectedError(f"chaos: {method}")
            conn = self._connect()
            data = pickle.dumps((method, payloads, slot_ids), protocol=5)
            if not self._send(conn, req_id, data):
                raise RpcError(f"connection to {self.address} lost")
        except BaseException as e:  # noqa: BLE001
            with self._pending_lock:
                entry = self._pending.pop(req_id, None)
                for rid in slot_ids:
                    self._pending.pop(rid, None)
            if entry is not None:
                err = e if isinstance(e, RpcError) else RpcError(repr(e))
                for i in range(n):
                    fire(i, None, err)

    def call_batch_cb(self, method: str, payloads: list,
                      callback: Callable[[int, Any, Optional[BaseException]],
                                         None]) -> list:
        """Send many requests of one method in a single frame.

        callback(index, value, error) fires once per request, on the
        dispatcher thread (must not block). Returns the request ids.
        On transport failure, every not-yet-completed request's callback
        fires with the error.
        """
        from ray_tpu_torch.runtime.protocol import (ChaosInjectedError, RpcError,
                                              _chaos_should_fail)
        cfg = config_mod.GlobalConfig
        if cfg.testing_rpc_delay_ms:
            time.sleep(cfg.testing_rpc_delay_ms / 1000.0)
        items = []
        ids = []
        with self._pending_lock:
            for i, p in enumerate(payloads):
                req_id = self._alloc_id()
                ids.append(req_id)
                self._pending[req_id] = \
                    (lambda v, e, i=i: callback(i, v, e))
                items.append((req_id, method, p))
        chaos_fail = _chaos_should_fail(method)
        try:
            if chaos_fail:
                raise ChaosInjectedError(f"chaos: {method}")
            conn = self._connect()
            data = pickle.dumps(("__batch__", items), protocol=5)
            if not self._send(conn, 0, data):
                raise RpcError(f"connection to {self.address} lost")
        except BaseException as e:  # noqa: BLE001
            err = e if isinstance(e, RpcError) else RpcError(repr(e))
            with self._pending_lock:
                entries = [self._pending.pop(rid, None) for rid in ids]
            for entry in entries:
                if entry is not None:
                    self._complete(entry, None, err)
        return ids

    def call_fast(self, op: int, key: bytes = b"", val: bytes = b"",
                  flags: int = 0,
                  timeout: Optional[float] = None) -> tuple:
        """Binary KV fast-path call, served inside the peer's C loop
        (no Python on the server). Returns (status, value_bytes).
        Only valid against a server with the fastpath enabled."""
        from ray_tpu_torch.runtime.protocol import RpcError
        if timeout is None:
            timeout = config_mod.GlobalConfig.rpc_call_timeout_s
        fut: Future = Future()
        req_id = self._alloc_id()
        with self._pending_lock:
            self._pending[req_id] = fut
        data = _FAST_REQ.pack(op, flags, len(key), len(val)) + key + val
        try:
            conn = self._connect()
            if self._transport.send(conn, req_id | _FAST_BIT, data) != 0:
                raise RpcError(f"connection to {self.address} lost")
        except BaseException as e:  # noqa: BLE001
            with self._pending_lock:
                self._pending.pop(req_id, None)
            raise e if isinstance(e, RpcError) else RpcError(repr(e))
        try:
            return fut.result(timeout=timeout)
        except TimeoutError:
            with self._pending_lock:
                self._pending.pop(req_id, None)
            raise RpcError(f"fast call to {self.address} timed out "
                           f"after {timeout}s") from None

    def call(self, method: str, payload: Any = None,
             timeout: Optional[float] = None) -> Any:
        from ray_tpu_torch.runtime.protocol import RpcError
        cfg = config_mod.GlobalConfig
        if timeout is None:
            timeout = cfg.rpc_call_timeout_s
        fut = self.call_async(method, payload)
        try:
            return fut.result(timeout=timeout)
        except TimeoutError:
            req_id = getattr(fut, "_rtpu_req_id", None)
            if req_id is not None:
                with self._pending_lock:
                    self._pending.pop(req_id, None)
            raise RpcError(f"call {method} to {self.address} timed out "
                           f"after {timeout}s") from None

    def call_retrying(self, method: str, payload: Any = None,
                      timeout: Optional[float] = None) -> Any:
        from ray_tpu_torch.runtime.protocol import RpcError
        cfg = config_mod.GlobalConfig
        attempts = max(1, cfg.rpc_retry_max_attempts)
        delay = cfg.rpc_retry_base_ms / 1000.0
        last: Optional[Exception] = None
        for i in range(attempts):
            try:
                return self.call(method, payload, timeout=timeout)
            except RpcError as e:
                last = e
                if i + 1 < attempts:
                    time.sleep(delay)
                    delay = min(delay * 2, 5.0)
        raise last  # type: ignore[misc]

    def oneway(self, method: str, payload: Any = None) -> bool:
        """Fire-and-forget. Returns True if the frame was handed to the
        transport (rt_send accepted it); False on a definite send failure
        so cleanup-critical callers (object deletes) can retry."""
        from ray_tpu_torch.runtime.protocol import _chaos_should_fail
        if _chaos_should_fail(method):
            return True
        try:
            conn = self._connect()
            data = pickle.dumps((method, payload), protocol=5)
            return self._send(conn, 0, data)
        except BaseException:  # noqa: BLE001
            return False

    def close(self) -> None:
        from ray_tpu_torch.runtime.protocol import RpcError
        self._closed = True
        with self._conn_lock:
            conn, self._conn = self._conn, None
        if conn is not None:
            self._transport.drop_route(conn)
            self._transport.lib.rt_close_conn(self._transport.loop, conn)
        self._fail_all(RpcError("client closed"))
