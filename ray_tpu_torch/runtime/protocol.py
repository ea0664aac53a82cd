"""Framed RPC over TCP: request-id multiplexing, retries, chaos injection.

Role-equivalent to the reference's rpc layer (reference:
src/ray/rpc/grpc_server.h, grpc_client.h, retryable_grpc_client.h): typed
async calls over persistent connections. Design differences are deliberate:
instead of gRPC streams we frame pickled dicts over a TCP socket with a
request-id so many calls pipeline over one connection (the property that
makes lease/push pipelining and 8k tasks/s possible in the reference);
replies may be deferred by the handler (actor queues reply on completion).

`RpcServer` and `RpcClient` are the native C++ epoll transport
(src/transport.cc, bound in protocol_native.py); this module holds what the
transport and its callers share: the error types, the handler sentinels,
the client pool and chaos injection.

Chaos injection mirrors reference src/ray/rpc/rpc_chaos.h:23
(RAY_testing_rpc_failure): config `testing_rpc_failure="method=N[,m=N]"`
fails the first N client calls of that method with RpcError so retry paths
are testable without real network faults.
"""

from __future__ import annotations

import threading
from typing import Dict

from ray_tpu_torch.core import config as config_mod
from ray_tpu_torch.runtime.protocol_native import RpcClient, RpcServer

__all__ = ["RpcError", "ChaosInjectedError", "FastPathUnavailable",
           "RpcServer", "RpcClient", "ClientPool", "DEFERRED",
           "reset_chaos"]


class RpcError(Exception):
    """Transport-level failure (connect refused, peer died, chaos)."""


class ChaosInjectedError(RpcError):
    pass


class FastPathUnavailable(RpcError):
    """The peer answered a binary fast frame via its Python path — the
    fast path is deterministically absent there; callers should drop to
    the pickle path immediately instead of retrying the fast frame."""


def _chaos_table() -> Dict[str, int]:
    raw = config_mod.GlobalConfig.testing_rpc_failure
    table: Dict[str, int] = {}
    if raw:
        for part in raw.split(","):
            if "=" in part:
                k, v = part.split("=", 1)
                table[k.strip()] = int(v)
    return table


class _ChaosState:
    """Per-process count of injected failures, keyed by method."""

    def __init__(self):
        self._lock = threading.Lock()
        self._injected: Dict[str, int] = {}

    def should_fail(self, method: str) -> bool:
        budget = _chaos_table().get(method)
        if not budget:
            return False
        with self._lock:
            used = self._injected.get(method, 0)
            if used >= budget:
                return False
            self._injected[method] = used + 1
            return True


_chaos = _ChaosState()


def reset_chaos() -> None:
    global _chaos
    _chaos = _ChaosState()


def _chaos_should_fail(method: str) -> bool:
    """Current-table chaos check (shared with the native transport)."""
    return _chaos.should_fail(method)


# ---------------------------------------------------------------------------
# handler protocol

DEFERRED = object()  # handler sentinel: "I'll call ctx.reply() later"

#: final main-request reply of an eagerly-flushed combined call: every
#: slot already got its own reply frame; this closes the exchange
_COMBINED_DONE = "__combined_done__"


class ClientPool:
    """Address -> RpcClient cache (one persistent connection per peer)."""

    def __init__(self, name: str = "pool"):
        self._name = name
        self._clients: Dict[str, RpcClient] = {}
        self._lock = threading.Lock()

    def get(self, address: str) -> RpcClient:
        with self._lock:
            c = self._clients.get(address)
            if c is None:
                c = RpcClient(address, name=self._name)
                self._clients[address] = c
            return c

    def invalidate(self, address: str) -> None:
        with self._lock:
            c = self._clients.pop(address, None)
        if c is not None:
            c.close()

    def close_all(self) -> None:
        with self._lock:
            clients = list(self._clients.values())
            self._clients.clear()
        for c in clients:
            c.close()
