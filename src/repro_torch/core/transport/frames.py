"""Length-prefixed frame protocol shared by the broker and VS shards.

Frame layout::

    uint32 header_len (big-endian) | header (pickled dict) | payload bytes

The header is a *small* control dict (op name, topic, sizes); the payload
is opaque bytes appended verbatim -- for queue ops it is the message's
single pickle, so servers relay it without ever deserializing it.  The
header carries ``plen`` (payload length) so one recv loop reads exactly
one frame.

``FrameClient`` keeps one socket per (process, thread): a blocked ``get``
occupies its connection server-side, so concurrent client threads each get
their own; after a ``fork`` the inherited sockets are abandoned (keyed by
pid) and fresh connections are opened lazily -- this is what makes the
client objects safe to capture in forked worker processes.
"""
from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
from typing import Callable, Optional, Tuple

_LEN = struct.Struct(">I")


# ---------------------------------------------------------------------------
# Frame IO
# ---------------------------------------------------------------------------


def send_frame(sock: socket.socket, header: dict, payload: bytes = b"") -> None:
    header = dict(header)
    header["plen"] = len(payload)
    hbytes = pickle.dumps(header, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(hbytes)) + hbytes + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    parts = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed")
        parts.append(chunk)
        n -= len(chunk)
    return b"".join(parts)


def recv_frame(sock: socket.socket) -> Tuple[dict, bytes]:
    hlen = _LEN.unpack(_recv_exact(sock, _LEN.size))[0]
    header = pickle.loads(_recv_exact(sock, hlen))
    payload = _recv_exact(sock, header["plen"]) if header["plen"] else b""
    return header, payload


# ---------------------------------------------------------------------------
# Addresses: prefer Unix-domain sockets, fall back to loopback TCP
# ---------------------------------------------------------------------------


def make_server_socket(path_hint: str, tcp: bool = False,
                       host: str = "127.0.0.1") -> Tuple[socket.socket, tuple]:
    """Bind a listening socket; returns (sock, address) where address is
    ("unix", path) or ("tcp", host, port).  ``tcp=True`` skips the
    Unix-domain preference -- cluster deployments need an address a
    process on another (possibly simulated) host can dial."""
    if not tcp and hasattr(socket, "AF_UNIX"):
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            sock.bind(path_hint)
            sock.listen(128)
            return sock, ("unix", path_hint)
        except OSError:
            sock.close()
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.bind((host, 0))
    sock.listen(128)
    return sock, ("tcp", host, sock.getsockname()[1])


def connect(address: tuple) -> socket.socket:
    if address[0] == "unix":
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.connect(address[1])
    else:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.connect((address[1], address[2]))
    return sock


# ---------------------------------------------------------------------------
# Client: one lazily-opened socket per (pid, thread); one request in flight
# ---------------------------------------------------------------------------


class FrameClient:
    def __init__(self, address: tuple):
        self.address = address
        self._tls = threading.local()
        self._pid = os.getpid()

    def _sock(self) -> socket.socket:
        # after fork: inherited sockets are shared with the parent; abandon
        # them and reconnect in the child
        if os.getpid() != self._pid:
            self._pid = os.getpid()
            self._tls = threading.local()
        sock = getattr(self._tls, "sock", None)
        if sock is None:
            sock = self._tls.sock = connect(self.address)
        return sock

    def request(self, header: dict, payload: bytes = b"",
                retry: bool = False) -> Tuple[dict, bytes]:
        """retry: reconnect-and-resend once on a dropped connection.  Only
        set it for ops declared idempotent in
        ``repro_torch.analysis.idempotent_ops.IDEMPOTENT_OPS`` (each entry
        carries the one-line justification; the module docstring argues
        the deliberate exclusions -- get, claim, put, renew, ack).  The
        ``idempotent-retry-registry`` fabriclint pass enforces this at
        every call site.  A response carrying an ``error`` header
        (server-side handler exception) is raised here as RuntimeError."""
        sock = self._sock()
        try:
            send_frame(sock, header, payload)
            resp = recv_frame(sock)
        except (ConnectionError, OSError):
            self._tls.sock = None
            if not retry:
                raise
            sock = self._sock()
            send_frame(sock, header, payload)
            resp = recv_frame(sock)
        if "error" in resp[0]:
            raise RuntimeError(
                f"{header.get('op')} failed server-side: {resp[0]['error']}")
        return resp

    def probe(self, timeout: float = 1.0) -> bool:
        """Liveness check on a *fresh* connection (the cached per-thread
        socket is left alone): dial, ping, and answer within ``timeout``.
        Used by shard rebalancing to decide whether a departing member
        can still be drained or must be rebuilt from its replicas -- a
        blocked cached socket must not make a live shard look dead."""
        try:
            sock = connect(self.address)
        except OSError:
            return False
        try:
            sock.settimeout(timeout)
            send_frame(sock, {"op": "ping"})
            recv_frame(sock)
            return True
        except (OSError, ConnectionError):
            return False
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def close(self) -> None:
        sock = getattr(self._tls, "sock", None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
            self._tls.sock = None


# ---------------------------------------------------------------------------
# Server: accept loop + one handler thread per connection
# ---------------------------------------------------------------------------


def serve_forever(sock: socket.socket,
                  handle: Callable[[dict, bytes], Optional[Tuple[dict, bytes]]],
                  stop: threading.Event) -> None:
    """Blocking accept loop.  ``handle(header, payload)`` returns the
    response ``(header, payload)`` -- it may block (e.g. a queue get), which
    only parks that connection's thread.  Returning None shuts the server
    down (after acking the requester)."""

    def conn_loop(conn: socket.socket) -> None:
        try:
            while not stop.is_set():
                header, payload = recv_frame(conn)
                try:
                    out = handle(header, payload)
                except Exception as e:                 # noqa: BLE001
                    # a handler error must not kill the connection: report
                    # it in-band so the client can raise it at the caller
                    send_frame(conn, {"error": f"{e!r}"})
                    continue
                if out is None:
                    send_frame(conn, {"ok": True})
                    stop.set()
                    # unblock the accept loop
                    try:
                        connect_addr = sock.getsockname()
                        if sock.family == getattr(socket, "AF_UNIX", None):
                            connect(("unix", connect_addr)).close()
                        else:
                            connect(("tcp", connect_addr[0],
                                     connect_addr[1])).close()
                    except OSError:
                        pass
                    return
                send_frame(conn, out[0], out[1])
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    while not stop.is_set():
        try:
            conn, _ = sock.accept()
        except OSError:
            return
        threading.Thread(target=conn_loop, args=(conn,), daemon=True).start()
