"""Shared-memory payload lane: co-located frames skip the socket body.

Control and data take different paths.  A frame whose payload crosses
``SHM_THRESHOLD`` between processes on the *same machine* is split: the
header (tiny, pickled) still rides the socket, but the payload is
written once into a named shared-memory **segment** and the header
carries an out-of-band descriptor (``{"name", "size"}``) instead of the
bytes.  The receiver maps the segment and reads the payload in place --
the body never transits a socket buffer, is never copied into the
broker, and for a queued envelope is read exactly twice (producer write,
consumer read) instead of four socket copies.

Segments are plain files in the POSIX shared-memory namespace
(``/dev/shm`` tmpfs; ``shm_open`` semantics), accessed with ``mmap``.
``multiprocessing.shared_memory`` is deliberately NOT used: on this
interpreter (< 3.13, no ``track=False``) every *attaching* process
registers the segment with its resource tracker, which unlinks it when
that process exits -- a consumer reading a broker-owned segment would
destroy it for everyone else (bpo-39959).  Raw tmpfs files give the
exact create/unlink control the ownership protocol below needs, and a
sweep is just a directory listing.

Ownership protocol (tied to the lease/ack lifecycle):

1. The **producer** creates the segment and sends the descriptor.  Until
   the broker's response arrives the producer is the owner: a send error
   unlinks the segment (nothing references it).  On a *connection* error
   the broker may or may not have received the frame, so the producer
   must NOT unlink -- a leak swept at fabric teardown is recoverable, a
   destroyed segment under a delivered envelope is a lost task.
2. The **broker** owns the segment from frame receipt to envelope
   destruction: a rejected claim unlinks immediately; an acked lease
   unlinks; an *expired* lease redelivers the descriptor intact (the
   SIGKILLed consumer never owned the segment, so its death can neither
   leak it past the broker's registry nor double-free it).
3. **Consumers** only ever map and read.  They never unlink.
4. ``sweep_scope`` removes every segment of a fabric's scope token --
   run at transport teardown (after the broker is down) it reclaims the
   only reachable leaks: producer died pre-handoff, or the broker itself
   was SIGKILLed.  Scope tokens are per-fabric, so sweeping a dead
   fabric can never touch a live one's segments.

Descriptors are flat dicts of literal keys (``name``/``size``) so the
frame-header hygiene lint can check them like any other header field.
"""
from __future__ import annotations

import mmap
import os
import threading
import uuid
from typing import Optional

SHM_PREFIX = "colmena-seg-"
SHM_THRESHOLD = 256 * 1024          # bytes; >= this rides shared memory

_DIRS = ("/dev/shm", "/run/shm")


def shm_dir() -> Optional[str]:
    """The machine's POSIX shm mount (None disables the lane, e.g. on
    platforms without a tmpfs shm namespace)."""
    for d in _DIRS:
        if os.path.isdir(d) and os.access(d, os.W_OK):
            return d
    return None


def new_scope() -> str:
    """A fabric-unique scope token baked into every segment name, so
    teardown can sweep exactly one fabric's segments."""
    return uuid.uuid4().hex[:12]


_counter_lock = threading.Lock()
_counter = 0


def _next_name(scope: str) -> str:
    global _counter
    with _counter_lock:
        _counter += 1
        n = _counter
    return f"{SHM_PREFIX}{scope}-{os.getpid()}-{n}"


def create_segment(scope: str, payload) -> Optional[dict]:
    """Write ``payload`` into a fresh segment; returns its descriptor
    (flat, literal keys -- it travels in a frame header) or None when
    the machine has no shm namespace.  The caller owns the segment until
    it hands the descriptor off (see the module's ownership protocol);
    on any error during the write the segment is unlinked here -- the
    error path can never leak a half-written segment."""
    d = shm_dir()
    if d is None:
        return None
    name = _next_name(scope)
    path = os.path.join(d, name)
    fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o600)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
    except BaseException:
        try:
            os.unlink(path)
        except OSError:
            pass
        raise
    return {"name": name, "size": len(payload)}


def read_segment(desc: dict) -> bytes:
    """Map the segment and copy its payload out (one read; the socket
    path would have copied it at least twice more).  Consumers call this
    and nothing else -- never unlink."""
    d = shm_dir()
    if d is None:
        raise FileNotFoundError("no shm namespace on this machine")
    size = desc["size"]
    fd = os.open(os.path.join(d, desc["name"]), os.O_RDONLY)
    try:
        if size == 0:
            return b""
        with mmap.mmap(fd, size, prot=mmap.PROT_READ) as m:
            return bytes(m)
    finally:
        os.close(fd)


def unlink_segment(desc: dict) -> None:
    """Destroy a segment (owner only).  Idempotent: unlinking a name
    twice, or one already swept, is a no-op -- segment names are never
    reused, so a double unlink cannot hit an innocent bystander."""
    d = shm_dir()
    if d is None:
        return
    try:
        os.unlink(os.path.join(d, desc["name"]))
    except OSError:
        pass


def sweep_scope(scope: str) -> list:
    """Unlink every segment of ``scope``; returns the swept names.  Only
    safe once the scope's fabric is down (its broker no longer serves
    any descriptor) -- the launcher/transport teardown path, or a test
    asserting no leaks."""
    d = shm_dir()
    if d is None:
        return []
    prefix = f"{SHM_PREFIX}{scope}-"
    swept = []
    try:
        names = os.listdir(d)
    except OSError:
        return []
    for name in names:
        if name.startswith(prefix):
            try:
                os.unlink(os.path.join(d, name))
                swept.append(name)
            except OSError:
                pass
    return swept


def live_segments(scope: str) -> list:
    """Segment names currently present for ``scope`` (diagnostics and
    the leak assertions in the chaos tests)."""
    d = shm_dir()
    if d is None:
        return []
    prefix = f"{SHM_PREFIX}{scope}-"
    try:
        return sorted(n for n in os.listdir(d) if n.startswith(prefix))
    except OSError:
        return []
