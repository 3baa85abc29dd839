"""Pluggable transport fabric: how Colmena messages cross process boundaries.

The paper runs Thinker, Task Server, and the Redis queue/value store as
*separate processes* spanning nodes (§III, Fig. 2); everything above this
package (``ColmenaQueues``, Task Servers, Thinkers) is transport-agnostic
and selects a backend by name:

- ``local``  -- today's in-process fabric: per-topic ``Condition``-notified
  deques (the PR-1 ``_WakeQueue``), zero-copy envelopes, no sockets.
- ``proc``   -- a stdlib-only socket fabric: a **broker process** owns every
  per-topic request/result queue and serves them over a Unix-domain socket
  (TCP fallback) to any number of client processes.

Both backends implement the same two-method surface: ``Transport.channel
(topic, kind)`` returns a ``Channel`` with ``put`` / ``get_batch`` /
``wake`` exactly mirroring the in-process queue semantics (blocking
consumers, batched drains, ``wake_all`` for shutdown).

Frame protocol (``proc`` backend)
---------------------------------
Every request and response is one length-prefixed frame::

    uint32 header_len | header (pickle of a small dict) | payload bytes

The header carries the op ("put", "get", "wake", "claim", "vs_*", ...) and
its small arguments (topic, kind, timeouts, metadata); the payload is the
message's **already-pickled** envelope bytes, appended verbatim.  The
broker never unpickles a payload -- the single pickle paid by the sender
*is* the wire format, so serialization still happens exactly once per hop
(the envelope meta that used to ride a NamedTuple rides the frame header).

Blocking semantics are preserved on the wire: a ``get`` request parks a
per-connection handler thread on the broker's queue Condition until items
arrive, a ``wake`` bumps the wake epoch (releasing every parked getter so
cancel events propagate), or the client-supplied timeout lapses -- the
client simply blocks in ``recv`` with no polling loop on either side.
Batched drains survive too: one ``get`` frame can return up to ``max_n``
envelopes concatenated in a single response payload.

Delivery is **leased** (exactly-once dispatch), on both backends: a
``get`` moves its envelopes to an in-flight ledger under a lease id
instead of destroying them, consumers ``ack`` once the batch is safely
handed off (acks piggyback on the next outgoing frame, so the hot path
stays one round-trip), and an unacked lease -- consumer SIGKILL, dropped
response frame -- expires and requeues its envelopes for redelivery.
Publishers that must be exactly-once fuse an atomic first-completion
claim into the enqueue (``put(env, claim=task_id)``), so a redelivery
racing a slow-but-alive original yields exactly one published result.
``Transport.snapshot()/restore()`` serialize the whole fabric state
(queued + leased envelopes, claim window, wake epochs) as one consistent
cut -- the substrate of ``ColmenaQueues.checkpoint``/``resume`` and
campaign-level restart without resubmission.

Control plane vs data plane
---------------------------
The fabric splits who *supervises* work from who *moves* its bytes.

**Data plane** -- envelope bytes take the shortest path that exists:

- **Direct subscription**: every consumer (pool worker, inference
  shard, Thinker) discovers its topic's home broker through the
  ``endpoints`` op (peer map + partition, advertised by every broker of
  a federation) and dials it directly, holding and renewing its *own*
  lease.  In a cluster this removes the per-frame relay hop the
  federation layer used to take for remotely-homed topics -- the relay
  remains only as a correctness fallback for clients that haven't
  discovered yet.
- **Shared-memory lane** (``transport.shm``): between co-located
  processes, a payload >= ``SHM_THRESHOLD`` rides a ``/dev/shm``
  segment; the frame header carries a flat ``{"name", "size"}``
  descriptor and the socket carries no body.  Segment ownership is tied
  to the lease lifecycle (producer until handoff, broker until
  ack/claim-reject, consumers only map and read), so a SIGKILLed
  consumer can neither leak a segment past the broker's registry nor
  double-free it; fabric teardown sweeps the scope.
- **Typed array codec** (``transport.ndcodec``): Value Server payloads
  that are numpy/jax arrays serialize as a self-describing typed header
  plus the raw buffer -- ``pickle`` never touches the array body, and
  decode returns a zero-copy view (re-wrapped on device for jax).

**Control plane** -- supervision stays where the global view is: the
pool parent watches worker liveness and straggler timers (scheduling
backup clones broker-side via the ``backup`` op, with placement
exclusions in envelope meta), the federation coordinator owns
partition/topology, and the launcher owns process lifecycle + the shm
scope sweep.  Control messages are small and infrequent; they never
carry payload bytes.

The same frame protocol serves the sharded Value Server
(``transport.shards``): each ``ValueServerShard`` is a process exposing
put/get/ref ops over its own socket, and clients route keys to shards by
consistent hashing.
"""
from __future__ import annotations

from repro_torch.core.transport.base import Channel, Envelope, Transport  # noqa: F401
from repro_torch.core.transport.local import LocalTransport  # noqa: F401


def make_transport(backend: str = "local", **kwargs) -> Transport:
    """Create a transport backend by name (``local`` or ``proc``)."""
    if backend == "local":
        return LocalTransport(**kwargs)
    if backend == "proc":
        from repro_torch.core.transport.proc import ProcTransport
        return ProcTransport(**kwargs)
    raise ValueError(f"unknown transport backend {backend!r}; "
                     "expected 'local' or 'proc'")
