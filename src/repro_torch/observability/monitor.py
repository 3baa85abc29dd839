"""CampaignMonitor: live fabric stats aggregation for the launcher.

Dials every federation member's broker with the idempotent
``stats_scrape`` op (each member answers for itself -- unknown ops fall
through the relay to the local broker, which is exactly the per-member
semantics a scrape wants) and optionally the Value Server's client-side
stats, and appends one merged snapshot line per tick to
``stats-monitor.jsonl`` in the observability directory.  The forked
roles' own sinks carry their cumulative metrics (tracer
``flush_metrics``); the monitor adds the *broker-side* view -- queue
depths, in-flight leases, expiry/claim-reject counters, live shm
segments -- which no consumer process can see.

Deliberately not imported by ``repro_torch.observability.__init__``: this
module imports the transport layer (FrameClient), and the instrumented
transport imports the observability package -- keeping the aggregator
out of the package root keeps that edge one-way.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Callable, Dict, Optional

from repro_torch.core.transport import frames
from repro_torch.utils.timing import now


def scrape_address(address) -> dict:
    """One member's ``stats_scrape`` reply (``{}`` on a dead broker --
    a scrape must never take the campaign down with it)."""
    try:
        client = frames.FrameClient(tuple(address))
        try:
            header, _ = client.request({"op": "stats_scrape"}, retry=True)
            return header.get("stats", {}) or {}
        finally:
            client.close()
    except (ConnectionError, OSError, RuntimeError):
        return {}


class CampaignMonitor:
    """Periodic scraper over the federation's broker addresses.

    ``addresses``: ``{host_name: (host, port)}``;  ``vs_stats``: an
    optional zero-arg callable returning Value-Server stats to fold into
    each snapshot (e.g. ``ShardedValueServer.client_stats``).
    """

    def __init__(self, addresses: Dict[str, tuple], obs_dir: str,
                 interval: float = 2.0,
                 vs_stats: Optional[Callable[[], dict]] = None):
        self.addresses = dict(addresses)
        self.obs_dir = obs_dir
        self.interval = interval
        self.vs_stats = vs_stats
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last: dict = {}

    # -- scraping ------------------------------------------------------

    def scrape(self) -> dict:
        snap: dict = {"t": now(), "brokers": {}}
        for name, addr in self.addresses.items():
            snap["brokers"][name] = scrape_address(addr)
        if self.vs_stats is not None:
            try:
                snap["value_server"] = self.vs_stats()
            except (ConnectionError, OSError, RuntimeError, KeyError):
                snap["value_server"] = {}
        self.last = snap
        return snap

    def _write(self, snap: dict) -> None:
        if not self.obs_dir:
            return
        path = os.path.join(self.obs_dir, "stats-monitor.jsonl")
        line = (json.dumps(snap, sort_keys=True, default=str)
                + "\n").encode()
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            os.write(fd, line)
        finally:
            os.close(fd)

    def tick(self) -> dict:
        snap = self.scrape()
        self._write(snap)
        return snap

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "CampaignMonitor":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="campaign-monitor")
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception:               # noqa: BLE001 -- telemetry
                pass                        # must never kill the fabric

    def stop(self, final_scrape: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if final_scrape:
            try:
                self.tick()
            except Exception:               # noqa: BLE001
                pass
