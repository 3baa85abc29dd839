"""Abstract campaign-steering formulation (paper §II-A).

Entities e in E with properties p in P; assays a in A estimate properties
(static assays = fixed simulation codes, learned assays = retrainable ML
models); the record D holds (entity, assay, property, value) observations;
a scoring function S maps an entity's data to a score (or None when the
data are inadequate); V(D) = best score in the record; C(D) = accumulated
cost.  The decision problem at each step: generate entities, run a task
a(e), or retrain a learned assay.

The CampaignRecord is JSON-serializable -- campaign state participates in
checkpoint/restart alongside model/optimizer state (fault tolerance).
"""
from __future__ import annotations

import json
import os
import threading
from dataclasses import asdict, dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class Observation:
    entity: str                 # entity id
    assay: str                  # assay id
    prop: str                   # property name
    value: float
    cost: float = 0.0
    time: float = 0.0           # campaign wall-clock when recorded


@dataclass
class AssaySpec:
    name: str
    prop: str                   # property it estimates
    cost: float                 # nominal cost per application
    learned: bool = False       # retrainable?


class CampaignRecord:
    """Thread-safe record D with V(D) and C(D)."""

    def __init__(self, scoring_fn: Callable[[Dict[str, float]], Optional[float]]):
        self._lock = threading.Lock()
        self._obs: List[Observation] = []
        self._by_entity: Dict[str, Dict[str, float]] = {}
        self._scoring = scoring_fn

    def add(self, obs: Observation) -> None:
        with self._lock:
            self._obs.append(obs)
            self._by_entity.setdefault(obs.entity, {})[obs.prop] = obs.value

    def observations(self) -> List[Observation]:
        with self._lock:
            return list(self._obs)

    def entity_data(self, entity: str) -> Dict[str, float]:
        with self._lock:
            return dict(self._by_entity.get(entity, {}))

    def score(self, entity: str) -> Optional[float]:
        return self._scoring(self.entity_data(entity))

    def value(self) -> Optional[float]:
        """V(D): score of the single best-scoring entity."""
        with self._lock:
            entities = list(self._by_entity)
        scores = [s for s in (self.score(e) for e in entities)
                  if s is not None]
        return max(scores) if scores else None

    def cost(self) -> float:
        """C(D): total cost incurred."""
        with self._lock:
            return sum(o.cost for o in self._obs)

    def count(self, assay: Optional[str] = None) -> int:
        with self._lock:
            if assay is None:
                return len(self._obs)
            return sum(1 for o in self._obs if o.assay == assay)

    # -- checkpoint/restart ----------------------------------------------------

    def state(self) -> List[dict]:
        """Picklable/JSONable image of the record (for embedding in a
        campaign checkpoint alongside the queue snapshot)."""
        with self._lock:
            return [asdict(o) for o in self._obs]

    def load_state(self, data: List[dict]) -> int:
        """Atomically replace the record with ``data``.  Both structures
        are rebuilt off-lock and swapped under one lock hold, so a
        concurrent ``add`` observes either the old record or the fully
        restored one -- never a half-restored interleaving."""
        obs = [Observation(**d) for d in data]
        by_entity: Dict[str, Dict[str, float]] = {}
        for o in obs:
            by_entity.setdefault(o.entity, {})[o.prop] = o.value
        with self._lock:
            self._obs = obs
            self._by_entity = by_entity
        return len(obs)

    def save(self, path: str) -> None:
        data = self.state()
        tmp = path + ".tmp"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, path)

    def restore(self, path: str) -> int:
        with open(path) as f:
            data = json.load(f)
        return self.load_state(data)


# -- campaign-level checkpointing ------------------------------------------
#
# A campaign's durable state is two things: the record D (what has been
# observed) and the queue fabric (what is still in flight).  Checkpointing
# them together through ``ColmenaQueues.checkpoint`` gives a single file a
# ``kill -9``'d campaign resumes from without resubmitting completed work:
# queued tasks re-dispatch, leased (in-flight) tasks expire and redeliver,
# completed-but-unconsumed results deliver from the restored result
# queues, and the restored claim window swallows re-executions of work
# that already published a result.  When a Value Server is attached, its
# contents (both storage tiers, deduplicated across replicas) are bundled
# too, so proxied payloads survive the incarnation and restored task /
# result proxies resolve -- campaigns no longer trade the Value Server
# away to be checkpointable.


def checkpoint_campaign(path: str, queues, record: CampaignRecord,
                        extra=None) -> str:
    """Write record + queue state (+ Value Server contents, when one is
    attached) to ``path`` (atomic tmp+rename via
    ``ColmenaQueues.checkpoint``).  Cluster deployments checkpoint the
    same way: the queues' transport snapshot is then a *federation
    bundle* (every member broker's consistent cut) and the value-server
    snapshot spans the whole shard ring, so one file still resumes the
    whole cluster."""
    payload = {"record": record.state(), "extra": extra}
    return queues.checkpoint(path, extra=payload)


def resume_campaign(path: str, queues, record: CampaignRecord):
    """Restore ``path`` into a fresh fabric + record; returns the caller's
    ``extra``.  Call before task servers / Thinker agents start.

    ``path`` may also be a broker-side auto-snapshot (``snapshot_every``):
    those capture queue state only -- the record is left untouched (the
    application persists it separately, e.g. ``record.save``) and the
    returned ``extra`` is None."""
    payload = queues.resume(path)
    if payload is None:
        return None
    record.load_state(payload["record"])
    return payload["extra"]
