"""BaseThinker: multi-agent decision processes (paper §III-B1, Listing 1).

A Thinker subclass defines its policy as decorated methods:

    class MyThinker(BaseThinker):
        @agent
        def planner(self):
            ...                        # runs as a thread after .run()

        @result_processor(topic="simulate")
        def consumer(self, result):
            ...                        # called for every completed result

        @event_responder(event="model_updated")
        def rescore(self):
            ...                        # runs each time the event is set

``run()`` launches every agent as a thread and joins them when ``done`` is
set.  Agents communicate with the Task Server via ``self.queues`` and with
each other through shared state + ``self.events`` (threading primitives,
exactly as in the paper).

All agent threads are event-driven: result processors park inside the
queue's Condition until a result (or shutdown) arrives, and event
responders wait on a shared condition hub that both their event and
``done`` notify -- setting ``done`` wakes every thread immediately instead
of waiting out a poll interval.
"""
from __future__ import annotations

import threading
from collections import defaultdict
from typing import Optional

from repro_torch.core.queues import ColmenaQueues
from repro_torch.core.resources import ResourceTracker


def agent(fn):
    fn._colmena_agent = {"kind": "agent"}
    return fn


def result_processor(topic: str = "default"):
    def deco(fn):
        fn._colmena_agent = {"kind": "result_processor", "topic": topic}
        return fn
    return deco


def event_responder(event: str):
    def deco(fn):
        fn._colmena_agent = {"kind": "event_responder", "event": event}
        return fn
    return deco


class HubEvent(threading.Event):
    """Event that notifies a shared Condition (and optional wakers) on set,
    so one thread can wait for *any* of several events without polling."""

    def __init__(self, cond: threading.Condition, wakers=()):
        super().__init__()
        self._cond = cond
        self._wakers = list(wakers)

    def set(self) -> None:
        super().set()
        with self._cond:
            self._cond.notify_all()
        for fn in self._wakers:
            fn()


class BaseThinker:
    def __init__(self, queues: ColmenaQueues,
                 resources: Optional[ResourceTracker] = None):
        self.queues = queues
        self.resources = resources
        self._hub = threading.Condition()
        # done wakes every parked agent: hub waiters AND queue consumers
        self.done = HubEvent(self._hub, wakers=[queues.wake_all])
        self.events: dict = defaultdict(lambda: HubEvent(self._hub))
        self._threads: list = []
        self.logger_lines: list = []

    # -- helpers ---------------------------------------------------------------

    def log(self, text: str) -> None:
        self.logger_lines.append(text)

    def set_event(self, name: str) -> None:
        self.events[name].set()

    # -- execution ---------------------------------------------------------------

    def _agent_methods(self):
        for name in dir(self):
            fn = getattr(self, name)
            meta = getattr(fn, "_colmena_agent", None)
            if meta is not None:
                yield fn, meta

    def run(self, timeout: Optional[float] = None) -> None:
        for fn, meta in self._agent_methods():
            if meta["kind"] == "agent":
                target = self._wrap_agent(fn)
            elif meta["kind"] == "result_processor":
                target = self._wrap_processor(fn, meta["topic"])
            else:
                target = self._wrap_responder(fn, meta["event"])
            th = threading.Thread(target=target, daemon=True,
                                  name=f"thinker-{fn.__name__}")
            th.start()
            self._threads.append(th)
        if (type(self).process_intermediate
                is not BaseThinker.process_intermediate):
            # the subclass consumes the stream lane: one drain thread per
            # worker topic (mirrors result processors -- parked in the
            # stream queue's Condition, woken by done via wake_all)
            for topic in self.queues.topics():
                th = threading.Thread(
                    target=self._wrap_stream(topic), daemon=True,
                    name=f"thinker-stream-{topic}")
                th.start()
                self._threads.append(th)
        self.done.wait(timeout)
        self.done.set()                 # timeout also terminates processors
        for th in self._threads:
            th.join(timeout=5)

    def _wrap_agent(self, fn):
        def run_agent():
            try:
                fn()
            except Exception as e:                     # noqa: BLE001
                self.log(f"agent {fn.__name__} crashed: {e!r}")
                self.done.set()
        return run_agent

    def _wrap_processor(self, fn, topic):
        def run_processor():
            while not self.done.is_set():
                # blocks until results arrive; done.set() wakes it.  The
                # batched drain hands one wakeup several completed results
                # when the processor thread is the bottleneck (fig5): the
                # per-result queue handshake is amortized across the batch.
                # Once done is set, the rest of the batch is discarded --
                # the same fate results still sitting in the queue have
                # always had (a Thinker that sets done at a threshold,
                # e.g. Listing 1, processes exactly its target count).
                results = self.queues.get_results(topic, max_n=32,
                                                  cancel=self.done)
                for result in results:
                    if self.done.is_set():
                        break
                    try:
                        fn(result)
                    except Exception as e:             # noqa: BLE001
                        self.log(f"processor {fn.__name__} crashed: {e!r}")
                        self.done.set()
                if results and not self.done.is_set():
                    try:
                        self.after_result_batch(topic)
                    except Exception as e:             # noqa: BLE001
                        self.log(f"after_result_batch crashed: {e!r}")
                        self.done.set()
        return run_processor

    def _wrap_stream(self, topic):
        def run_stream():
            while not self.done.is_set():
                obs_batch = self.queues.get_intermediates(topic, max_n=32,
                                                          cancel=self.done)
                for ob in obs_batch:
                    if self.done.is_set():
                        break
                    try:
                        self.process_intermediate(ob)
                    except Exception as e:             # noqa: BLE001
                        self.log(f"process_intermediate crashed: {e!r}")
                        self.done.set()
        return run_stream

    def process_intermediate(self, observation) -> None:
        """Streaming-steering hook: called with every
        ``message.Intermediate`` a worker publishes mid-task via
        ``streaming.report_intermediate``.  Override it to rank partial
        results and ``self.queues.cancel(observation.task_id, topic)``
        losers early -- the freed capacity re-steers immediately.  The
        default is a no-op and, when not overridden, no stream drain
        threads are started at all (zero cost for non-streaming
        Thinkers)."""

    def after_result_batch(self, topic: str) -> None:
        """Hook called after a drained result batch is fully processed.
        This is the safe place to take a fabric checkpoint
        (``queues.checkpoint``): every result of the batch -- whose
        delivery lease was committed when the batch was decoded -- has
        been counted by the processor, so the application progress
        written into the checkpoint agrees with the captured queues.  A
        checkpoint taken *mid*-batch would record decoded-but-unprocessed
        results nowhere (acked out of the broker, absent from the
        progress counters) and lose them across a resume."""

    def _wrap_responder(self, fn, event):
        def run_responder():
            ev = self.events[event]
            while True:
                with self._hub:
                    while not ev.is_set() and not self.done.is_set():
                        self._hub.wait()
                    if self.done.is_set():
                        return
                    ev.clear()
                try:
                    fn()
                except Exception as e:                 # noqa: BLE001
                    self.log(f"responder {fn.__name__} crashed: {e!r}")
                    self.done.set()
        return run_responder
