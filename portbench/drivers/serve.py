"""The inference shard: ``serving/shard.py::ServeLoop`` in a thread over the
local transport, serving the port's ``Engine`` to a closed loop of callers.
Each caller is an agent with one request in flight: it sends a prompt with
``ColmenaQueues.send_inference`` and sends its next one when the result
arrives. The requests come from ``gen/prompts.py``.

Traffic parameters: ``callers``; ``prompt_len``, ``max_new``, ``pool`` (the
generator's); ``serve`` (the ``ServeSpec``: ``max_batch``,
``prompt_buckets``, ``max_batch_delay_ms``, ``max_new_cap``);
``check_requests``; ``drain_seconds`` (how long after the close the window's
last requests may take); ``trace_seconds``.

End to end: ``output_tok_s``, the output tokens of the requests completed
in the window over the window; ``infer_p95_ms``, the 95th percentile
(nearest rank) over every request sent in the window of the time from its
send to its result's arrival, a request that failed or never came counting
as the whole wait for it.

The callers send their first requests as the window opens, ``callers`` at
once, which are the generator's whole pool, so every seed starts from the
same work. After the close no caller sends again, and the requests in
flight are awaited for ``drain_seconds``; with 0 they are not due, and
neither judged nor counted.

``correct``: every request due is answered, successfully and with as many
tokens as it asked for; then, for a sample drawn from the seed
that holds the request with the most output tokens and the one with the
longest prompt, the float32 reference (``reference/lm.py``) runs over the
prompt as the shard served it (left-padded with id 0 to its bucket) and the
served tokens, and ``logit_gap`` is the widest gap by which a served token's
reference logit lies below the reference's best at its position.

In a traced run the engine is handed to ``ServeLoop`` inside ``Proxy``,
which times the calls into the engine from outside and starts and stops the
profiler between them.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
import weakref

import numpy as np
import torch

from portbench.gen.prompts import Requests
from portbench.reference import lm as ref

TOPIC = "infer"
PAD_ID = 0
KEY = 8


def _fan_in(path: tuple, shape: tuple) -> int | None:
    """The fan-in of a weight of the dense layout (None: a lookup table)."""
    name, parent = path[-1], path[-2] if len(path) > 1 else ""
    if name == "embed":
        return None
    if name == "unembed":
        return shape[0]
    if parent == "attn" and name == "wo":
        return shape[-3] * shape[-2]
    if name in ("wq", "wk", "wv"):
        return shape[-3]
    return shape[-2]


def draw_params(abstract: dict, gen: torch.Generator, device, path=()):
    """The parameter tree of ``abstract`` ({name: (shape, dtype)}), each leaf
    one draw on ``device`` in float32, cast to its dtype: a matrix a normal
    of std 1/sqrt(fan-in), the embedding table a standard normal, a norm's
    scale 1 + 0.1 N(0, 1)."""
    out = {}
    for k, v in abstract.items():
        if isinstance(v, dict):
            out[k] = draw_params(v, gen, device, path + (k,))
            continue
        shape, dtype = v
        t = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        if k == "scale":
            t.mul_(0.1).add_(1.0)
        else:
            fan = _fan_in(path + (k,), shape)
            if fan is not None:
                t.mul_(fan ** -0.5)
        out[k] = t.to(dtype)
        del t
    return out


def bucket_of(length: int, buckets) -> int:
    return min(b for b in buckets if b >= length)


def prompt_key(tokens) -> tuple:
    """The last ``KEY`` ids of a prompt as the shard left-pads it with id
    0: a request's key (every request's ids are drawn anew)."""
    return tuple(([PAD_ID] * KEY + list(tokens))[-KEY:])


class Proxy:
    """The engine as ``ServeLoop`` sees it in a traced run: each call is
    timed on the host and recorded, and the profiler starts or stops at
    its start, where the previous call's host copy has drained the card.

    A call's record is (kind, t0, t1, rows, length, reserve, real): its
    padded rows and length as the engine got them, and ``real`` the true
    length of each row that serves a request still short of its tokens (a
    prefill's prompt lengths; in decode the positions of the row's own
    tokens already cached). Padded rows (copies of row 0), left padding
    and rows that have finished are not in ``real``. ``sizes`` maps a
    request's ``prompt_key`` to its (prompt length, max_new)."""

    def __init__(self, engine, win, sizes: dict):
        self.engine, self.win, self.sizes = engine, win, sizes
        self.calls: list = []
        self._groups: dict = {}      # id(state) -> (weakref, group)

    def _group(self, state) -> dict | None:
        ref_group = self._groups.get(id(state))
        if ref_group is None or ref_group[0]() is not state:
            return None
        return ref_group[1]

    def _keep(self, state, group: dict) -> None:
        self._groups = {k: v for k, v in self._groups.items()
                        if v[0]() is not None}
        self._groups[id(state)] = (weakref.ref(state), group)

    def prefill_batch(self, tokens, *, reserve=None, frames=None):
        self.win.boundary()
        t0 = time.perf_counter()
        out = self.engine.prefill_batch(tokens, reserve=reserve,
                                        frames=frames)
        t1 = time.perf_counter()
        rows = [self.sizes.get(prompt_key(row)) for i, row in
                enumerate(tokens) if i == 0 or not np.array_equal(
                    row, tokens[0])]
        rows = [r for r in rows if r is not None]
        self.calls.append(("prefill", t0, t1, tokens.shape[0],
                           tokens.shape[1], reserve, [n for n, _ in rows]))
        self._keep(out[1], {"rows": rows, "steps": 0})
        return out

    def decode_batch(self, state):
        self.win.boundary()
        rows, pos, reserve = state.padded_b, state.pos, state.reserve
        t0 = time.perf_counter()
        out = self.engine.decode_batch(state)
        t1 = time.perf_counter()
        group = self._group(state) or {"rows": [], "steps": 0}
        group["steps"] += 1
        s = group["steps"]
        real = [n + s - 1 for n, max_new in group["rows"] if max_new > s]
        self.calls.append(("decode", t0, t1, rows, pos, reserve, real))
        return out

    def gather_rows(self, state, rows):
        out = self.engine.gather_rows(state, rows)
        group = self._group(state)
        if group is not None:
            self._keep(out, group)
        return out


class Bench:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.config, self.traffic = cell.config, cell.traffic
        self.serve = self.traffic["serve"]
        self.sent: dict = {}           # task id -> request record
        self.in_flight = 0
        self.attempted = self.failed = 0
        self.thread = None
        self.proxy = None
        self.sizes: dict = {}          # prompt_key -> (length, max_new)

    # -- the program ----------------------------------------------------------

    def setup(self, win) -> None:
        from repro_torch.configs.base import ModelConfig
        from repro_torch.models import api
        from repro_torch.serving.engine import Engine

        fields = {f.name for f in dataclasses.fields(ModelConfig)}
        self.cfg = ModelConfig(**{k: v for k, v in self.config.items()
                                  if k in fields})
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.params = draw_params(api.abstract_params(self.cfg), gen,
                                  self.device)
        self.engine = Engine(self.cfg, self.params,
                             max_new=self.serve["max_new_cap"])
        self._warm()
        self.requests = Requests(self.traffic, self.cfg.vocab_size, self.seed)
        self._start_shard(win)

    def _warm(self) -> None:
        """Every prefill shape the traffic can give (each prompt bucket at
        each batch bucket), one decode step each and a gather to a smaller
        batch: the builds, the libraries' handles and the allocator's
        blocks are ready before the window."""
        cap, mb = self.serve["max_new_cap"], self.serve["max_batch"]
        rows = [b for b in (1 << i for i in range(16)) if b <= mb]
        for bucket in self.serve["prompt_buckets"]:
            for b in rows:
                tokens = np.full((b, bucket), PAD_ID, np.int32)
                _, state = self.engine.prefill_batch(tokens,
                                                     reserve=bucket + cap)
                self.engine.decode_batch(state)
                if b > 1:
                    self.engine.decode_batch(
                        self.engine.gather_rows(state, range(b // 2)))
                del state
        self.engine.stats.update(prefill_calls=0, decode_steps=0,
                                 tokens_out=0)

    def _start_shard(self, win) -> None:
        from repro_torch.core.queues import ColmenaQueues
        from repro_torch.serving.shard import ServeLoop, ServeSpec

        spec = ServeSpec(topic=TOPIC, max_batch=self.serve["max_batch"],
                         prompt_buckets=tuple(self.serve["prompt_buckets"]),
                         max_batch_delay_ms=self.serve["max_batch_delay_ms"],
                         max_new_cap=self.serve["max_new_cap"])
        self.queues = ColmenaQueues([], backend="local", serve_spec=spec,
                                    trace=False)
        engine = self.engine
        if win.trace:
            engine = self.proxy = Proxy(self.engine, win, self.sizes)
        self.loop = ServeLoop(self.queues.transport, spec, engine=engine,
                              identity="infer@portbench")
        self.thread = threading.Thread(target=self.loop.run, daemon=True,
                                       name="portbench-shard")
        self.thread.start()

    def _send(self, caller: int) -> None:
        k = len(self.sent)
        ids, max_new = self.requests[k]
        self.sizes[prompt_key(ids)] = (len(ids), max_new)
        t = time.perf_counter()
        tid = self.queues.send_inference(ids, max_new=max_new)
        self.sent[tid] = {"caller": caller, "k": k, "t_send": t,
                          "prompt": ids, "max_new": max_new,
                          "t_done": None, "ok": False, "tokens": None}
        self.in_flight += 1

    def _pump(self, win, until: float, send_until: float) -> None:
        """Take results until ``until`` or until none is in flight; a
        caller whose result arrives before ``send_until`` sends its next
        request. Serves the profiler's requests from the shard's thread."""
        while self.in_flight:
            win.service()
            now = time.perf_counter()
            if now >= until:
                return
            for r in self.queues.get_results(
                    TOPIC, max_n=64, timeout=min(0.05, until - now)):
                t = time.perf_counter()
                rec = self.sent[r.task_id]
                rec.update(t_done=t, ok=bool(r.success), tokens=r.value)
                self.in_flight -= 1
                if t < send_until:
                    self._send(rec["caller"])


    def run(self, win) -> None:
        for c in range(self.traffic["callers"]):
            self._send(c)
        self._pump(win, until=win.deadline + self.traffic["drain_seconds"],
                   send_until=win.deadline)
        self._stop_shard(win)
        win.boundary()
        # with no wait after the close, the requests still in flight there
        # were not due and are not judged
        judged = [r for r in self.sent.values()
                  if r["t_done"] is not None or self.traffic["drain_seconds"]]
        self.attempted = len(judged)
        self.failed = sum(1 for r in judged
                          if not (r["ok"] and r["tokens"] is not None
                                  and len(r["tokens"]) == r["max_new"]))

    def _stop_shard(self, win=None) -> None:
        from repro_torch.serving.shard import send_shard_stop

        if self.thread is None:
            return
        send_shard_stop(self.queues.transport, TOPIC)
        deadline = time.perf_counter() + 60
        while self.thread.is_alive() and time.perf_counter() < deadline:
            if win is not None:
                win.service()
            self.thread.join(timeout=0.05)
        if self.thread.is_alive():
            raise RuntimeError("the shard's serve loop did not stop")
        self.thread = None

    def release(self) -> None:
        self.engine = self.loop = None
        if self.proxy is not None:
            self.proxy.engine = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def close(self) -> None:
        self._stop_shard()

    # -- what is reported -----------------------------------------------------

    def end_to_end(self, win) -> dict:
        tokens = sum(len(r["tokens"]) for r in self.sent.values()
                     if r["ok"] and r["t_done"] <= win.deadline)
        now = time.perf_counter()
        waits = sorted((r["t_done"] or now) - r["t_send"]
                       for r in self.sent.values())
        p95 = waits[max(0, math.ceil(0.95 * len(waits)) - 1)]
        return {"output_tok_s": tokens / win.seconds,
                "infer_p95_ms": 1e3 * p95}

    def context(self, win, trace) -> dict:
        calls = self.proxy.calls if self.proxy is not None else []
        return {"config": self.config, "trace": trace, "win": win,
                "calls": calls,
                "untraced": [c for c in calls if win.in_untraced_part(c[1])
                             and win.in_untraced_part(c[2])]}

    def sampled(self) -> list:
        """The requests the reference recomputes: the one with the most
        output tokens, the one with the longest prompt, and the rest drawn
        from the seed."""
        done = sorted((r for r in self.sent.values() if r["ok"]
                       and r["tokens"] is not None), key=lambda r: r["k"])
        if not done:
            return []
        pick = {max(done, key=lambda r: (r["max_new"], -r["k"]))["k"],
                max(done, key=lambda r: (len(r["prompt"]), -r["k"]))["k"]}
        order = np.random.default_rng([self.seed, 3]).permutation(len(done))
        for i in order:
            if len(pick) >= self.traffic["check_requests"]:
                break
            pick.add(done[i]["k"])
        return [r for r in done if r["k"] in pick]

    def served_sequence(self, rec) -> tuple[list, int]:
        """The tokens the program read for ``rec`` (its prompt left-padded
        to its bucket, then every served token but the last) and the
        position whose logits predicted the first served token."""
        bucket = bucket_of(len(rec["prompt"]), self.serve["prompt_buckets"])
        seq = [PAD_ID] * (bucket - len(rec["prompt"])) + list(rec["prompt"])
        return seq + list(rec["tokens"][:-1]), bucket - 1

    def gaps(self, rec, quant=None) -> np.ndarray:
        """Each served token's gap below the reference's best. With
        ``quant`` the gap under the reference of the token the reference
        in that precision puts first instead (the control)."""
        seq, start = self.served_sequence(rec)
        want = ref.logits(self.params, self.config, seq, start)
        best = want.max(dim=-1).values
        if quant is None:
            chosen = torch.as_tensor(rec["tokens"], device=want.device)
        else:
            chosen = ref.logits(self.params, self.config, seq, start,
                                quant=quant).argmax(dim=-1)
        return (best - want.gather(1, chosen.long()[:, None])[:, 0]
                ).double().cpu().numpy()

    def check(self) -> dict:
        worst = 0.0
        for rec in self.sampled():
            worst = max(worst, float(self.gaps(rec).max()))
        return {"logit_gap": (worst, self.cell.limits["logit_gap"])}

    def control(self) -> dict:
        """The control's reading: at each position of the same requests,
        the gap of the token the reference in float8 puts first."""
        worst = 0.0
        for rec in self.sampled():
            worst = max(worst, float(self.gaps(rec, quant="fp8").max()))
        return {"logit_gap": worst}
