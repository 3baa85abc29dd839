"""Quickstart of the port: the three layers of the framework in one script,
on the CUDA device unless asked for the CPU.

1. Colmena steering (the paper's Listing 1 policy) on toy tasks, through
   the port's copy of the fabric.
2. Train a reduced LM architecture for 20 steps.
3. Serve it with the batched KV-cache engine.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import ColmenaQueues, TaskServer
from repro_torch.core.thinker import BaseThinker, agent, result_processor


def colmena_demo():
    print("== 1. Colmena steering (paper Listing 1) ==")
    TOTAL, PAR = 10, 3
    queues = ColmenaQueues(["simulate"])
    server = TaskServer(queues, workers_per_topic=PAR)
    server.register(lambda x: x ** 2, name="simulate")

    class Thinker(BaseThinker):
        def __init__(self, q):
            super().__init__(q)
            self.results = []

        @agent
        def planner(self):
            for i in range(PAR):
                self.queues.send_task(float(i), method="simulate",
                                      topic="simulate")

        @result_processor(topic="simulate")
        def consumer(self, result):
            self.results.append(result.value)
            if len(self.results) >= TOTAL:
                self.done.set()
            else:
                # steer: next input = sqrt of the best seen so far
                best = max(self.results)
                self.queues.send_task(best ** 0.5, method="simulate",
                                      topic="simulate")

    t = Thinker(queues)
    with server:
        t.run(timeout=30)
    print(f"   completed {len(t.results)} steered tasks; "
          f"best={max(t.results):.2f}\n")


def train_demo(device):
    print("== 2. Train a reduced qwen3-8b for 20 steps ==")
    from repro_torch.launch.train import train
    _, losses = train("qwen3-8b", reduced=True, steps_total=20, batch=4,
                      seq=64, log_every=5, device=device)
    print(f"   loss {np.mean(losses[:3]):.3f} -> {np.mean(losses[-3:]):.3f}\n")


def serve_demo(device):
    print("== 3. Serve with the KV-cache engine ==")
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import engine_tokens_per_s
    from repro_torch.models import api
    from repro_torch.serving.engine import Engine
    cfg = get_config("internlm2-1.8b", reduced=True)
    params = api.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    eng = Engine(cfg, params, max_new=8)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 16), dtype=np.int32)
    eng.generate(prompts)                   # warmup: the first call
    warm_ns = time.perf_counter_ns()
    out = eng.generate(prompts)
    print(f"   generated {out.shape} ({engine_tokens_per_s(warm_ns):.0f} "
          "tok/s steady-state)\n")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    colmena_demo()
    train_demo(args.device)
    serve_demo(args.device)
    print("quickstart OK")
