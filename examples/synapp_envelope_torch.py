"""SynApp (paper section IV-D1) on the port's fabric: measure Colmena's
overheads for a {T, D, I, O, N} configuration, by default on the
multi-process topology (a broker process, N process-pool workers, a sharded
Value Server and, with ``--score-candidates``, one inference shard that
ranks each submission's candidates).

    PYTHONPATH=src python examples/synapp_envelope_torch.py --T 100 \
        --D 0.01 --I 1048576 --N 8 [--backend local] [--score-candidates 3]

Prints the median lifecycle components, the per-task dispatch overhead
(worker time not spent executing: N x makespan less the summed task
runtimes, over T) and the result latency (the median components of a
result's way back, from the worker's serialization to the Thinker).
"""
import argparse

from repro_torch.apps.synapp import SynConfig, run_synapp


def envelope(res):
    """(per-task dispatch overhead s, result latency s) of a synapp run."""
    cfg = res["config"]
    busy = res["utilization"] * cfg["N"] * res["makespan"]
    per_task = (cfg["N"] * res["makespan"] - busy) / max(res["n_results"], 1)
    latency = sum(v for k, v in res["medians"].items() if "result" in k)
    return per_task, latency


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--T", type=int, default=100)
    ap.add_argument("--D", type=float, default=0.01)
    ap.add_argument("--I", type=int, default=1 << 20)
    ap.add_argument("--O", type=int, default=0)
    ap.add_argument("--N", type=int, default=8)
    ap.add_argument("--backend", choices=("local", "proc"), default="proc")
    ap.add_argument("--score-candidates", type=int, default=0)
    ap.add_argument("--no-value-server", action="store_true")
    args = ap.parse_args(argv)

    res = run_synapp(SynConfig(T=args.T, D=args.D, I=args.I, O=args.O,
                               N=args.N, backend=args.backend,
                               score_candidates=args.score_candidates,
                               use_value_server=not args.no_value_server))
    per_task, latency = envelope(res)
    print(f"completed {res['n_results']} tasks in {res['makespan']:.3f}s "
          f"({args.backend} backend, N={args.N})")
    print(f"utilization: {100 * res['utilization']:.1f}%")
    print("median lifecycle components (us):")
    for k, v in sorted(res["medians"].items()):
        print(f"  {k:28s} {v * 1e6:10.1f}")
    print(f"total overhead (median): "
          f"{res['total_overhead_median'] * 1e6:.1f} us/task")
    print(f"per-task dispatch overhead: {per_task * 1e6:.1f} us")
    print(f"result latency (median): {latency * 1e6:.1f} us")
    return res


if __name__ == "__main__":
    main()
