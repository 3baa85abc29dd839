"""End-to-end driver of the port: the paper's electrolyte-design campaign
(§II-B/§IV) on PyTorch, on the CUDA device unless asked for the CPU.

ML-steered search for high-ionization-potential molecules: MPNN-ensemble
surrogate + synthetic QC oracle, orchestrated by the Colmena Thinker/Task
Server with UCB steering and periodic retraining. Compares the paper's
three policies and prints a Fig. 3-style event trace with --trace. Every
re-score of the molecule space runs the ``mpnn_mp`` kernel on the card.

    PYTHONPATH=src python examples/electrolyte_design_torch.py \\
        --molecules 800 --budget 60 [--policy all] [--trace] [--device cpu]
"""
import argparse

from repro_torch.apps.electrolyte import AppConfig, run_campaign


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--molecules", type=int, default=800)
    ap.add_argument("--budget", type=int, default=60)
    ap.add_argument("--initial-train", type=int, default=48)
    ap.add_argument("--n-retrain", type=int, default=12)
    ap.add_argument("--policy", default="all",
                    choices=["all", "random", "no-retrain", "update-n"])
    ap.add_argument("--trace", action="store_true",
                    help="print the campaign event trace (Fig. 3-style)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    policies = (["random", "no-retrain", "update-n"]
                if args.policy == "all" else [args.policy])
    outs = {}
    for policy in policies:
        outs[policy] = run_campaign(
            AppConfig(num_molecules=args.molecules, qc_budget=args.budget,
                      initial_train=args.initial_train,
                      n_retrain=args.n_retrain, policy=policy,
                      seed=args.seed),
            verbose=True, device=args.device)
        if args.trace:
            print(f"--- {policy} trace ---")
            for t, kind, payload in outs[policy]["trace"][:50]:
                print(f"  t={t:7.2f}s {kind:8s} {payload}")

    if len(outs) == 3:
        rnd = max(outs["random"]["success_rate"], 1e-4)
        print(f"\nsteered/random discovery advantage: "
              f"{outs['update-n']['success_rate'] / rnd:.0f}x "
              f"(paper: ~100x at scale)")


if __name__ == "__main__":
    main()
