"""Training launcher (the synchronous subset of ``repro.launch.train``).

On the card (the default device):
  python -m repro_torch.launch.train --arch paper-100m --steps 20 \
      --filter trimmed_mean --attack sign_flip --f 2

On the CPU, at the smoke size:
  python -m repro_torch.launch.train --arch paper-100m --smoke \
      --device cpu --steps 5 --seq-len 32 --per-agent-batch 2
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-100m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config variant")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--n-agents", type=int, default=8)
    ap.add_argument("--f", type=int, default=1)
    ap.add_argument("--filter", default="trimmed_mean")
    ap.add_argument("--impl", default="auto",
                    choices=["auto", "kernel", "gather"])
    ap.add_argument("--attack", default="none")
    ap.add_argument("--attack-scale", type=float, default=None)
    ap.add_argument("--momentum-alpha", type=float, default=0.0)
    ap.add_argument("--regime", default="iid",
                    choices=["iid", "noniid", "parallel"])
    ap.add_argument("--optimizer", default="adamw", choices=["sgd", "adamw"])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--per-agent-batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.core.aggregators import make_spec
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import adamw, constant, diminishing, sgd
    from repro_torch.training import ByzantineConfig, train_loop

    cfg = get_config(args.arch + ("-smoke" if args.smoke else ""))
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                     n_agents=args.n_agents,
                     per_agent_batch=args.per_agent_batch,
                     regime=args.regime)
    opt = (adamw(constant(args.lr)) if args.optimizer == "adamw"
           else sgd(diminishing(args.lr), momentum=0.9))
    ah = {} if args.attack_scale is None else {"scale": args.attack_scale}
    spec = make_spec(args.filter, f=args.f, impl=args.impl, n=args.n_agents)
    bz = ByzantineConfig(n_agents=args.n_agents, f=args.f, aggregator=spec,
                         attack=args.attack, attack_hyper=ah,
                         momentum_alpha=args.momentum_alpha)
    _, history = train_loop(cfg, bz, opt, ds, steps=args.steps,
                            seed=args.seed, device=args.device)
    print(f"final loss {history[-1]['loss']:.4f}")
    return history


if __name__ == "__main__":
    main()
