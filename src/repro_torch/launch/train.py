"""Training launcher (counterpart of ``repro.launch.train``).

On the card (the default device):
  python -m repro_torch.launch.train --arch paper-100m --steps 20 \
      --filter trimmed_mean --attack sign_flip --f 2

On the CPU, at the smoke size:
  python -m repro_torch.launch.train --arch paper-100m --smoke \
      --device cpu --steps 5 --seq-len 32 --per-agent-batch 2

``--quorum k`` runs the asynchronous loop (the server steps as soon as k
gradients are in); ``--sample-policy`` samples clients into the roster
each round and makes the spec elastic (``--elastic-buckets`` buckets).
``--draco-r r`` aggregates with the repetition code (Draco, groups of r
agents computing the same shard), which forces ``--regime parallel``.
``--filter`` takes any registered rule that needs no inner spec.
``--record trace.jsonl`` attaches the flight recorder (render it with
``python -m repro_torch.launch.report trace.jsonl``), ``--perfetto`` also
exports its Chrome trace, ``--ckpt-dir`` saves checkpoints halfway and at
the end, ``--history-out`` writes the history as JSON.
"""
from __future__ import annotations

import argparse
import json


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
    ap.add_argument("--draco-r", type=int, default=0)
    # client sampling: the roster as a CHOSEN schedule (simulator
    # SamplingPolicy) — the spec goes elastic so the aggregation runs the
    # sampled roster's per-bucket plans
    ap.add_argument("--sample-policy", default="none",
                    choices=["none", "uniform", "staleness", "contribution"],
                    help="per-round client sampling into the roster")
    ap.add_argument("--sample-m", type=int, default=0,
                    help="clients sampled per round (default n_agents//2)")
    ap.add_argument("--sample-round", type=int, default=1,
                    help="versions per sampling round")
    ap.add_argument("--elastic-buckets", type=int, default=3,
                    help="elastic-n bucket count used with --sample-policy")
    ap.add_argument("--quorum", type=int, default=None,
                    help="async quorum (default: the full live roster)")
    ap.add_argument("--poison-labels", action="store_true")
    ap.add_argument("--regime", default="iid",
                    choices=["iid", "noniid", "parallel"])
    ap.add_argument("--optimizer", default="adamw", choices=["sgd", "adamw"])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--per-agent-batch", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--history-out", default=None)
    ap.add_argument("--record", default=None, metavar="TRACE_JSONL",
                    help="write a flight-recorder trace (repro_torch.obs) "
                    "here; render it with "
                    "`python -m repro_torch.launch.report`")
    ap.add_argument("--perfetto", default=None, metavar="TRACE_JSON",
                    help="with --record: also export a Chrome-trace/"
                    "Perfetto JSON of the run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.core.aggregators import elastic, make_spec
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import adamw, constant, diminishing, sgd
    from repro_torch.simulator import SamplingPolicy, SimConfig
    from repro_torch.training import ByzantineConfig, train_loop

    cfg = get_config(args.arch + ("-smoke" if args.smoke else ""))
    if args.draco_r and args.regime != "parallel":
        args.regime = "parallel"       # coding needs identical shards
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                     n_agents=args.n_agents,
                     per_agent_batch=args.per_agent_batch,
                     regime=args.regime)
    opt = (adamw(constant(args.lr)) if args.optimizer == "adamw"
           else sgd(diminishing(args.lr), momentum=0.9))
    ah = {} if args.attack_scale is None else {"scale": args.attack_scale}
    sim = None
    n_spec = args.n_agents
    if args.sample_policy != "none":
        m = args.sample_m if args.sample_m > 0 else max(args.n_agents // 2, 1)
        sim = SimConfig(
            faults=(SamplingPolicy(m=m, policy=args.sample_policy,
                                   round_len=args.sample_round),),
            quorum=args.quorum, seed=args.seed)
        n_spec = elastic(args.n_agents, buckets=args.elastic_buckets)
    elif args.quorum is not None:
        sim = SimConfig(quorum=args.quorum, seed=args.seed)
    spec = make_spec(args.filter, f=args.f, impl=args.impl, n=n_spec)
    bz = ByzantineConfig(n_agents=args.n_agents, f=args.f, aggregator=spec,
                         attack=args.attack, attack_hyper=ah,
                         momentum_alpha=args.momentum_alpha,
                         draco_r=args.draco_r)
    recorder = None
    if args.record:
        from repro_torch.obs import Recorder
        recorder = Recorder(args.record, meta={"cli": "launch.train",
                                               "arch": args.arch})
    _, history = train_loop(cfg, bz, opt, ds, steps=args.steps,
                            seed=args.seed, device=args.device,
                            ckpt_dir=args.ckpt_dir,
                            ckpt_every=max(args.steps // 2, 1),
                            poison_labels=args.poison_labels, sim=sim,
                            recorder=recorder)
    if recorder is not None:
        recorder.close()
        print(f"trace written to {args.record}")
        if args.perfetto:
            print(f"perfetto trace written to "
                  f"{recorder.dump_chrome_trace(args.perfetto)}")
    if args.history_out:
        with open(args.history_out, "w") as fh:
            json.dump(history, fh, indent=1)
    print(f"final loss {history[-1]['loss']:.4f}")
    return history


if __name__ == "__main__":
    main()
