"""Train the D3QL placement agent (paper Fig. 3) and dump the curves.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_agent [--episodes 300]
      PYTHONPATH=src python -m repro_torch.examples.train_agent \
          --scenario heavy-traffic --engine fused --num-envs 8

``--scenario`` resolves a named environment regime from the registry in
``repro_torch.sim.scenarios`` (paper-fig3 by default); ``--ues`` /
``--channels`` override that scenario's fields when given; ``--device``
places the agent (the card by default).
"""
import argparse
import os

import numpy as np

from repro_torch.core import LearnGDMController
from repro_torch.sim import EdgeSimulator
from repro_torch.sim.scenarios import get_scenario, scenario_names


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--episodes", type=int, default=300)
    ap.add_argument("--scenario", default="paper-fig3",
                    choices=scenario_names(),
                    help="named environment regime (repro_torch.sim.scenarios)")
    ap.add_argument("--ues", type=int, default=None,
                    help="override the scenario's num_ues")
    ap.add_argument("--channels", type=int, default=None,
                    help="override the scenario's num_channels")
    ap.add_argument("--num-envs", type=int, default=1,
                    help="stacked envs for the batched rollout engines "
                         "(1 = scalar reference loop)")
    ap.add_argument("--engine", default="",
                    choices=["", "scalar", "vectorized", "fused"],
                    help="rollout engine (default: scalar at --num-envs 1, "
                         "vectorized otherwise)")
    ap.add_argument("--out", default="results/train_agent_curve.csv")
    ap.add_argument("--device", default=None,
                    help="where the agent lives (default: the card)")
    args = ap.parse_args(argv)

    overrides = {}
    if args.ues is not None:
        overrides["num_ues"] = args.ues
    if args.channels is not None:
        overrides["num_channels"] = args.channels
    cfg = get_scenario(args.scenario, **overrides)
    engine = args.engine or ("scalar" if args.num_envs == 1 else "vectorized")

    ctrl = LearnGDMController(EdgeSimulator(cfg), variant="learn-gdm", seed=0,
                              device=args.device)
    # one epsilon decay per frame: the batched engines step E envs per frame
    ctrl.calibrate_epsilon(
        args.episodes, num_envs=1 if engine == "scalar" else args.num_envs,
        final=1e-2)

    log = max(args.episodes // 10, 1)
    if engine == "fused":
        hist = ctrl.train_fused(args.episodes, num_envs=args.num_envs,
                                log_every=max(log // args.num_envs, 1))
    elif engine == "vectorized":
        hist = ctrl.train_vectorized(args.episodes, num_envs=args.num_envs,
                                     log_every=max(log // args.num_envs, 1))
    else:
        hist = ctrl.train(args.episodes, log_every=log)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("episode,reward,mse_loss\n")
        for i, (r, l) in enumerate(zip(hist["reward"], hist["loss"])):
            f.write(f"{i},{r},{l}\n")
    w = max(args.episodes // 10, 1)
    print(f"reward: first {w} eps mean {np.mean(hist['reward'][:w]):.2f} -> "
          f"last {w} eps mean {np.mean(hist['reward'][-w:]):.2f}")
    ev = ctrl.evaluate(5)
    print(f"greedy eval (batched engine): reward {ev['reward']:.2f}, "
          f"delivered {ev['num_delivered']:.1f}")
    print(f"curves -> {args.out}")
    return {"history": hist, "eval": ev}


if __name__ == "__main__":
    main()
