"""Quickstart: the paper's pipeline in ~60 lines.

1. build the Table II edge environment (4x4 grid, mobile UEs, channels);
2. run the greedy MAC + D3QL placement controller (LEARN-GDM) untrained;
3. train it briefly and watch the objective improve;
4. compare against the GR baseline and the OPT upper bound.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

from repro_torch.core import (GreedyController, LearnGDMController,
                              opt_upper_bound)
from repro_torch.sim import EdgeSimulator, SimConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the agent lives (default: the card)")
    args = ap.parse_args(argv)

    cfg = SimConfig(num_ues=10, num_channels=2, horizon=40, seed=0)
    print(f"env: {cfg.num_bs} BSs (4x4 grid), {cfg.num_ues} UEs, "
          f"{cfg.num_channels} channels, B={cfg.max_blocks} blocks")

    env = EdgeSimulator(cfg)
    ctrl = LearnGDMController(env, variant="learn-gdm", seed=0,
                              device=args.device)

    before = ctrl.evaluate(3)
    print(f"untrained LEARN-GDM reward: {before['reward']:8.2f} "
          f"(delivered quality {before['delivered_quality']:.2f})")

    episodes = 80
    ctrl.agent.epsilon = 1.0
    ctrl.calibrate_epsilon(episodes, final=5e-2)
    print(f"training D3QL for {episodes} episodes ...")
    ctrl.train(episodes, log_every=20)

    after = ctrl.evaluate(3)
    print(f"trained LEARN-GDM reward:   {after['reward']:8.2f} "
          f"(delivered quality {after['delivered_quality']:.2f})")

    gr = GreedyController(EdgeSimulator(cfg)).evaluate(3)
    print(f"GR (all blocks at PoA):     {gr['reward']:8.2f}")

    bound = opt_upper_bound(env, seed=9000)
    print(f"OPT full-knowledge bound:   {bound['reward']:8.2f}")
    print("(expected ordering: OPT >= trained LEARN-GDM >= GR, "
          "trained >= untrained)")
    return {"untrained": before, "trained": after, "gr": gr, "opt": bound}


if __name__ == "__main__":
    main()
