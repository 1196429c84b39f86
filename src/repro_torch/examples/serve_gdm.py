"""End-to-end closed loop: train in the simulator, deploy on the serving
engine, serve real GDM denoising chains.

The paper's whole pipeline in one script:

  1. measure Ω(k) from the real (reduced) DiT services (SSIM-vs-final per
     block, Fig. 1 protocol);
  2. train the LEARN-GDM placement policy in the edge simulator AGAINST
     those measured curves;
  3. wrap the trained agent in the ServingPolicy decision seam and serve a
     scenario-derived request trace on the engine — real latents ship
     between nodes, one batched block call per (node, quantum);
  4. report latency / quality / objective next to the greedy baseline.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_gdm \
          --scenario paper-fig3 [--device cpu]
"""
import argparse
import time

from repro_torch.core.policy import GreedyPoAPolicy, LearnedPolicy
from repro_torch.experiments import serve_policy, train_variant
from repro_torch.serving.gdm_service import make_gdm_services
from repro_torch.sim.scenarios import get_scenario, scenario_names


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="paper-fig3",
                    help=f"one of {scenario_names()}")
    ap.add_argument("--variant", default="learn-gdm",
                    choices=["learn-gdm", "mp", "fp"])
    ap.add_argument("--train-eps", type=int, default=48)
    ap.add_argument("--frames", type=int, default=0,
                    help="serving quanta (default: the scenario horizon)")
    ap.add_argument("--engine", default=None,
                    help="training engine (scalar|vectorized|fused)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the DiT services and the agent run "
                         "(default: the card)")
    args = ap.parse_args(argv)

    cfg = get_scenario(args.scenario)
    frames = args.frames or cfg.horizon

    print(f"[1/3] measuring Omega(k) from {cfg.num_services} real DiT "
          f"services (B={cfg.max_blocks})")
    services, omega = make_gdm_services(
        cfg.num_services, args.seed, num_blocks=cfg.max_blocks,
        steps_per_block=1, device=args.device)
    for s in range(cfg.num_services):
        print(f"      service {s}: Omega = "
              + " ".join(f"{q:.3f}" for q in omega[s]))

    print(f"[2/3] training {args.variant} in the simulator on these curves "
          f"({args.train_eps} episodes, scenario {args.scenario!r})")
    t0 = time.time()
    ctrl = train_variant(cfg, args.variant, args.train_eps, seed=args.seed,
                         engine=args.engine, quality=omega,
                         device=args.device)
    print(f"      trained in {time.time() - t0:.1f}s "
          f"(epsilon -> {ctrl.agent.epsilon:.3f})")

    print(f"[3/3] serving {frames} quanta of the scenario trace on the "
          f"engine (real latents, batched per-node execution)")
    results = {}
    for name, pol in (("learned", LearnedPolicy(ctrl.agent, args.variant)),
                      ("greedy", GreedyPoAPolicy())):
        t0 = time.time()
        stats = serve_policy(cfg, pol, frames, services=services,
                             seed=args.seed)
        stats["wall_s"] = time.time() - t0
        results[name] = stats
        print(f"      {name:8s} completed={stats['completed']}"
              f"/{stats['submitted']} "
              f"quality={stats['mean_quality']:.3f} "
              f"latency={stats['mean_latency_frames']:.1f}f "
              f"(p95 {stats['p95_latency_frames']:.1f}f) "
              f"objective={stats['objective']:.2f} "
              f"wall={stats['wall_s']:.1f}s")

    calls = sum(s.batch_calls for s in services.values())
    print(f"\nbatched execution: {calls} block calls served "
          f"{sum(r['completed'] for r in results.values())} chains "
          "(one call per (node, service, quantum))")
    print("learned vs greedy objective: "
          f"{results['learned']['objective']:.2f} vs "
          f"{results['greedy']['objective']:.2f}")
    return results


if __name__ == "__main__":
    main()
