"""Fleet-scale serving demo: C cells, nonstationary traffic, one clock.

The production-shaped pipeline on top of the single-cell closed loop
(``repro_torch.examples.serve_gdm``):

  1. measure Ω(k) from the real (reduced) DiT services and train the
     LEARN-GDM placement policy in the simulator against those curves;
  2. build a C-cell cluster for the scenario (every cell shares the same
     Table II world AND the same service instances — the cluster stacks all
     cells' block executions into ONE call per service per quantum);
  3. derive a nonstationary fleet workload (diurnal / flash-crowd / mmpp /
     heavy-tail) with cross-cell UE handover candidates;
  4. serve it — optionally under an injected fault schedule
     (``--fault-schedule node-churn`` etc.) with failure recovery
     (``--recovery-mode failover --deadline 16``) — then report fleet
     latency/quality/objective, the handover ledger, the resilience
     counters, and the per-quantum telemetry summary (optionally dumped as
     schema-validated JSON).

Run:
  PYTHONPATH=src python -m repro_torch.examples.serve_fleet \\
      --scenario paper-fig3 --cells 4 --workload diurnal \\
      --handover-rate 0.05 --fault-schedule node-churn \\
      --recovery-mode failover+degrade --deadline 16 \\
      --telemetry-out fleet_telemetry.json [--device cpu]
"""
import argparse
import json
import time

from repro_torch.core.policy import GreedyPoAPolicy, LearnedPolicy
from repro_torch.experiments import train_variant
from repro_torch.serving import RecoveryConfig, TelemetryLog, TransferLedger
from repro_torch.serving.cluster import cluster_from_scenario, serve_fleet
from repro_torch.serving.gdm_service import make_gdm_services
from repro_torch.sim.faults import fault_names, fault_trace
from repro_torch.sim.scenarios import get_scenario, scenario_names
from repro_torch.sim.workloads import fleet_trace, workload_names


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="paper-fig3",
                    help=f"one of {scenario_names()}")
    ap.add_argument("--workload", default="diurnal",
                    help=f"one of {workload_names()}")
    ap.add_argument("--cells", type=int, default=4)
    ap.add_argument("--frames", type=int, default=0,
                    help="serving quanta (default: the scenario horizon)")
    ap.add_argument("--train-eps", type=int, default=48)
    ap.add_argument("--handover-rate", type=float, default=0.02)
    ap.add_argument("--policy", default="learned",
                    choices=["learned", "greedy"])
    ap.add_argument("--engine", default=None,
                    help="training engine (scalar|vectorized|fused)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--telemetry-out", default="",
                    help="write the schema-validated telemetry JSON here")
    ap.add_argument("--fault-schedule", default="none",
                    help=f"one of {fault_names()}")
    ap.add_argument("--recovery-mode", default="failover",
                    choices=["drop", "failover", "failover+degrade"],
                    help="what happens to in-flight requests on dead nodes")
    ap.add_argument("--deadline", type=int, default=0,
                    help="per-request deadline in quanta (0 = none)")
    ap.add_argument("--scheduling", default="quantum",
                    choices=["quantum", "continuous"],
                    help="lockstep reference vs iteration-level scheduler")
    ap.add_argument("--skew", type=float, default=0.0,
                    help="per-cell quantum skew in [0, 1) (continuous only)")
    ap.add_argument("--backpressure-depth", type=float, default=0.0,
                    help="admission throttle depth factor (0 = off)")
    ap.add_argument("--trace-out", default="",
                    help="capture a request-level trace and write the "
                         "schema-validated trace JSON here")
    ap.add_argument("--trace-perfetto", default="",
                    help="write the Chrome trace-event JSON here "
                         "(open in https://ui.perfetto.dev)")
    ap.add_argument("--device", default=None,
                    help="where the DiT services and the agent run "
                         "(default: the card)")
    args = ap.parse_args(argv)

    cfg = get_scenario(args.scenario)
    frames = args.frames or cfg.horizon

    print(f"[1/3] measuring Omega(k) from {cfg.num_services} DiT services "
          f"and training learn-gdm ({args.train_eps} episodes)")
    services, omega = make_gdm_services(
        cfg.num_services, args.seed, num_blocks=cfg.max_blocks,
        steps_per_block=1, device=args.device)
    if args.policy == "learned":
        ctrl = train_variant(cfg, "learn-gdm", args.train_eps,
                             seed=args.seed, engine=args.engine,
                             quality=omega, device=args.device)
        factory = lambda c: LearnedPolicy(ctrl.agent, "learn-gdm")  # noqa: E731
    else:
        factory = lambda c: GreedyPoAPolicy()                       # noqa: E731

    print(f"[2/3] building a {args.cells}-cell fleet for "
          f"{args.scenario!r} and a {args.workload!r} workload "
          f"({frames} quanta, handover rate {args.handover_rate})")
    telemetry = TelemetryLog()
    ledger = TransferLedger()
    recovery = None
    faults = None
    if args.fault_schedule != "none":
        recovery = RecoveryConfig(
            mode="drop" if args.recovery_mode == "drop" else "failover",
            deadline_frames=args.deadline,
            degrade=(args.recovery_mode == "failover+degrade"))
        faults = fault_trace(cfg, frames, args.cells, args.fault_schedule,
                             seed=args.seed)
        print(f"  injecting {args.fault_schedule!r} faults "
              f"(recovery {args.recovery_mode!r}, deadline "
              f"{args.deadline or 'none'})")
    sched = None
    engine_cfg = None
    if args.scheduling == "continuous":
        from repro_torch.serving import EngineConfig, SchedulerConfig
        sched = SchedulerConfig(skew=args.skew,
                                backpressure_depth=args.backpressure_depth,
                                sub_quantum_arrivals=True)
        engine_cfg = EngineConfig(
            max_blocks=cfg.max_blocks, admission_slots=cfg.num_channels,
            alpha=cfg.alpha, beta=cfg.beta, early_exit=True, seed=cfg.seed,
            scheduling="continuous")
        print(f"  continuous batching on (skew {args.skew}, "
              f"backpressure depth {args.backpressure_depth or 'off'})")
    tracing = bool(args.trace_out or args.trace_perfetto)
    if tracing:
        print("  request-level tracing on (pure observation; the run is "
              "pinned frame-for-frame to tracing-off)")
    cluster = cluster_from_scenario(
        cfg, args.cells, services, policy_factory=factory,
        engine_cfg=engine_cfg, telemetry=telemetry, ledger=ledger,
        recovery=recovery, sched=sched, tracing=tracing)
    fleet = fleet_trace(cfg, frames, args.cells, workload=args.workload,
                        seed=args.seed, handover_rate=args.handover_rate)

    print("[3/3] serving the fleet (stacked execution: one block call per "
          "service per quantum, fleet-wide)")
    t0 = time.time()
    stats = serve_fleet(cluster, fleet, services, seed=args.seed,
                        faults=faults)
    wall = time.time() - t0

    print(f"\nfleet: {stats['completed']}/{stats['submitted']} completed "
          f"({stats['satisfied']} satisfied) in {wall:.1f}s "
          f"({stats['completed'] / max(wall, 1e-9):.1f} req/s)")
    print(f"  latency {stats['mean_latency_frames']:.1f}f "
          f"(p95 {stats['p95_latency_frames']:.1f}f)  "
          f"quality {stats['mean_quality']:.3f}  "
          f"objective {stats['objective']:.2f}")
    print(f"  handovers {stats['handovers']} "
          f"(cost {stats['handover_cost']:.2f})")
    if faults is not None:
        fo = ledger.totals()["failover"]
        print(f"  resilience: goodput {stats['goodput']} "
              f"drops {stats['drops']} retries {stats['retries']} "
              f"deadline misses {stats['deadline_misses']} "
              f"failovers {stats['failovers']} "
              f"({fo['nbytes']} failover bytes, cost {fo['cost']:.2f})")
    for c, cell in enumerate(stats["per_cell"]):
        print(f"  cell {c}: {cell['completed']} completed, "
              f"lat {cell['mean_latency_frames']:.1f}f, "
              f"obj {cell['objective']:.2f}")
    tsum = telemetry.summary()
    print(f"telemetry: {tsum['quanta']} quanta, "
          f"mean queue {tsum['mean_queue_depth']:.2f}, "
          f"dropped {tsum['dropped']}, "
          f"node util {tsum['mean_node_utilization']:.3f}")
    legs = tsum["legs"]
    print("  legs: " + "  ".join(f"{k}={v:.2f}" for k, v in legs.items()))
    calls = sum(s.batch_calls for s in services.values())
    print(f"stacked execution: {calls} block calls served the "
          f"whole {args.cells}-cell fleet")
    if args.telemetry_out:
        with open(args.telemetry_out, "w") as f:
            json.dump(telemetry.to_json(), f, indent=2)
        print(f"telemetry written to {args.telemetry_out}")
    if tracing:
        from repro_torch.serving.tracing import validate_trace
        cp = stats.get("critical_path", {})
        if cp:
            frac = cp["fractions"]
            print(f"critical path ({cp['requests']} requests, "
                  f"{cp['latency_frames']} request-frames): "
                  + "  ".join(f"{k}={frac[k]:.0%}" for k in frac)
                  + f"  -> dominant leg: {cp['dominant']}")
        doc = cluster.tracer.to_json()
        validate_trace(doc)
        if args.trace_out:
            with open(args.trace_out, "w") as f:
                json.dump(doc, f, indent=2)
            print(f"trace written to {args.trace_out}")
        if args.trace_perfetto:
            with open(args.trace_perfetto, "w") as f:
                json.dump(cluster.tracer.to_chrome_trace(), f)
            print(f"Perfetto/Chrome trace written to {args.trace_perfetto} "
                  f"(open in https://ui.perfetto.dev)")
    return stats


if __name__ == "__main__":
    main()
