from repro_torch.sim.env import (IDLE, PENDING, EdgeSimulator,  # noqa: F401
                                 SimConfig, draw_static_world,
                                 grid_trans_cost)
from repro_torch.sim.faults import (FaultTrace,  # noqa: F401
                                    fault_descriptions, fault_names,
                                    fault_trace, register_fault)
from repro_torch.sim.mobility import (RandomWaypoint,  # noqa: F401
                                      VecRandomWaypoint)
from repro_torch.sim.quality import synthetic_curves  # noqa: F401
from repro_torch.sim.scenarios import (RequestTrace, get_scenario,  # noqa: F401
                                       register_scenario, request_trace,
                                       scenario_names)
from repro_torch.sim.vec_env import VecEdgeSimulator  # noqa: F401
from repro_torch.sim.workloads import (FleetTrace,  # noqa: F401
                                       arrival_envelope, fleet_trace,
                                       get_workload, register_workload,
                                       workload_descriptions, workload_names,
                                       workload_trace)
