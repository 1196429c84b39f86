from repro_torch.sim.env import (IDLE, PENDING, SimConfig,  # noqa: F401
                                 draw_static_world, grid_trans_cost)
from repro_torch.sim.mobility import RandomWaypoint  # noqa: F401
from repro_torch.sim.quality import synthetic_curves  # noqa: F401
from repro_torch.sim.scenarios import (RequestTrace, get_scenario,  # noqa: F401
                                       register_scenario, request_trace,
                                       scenario_names)
