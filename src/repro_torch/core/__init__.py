"""The paper's contribution: LEARN-GDM joint multiple access + placement
(``repro.core`` in the reference)."""
from repro_torch.core.baselines import (GreedyController,  # noqa: F401
                                        opt_upper_bound)
from repro_torch.core.constraints import TraceRecorder, check_all  # noqa: F401
from repro_torch.core.learn_gdm import (EpisodeStats,  # noqa: F401
                                        LearnGDMController, summarize,
                                        variant_action_mask,
                                        variant_action_mask_vec)
from repro_torch.core.mac import (greedy_mac, random_access,  # noqa: F401
                                  vec_greedy_mac, vec_random_access)
from repro_torch.core.policy import (GreedyPoAPolicy,  # noqa: F401
                                     LearnedPolicy, Policy, RandomPolicy,
                                     evaluate_batched, evaluate_policy,
                                     rollout_round)
