"""The D3QL placement agent (paper §III): Q-network, replay memory and the
double/dueling update, in PyTorch (``repro.rl`` in the reference)."""
from repro_torch.rl.d3ql import (D3QLAgent, D3QLConfig,  # noqa: F401
                                 fused_act, greedy_act, masked_argmax)
from repro_torch.rl.networks import QNet, qnet_apply, qnet_init  # noqa: F401
from repro_torch.rl.replay import (DeviceReplay,  # noqa: F401
                                   DeviceReplayState, ReplayMemory)
