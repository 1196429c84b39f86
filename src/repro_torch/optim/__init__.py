"""Optimizers and learning-rate schedules (``repro.optim`` in the
reference): AdamW and SGD as (init, update) pairs, global-norm clipping,
and the schedules, all over ``{name: tensor}`` parameter dicts."""
from repro_torch.optim.optimizers import (OptState, adamw,  # noqa: F401
                                          apply_updates,
                                          clip_by_global_norm, global_norm,
                                          sgd)
from repro_torch.optim.schedules import (constant, cosine_decay,  # noqa: F401
                                         exponential_decay, linear_warmup)
