"""Optimizers, learning-rate schedules and gradient compression
(``repro.optim`` in the reference): AdamW and SGD as (init, update) pairs,
global-norm clipping, the schedules and error-feedback int8 compression,
all over ``{name: tensor}`` parameter dicts."""
from repro_torch.optim.compression import (EFState,  # noqa: F401
                                           compress_grads, dequantize_int8,
                                           init_error_feedback,
                                           quantize_int8)
from repro_torch.optim.optimizers import (OptState, adamw,  # noqa: F401
                                          apply_updates,
                                          clip_by_global_norm, global_norm,
                                          sgd)
from repro_torch.optim.schedules import (constant, cosine_decay,  # noqa: F401
                                         exponential_decay, linear_warmup)
