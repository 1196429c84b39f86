from repro_torch.nn.attention import Attention, attention_apply  # noqa: F401
from repro_torch.nn.linear import (Dense, Embedding, dense_apply,  # noqa: F401
                                   embedding_apply)
from repro_torch.nn.mlp import GeluMLP, gelu_mlp_apply  # noqa: F401
from repro_torch.nn.norm import LayerNorm, layernorm_apply  # noqa: F401
