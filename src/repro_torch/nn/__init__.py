from repro_torch.nn.attention import (Attention, KVCache,  # noqa: F401
                                      attention_apply, attention_decode,
                                      init_kv_cache, prefill_kv_cache)
from repro_torch.nn.linear import (Dense, Embedding, dense_apply,  # noqa: F401
                                   embedding_apply, embedding_attend)
from repro_torch.nn.mlp import (GeluMLP, SwiGLU, gelu_mlp_apply,  # noqa: F401
                                swiglu_apply)
from repro_torch.nn.moe import MoE, moe_apply  # noqa: F401
from repro_torch.nn.norm import (LayerNorm, RMSNorm,  # noqa: F401
                                 layernorm_apply, rmsnorm_apply)
from repro_torch.nn.rope import apply_rope, rope_frequencies  # noqa: F401
from repro_torch.nn.ssm import (Mamba, MambaState, mamba_apply,  # noqa: F401
                                mamba_decode, mamba_init_state)
