"""xlstm-1.3b — 48L d2048 4H d_ff=0 vocab 50304, sLSTM + mLSTM blocks (1:7).

[arXiv:2405.04517]  Same widths as ``repro.configs.xlstm_1_3b.CONFIG``:
d_ff=0, since the xLSTM blocks carry their own up and down projections;
the mLSTM projects to d_in = proj_factor x d = 4096 (heads of 1024), the
sLSTM works at d (heads of 512).  As the reference builds it, about 2.02 B
parameters (8.1 GB in float32), so the whole model fits one 80 GB H100.
Its recurrent state makes it sub-quadratic: it runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50_304,
    xlstm=XLSTMConfig(slstm_every=8, proj_factor=2.0, conv_kernel=4),
    subquadratic=True,
)
