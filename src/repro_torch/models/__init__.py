from repro_torch.models.gdm import (LATENT_CHANNELS, DiT,  # noqa: F401
                                    DiTLayer, ddim_step, gdm_denoise,
                                    gdm_loss,
                                    init_gdm, make_schedule,
                                    quality_per_block, run_block,
                                    run_block_batched, sample_chain,
                                    ssim_proxy)
from repro_torch.models.lm import (LM, init_decode_state,  # noqa: F401
                                   init_lm, layer_pattern, lm_decode_step,
                                   lm_forward, lm_loss, lm_prefill)
