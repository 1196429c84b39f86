from repro_torch.models.gdm import (LATENT_CHANNELS, DiT,  # noqa: F401
                                    DiTLayer, ddim_step, gdm_denoise,
                                    init_gdm, make_schedule,
                                    quality_per_block, run_block,
                                    run_block_batched, sample_chain,
                                    ssim_proxy)
