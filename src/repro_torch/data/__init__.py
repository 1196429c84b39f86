from repro_torch.data.pipeline import (DataConfig,  # noqa: F401
                                      LatentDataset, TokenDataset, prefetch)
