from repro_torch.data.pipeline import DataConfig, TokenDataset  # noqa: F401
