"""Sharded token data pipeline."""
from repro_torch.data.pipeline import TokenDataset, TokenPipeline  # noqa: F401
