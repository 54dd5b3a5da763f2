"""Datasets of the port (``sdss``: the paper's stripe likelihood;
``pipeline``: the synthetic token and masked-frame batches training
reads)."""
from repro_torch.data.pipeline import (DataConfig, SyntheticLM,  # noqa: F401
                                       SyntheticMasked)
