"""Synthetic corpora and mutation streams, numpy only, so that the port and
the reference can be fed byte-identical data."""
from repro_torch.data.synthetic import (SyntheticConfig, make_dataset,
                                        OGB_ARXIV_LIKE, OGB_PRODUCTS_LIKE)
from repro_torch.data.stream import MutationStream, StreamConfig
