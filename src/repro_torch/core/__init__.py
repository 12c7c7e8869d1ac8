"""Dynamic GUS core: types, hashing, LSH buckets, IDF/filter tables, the
embedding generator, the pair scorer and the ``DynamicGUS`` engine."""
from repro_torch.core.types import (FeatureSpec, SparseBatch, NeighborResult,
                                    MutationBatch, PAD_INDEX, PAD_ITEM,
                                    MUTATION_INSERT, MUTATION_UPDATE,
                                    MUTATION_DELETE)
from repro_torch.core.buckets import BucketConfig
