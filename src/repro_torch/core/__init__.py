"""Dynamic GUS core: types, hashing, LSH buckets, IDF/filter tables, the
embedding generator, the pair scorer and the ``DynamicGUS`` engine.

Light submodules re-export eagerly; ``DynamicGUS`` and Grale load lazily
(``__getattr__``) to avoid the core -> ann -> core import cycle
(``ann.sparse`` uses ``core.hashing``). Importing this package touches no
device.
"""
from repro_torch.core.types import (FeatureSpec, SparseBatch, NeighborResult,
                                    MutationBatch, PAD_INDEX, PAD_ITEM,
                                    MUTATION_INSERT, MUTATION_UPDATE,
                                    MUTATION_DELETE)
from repro_torch.core.buckets import BucketConfig
from repro_torch.core.embedding import EmbeddingGenerator

_LAZY = {
    "DynamicGUS": ("repro_torch.core.gus", "DynamicGUS"),
    "GusConfig": ("repro_torch.core.gus", "GusConfig"),
    "GraphConfig": ("repro_torch.graph.store", "GraphConfig"),
    "DynamicGraphStore": ("repro_torch.graph.store", "DynamicGraphStore"),
    "GraleConfig": ("repro_torch.core.grale", "GraleConfig"),
    "grale_graph": ("repro_torch.core.grale", "grale_graph"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(name)
