"""The maintained dynamic graph (port of ``repro/graph``): the product
Dynamic GUS is named for, a graph kept correct while the corpus mutates.

  store.py — ``DynamicGraphStore``: the symmetric top-k adjacency on the
             device, two-sided edge updates through a merge-and-retop-k on
             the ``topk_select`` kernel, tombstone purges, eviction
             mirroring, the repair queue, the fast neighborhood read,
             published ``GraphView`` versions, snapshot/restore.
  cc.py    — online connected components (hash-to-min over the dirty
             frontier) and the union-find oracle.

``core.gus.DynamicGUS`` drives maintenance from its mutation RPCs when
``GusConfig.graph`` is set.
"""
from repro_torch.graph.store import DynamicGraphStore, GraphConfig, GraphView
from repro_torch.graph.cc import (offline_components, propagate_flags,
                                  propagate_labels)
