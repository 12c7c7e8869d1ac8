"""The small world the port's serving-plane tests share with the
reference's (``tests/test_pipeline.py``'s size: arxiv-like, 300 points, 6
clusters, 150 bootstrapped, mutation batches of 16, ``GraphConfig(k=4,
capacity=512)``), with helpers that build a reference engine and a port
engine at one state: the scorer from numpy, the reference's hyperplanes,
tables and (scann) trained structures carried across with
``repro_torch.convert``."""
import dataclasses

import jax.numpy as jnp
import numpy as np

from repro.ann.scann import ScannConfig as JScannConfig
from repro.ann.sharded_index import ShardedConfig as JShardedConfig
from repro.core import BucketConfig as JBucketConfig
from repro.core import DynamicGUS as JDynamicGUS
from repro.core import GusConfig as JGusConfig
from repro.core.maintenance import MaintenanceConfig as JMaintenanceConfig
from repro.data.stream import MutationStream as JStream
from repro.data.stream import StreamConfig as JStreamConfig
from repro.data.synthetic import OGB_ARXIV_LIKE as J_ARXIV
from repro.graph.store import GraphConfig as JGraphConfig
from repro.multimodal import MultiModalConfig as JMultiModalConfig
from repro_torch import convert
from repro_torch.ann.scann import ScannConfig
from repro_torch.ann.sharded_index import ShardedConfig
from repro_torch.core.buckets import BucketConfig
from repro_torch.core.gus import DynamicGUS, GusConfig
from repro_torch.core.maintenance import MaintenanceConfig
from repro_torch.data.stream import MutationStream, StreamConfig
from repro_torch.data.synthetic import OGB_ARXIV_LIKE, make_dataset
from repro_torch.graph.store import GraphConfig
from repro_torch.multimodal import MultiModalConfig
from test_torch_gus import _reference_state, _scorer_arrays

DATA = dataclasses.replace(OGB_ARXIV_LIKE, n_points=300, n_clusters=6)
J_DATA = dataclasses.replace(J_ARXIV, n_points=300, n_clusters=6)
N_BOOT = 150
BUCKETS = dict(dense_tables=8, dense_bits=10, scalar_widths=(2.0,))
# test_pipeline.py's scann backend; the reference trains briefly, since
# the port takes its trained structures rather than training its own
SCANN = dict(d_proj=32, n_partitions=16, nprobe=4, reorder=64)
J_TRAIN = dict(kmeans_iters=3, pq_iters=2)
GRAPH = dict(k=4, capacity=512)
# tests/test_torch_multimodal.py's plane
MM = dict(sparse_k=6, d_sketch=32, idf_size=128, filter_percent=1.0,
          reload_every=2)


def corpus():
    """(ids, features) of the world (the same in both packages)."""
    ids, feats, _ = make_dataset(DATA)
    return ids, feats


def boot(feats, n=N_BOOT):
    return {k: v[:n] for k, v in feats.items()}


def streams(seed: int, **kw):
    """The same mutation stream for both packages (batches of 16)."""
    return (JStream(J_DATA, JStreamConfig(batch_size=16, seed=seed, **kw),
                    0.5),
            MutationStream(DATA, StreamConfig(batch_size=16, seed=seed, **kw),
                           0.5))


def port_stream(seed: int, **kw):
    return streams(seed, **kw)[1]


# tests/test_pipeline.py's sharded backend (one shard)
SHARDED = dict(n_shards=1, d_proj=32, n_partitions=8, nprobe_local=0,
               reorder=512, pq_m=4, kmeans_iters=4, pq_iters=2)


def configs(backend="brute", graph=False, bound=None, multimodal=False,
            scann_nn=5, idf_size=0, filter_percent=0.0, sharded=None):
    """(reference GusConfig, port GusConfig) of one configuration;
    ``bound`` sets ``GusConfig.maintenance`` (None leaves it unset);
    ``sharded`` is the ``ShardedConfig`` fields (default ``SHARDED``), its
    ``maintenance`` a dict of ``MaintenanceConfig`` fields."""
    sh = dict(SHARDED if sharded is None else sharded)
    maint = sh.pop("maintenance", None)
    kw = dict(scann_nn=scann_nn, backend=backend, idf_size=idf_size,
              filter_percent=filter_percent)
    if maint is not None:
        kw_j = dict(kw, sharded=JShardedConfig(
            **sh, maintenance=JMaintenanceConfig(**maint)))
        kw_t = dict(kw, sharded=ShardedConfig(
            **sh, maintenance=MaintenanceConfig(**maint)))
    else:
        kw_j = dict(kw, sharded=JShardedConfig(**sh))
        kw_t = dict(kw, sharded=ShardedConfig(**sh))
    jcfg = JGusConfig(
        scann=JScannConfig(**SCANN, **J_TRAIN),
        graph=JGraphConfig(**GRAPH) if graph else None,
        maintenance=(None if bound is None
                     else JMaintenanceConfig(staleness_bound=bound)),
        multimodal=JMultiModalConfig(**MM) if multimodal else None, **kw_j)
    tcfg = GusConfig(
        scann=ScannConfig(**SCANN),
        graph=GraphConfig(**GRAPH) if graph else None,
        maintenance=(None if bound is None
                     else MaintenanceConfig(staleness_bound=bound)),
        multimodal=MultiModalConfig(**MM) if multimodal else None, **kw_t)
    return jcfg, tcfg


def ref_engine(jcfg, ids, feats, bootstrap=True):
    """A reference engine, bootstrapped on the first 150 points."""
    scorer = _scorer_arrays()
    jg = JDynamicGUS(J_DATA.spec, JBucketConfig(**BUCKETS),
                     {k: jnp.asarray(v) for k, v in scorer.items()}, jcfg)
    if bootstrap:
        jg.bootstrap(ids[:N_BOOT], boot(feats))
    return jg


def port_raw(tcfg, jg=None, device="cpu"):
    """A constructed, unbootstrapped port engine (a restore target). With
    ``jg`` it embeds with the reference's hyperplanes, so its own bootstrap
    of a corpus gives the reference's embeddings."""
    tg = DynamicGUS(DATA.spec, BucketConfig(**BUCKETS),
                    convert.scorer_params(_scorer_arrays(), device), tcfg,
                    device=device)
    if jg is not None:
        tg.embedder.params = convert.bucket_params(
            {k: np.asarray(v) for k, v in jg.embedder.params.items()},
            device)
    return tg


def port_engine(tcfg, ids, feats, jg=None, device="cpu"):
    """A port engine bootstrapped on the first 150 points: at the
    reference engine ``jg``'s trained state (``convert.load_bootstrapped``)
    or, without one, by its own torch-seeded bootstrap."""
    tg = port_raw(tcfg, device=device)
    if jg is None:
        tg.bootstrap(ids[:N_BOOT], boot(feats))
    else:
        convert.load_bootstrapped(tg, _reference_state(jg), ids[:N_BOOT],
                                  boot(feats))
    return tg


SHARDED_ARRAYS = ("members_idx", "members_val", "codes", "row_ids", "valid",
                  "counts")


def index_arrays(gus) -> dict:
    """The index's device arrays, on the host."""
    if gus.cfg.backend == "sharded":
        return {n: gus.index.array(n) for n in SHARDED_ARRAYS}
    names = (("db_idx", "db_val", "valid") if gus.cfg.backend == "brute"
             else ("sp_idx", "sp_val", "members", "codes_list",
                   "valid_list"))
    return {n: getattr(gus.index, n).cpu().numpy() for n in names}


def index_map(gus) -> dict:
    """The index's host id map (scann: slots, sharded: landing rows)."""
    return (gus.index.row_of if gus.cfg.backend == "sharded"
            else gus.index.slot_of)


def assert_same_state(a, b, graph=True):
    """Two port engines hold the same state, bit for bit: store, index
    arrays and id maps, a probe of the index path, graph rows, CC."""
    assert set(a.store.ids().tolist()) == set(b.store.ids().tolist())
    assert index_map(a) == index_map(b)
    for name, arr in index_arrays(a).items():
        np.testing.assert_array_equal(arr, index_arrays(b)[name],
                                      err_msg=name)
    qids = a.store.ids()[:24]
    r1 = a._index_neighbors_of_ids(qids, 5)
    r2 = b._index_neighbors_of_ids(qids, 5)
    for f in ("ids", "weights", "distances"):
        np.testing.assert_array_equal(getattr(r1, f), getattr(r2, f))
    if graph and a.graph is not None:
        np.testing.assert_array_equal(a.graph.nbr_slots.cpu().numpy(),
                                      b.graph.nbr_slots.cpu().numpy())
        np.testing.assert_array_equal(a.graph.nbr_w.cpu().numpy(),
                                      b.graph.nbr_w.cpu().numpy())
        assert a.graph.slot_of == b.graph.slot_of
        assert a.graph.components() == b.graph.components()
