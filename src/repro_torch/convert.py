"""Carry the reference package's trained state into the port.

Everything the reference draws from ``jax.random`` (bucket hyperplanes,
k-means init, codebook init, scorer init) cannot be reproduced by a
``torch.Generator``. To compare the two packages on the same state, the
caller exports the reference's arrays as numpy and loads them here; this
module sees only numpy arrays and plain numbers:

    state = {
        "bucket_params": {"hyperplanes:<mode>": f32 [T, D, bits], ...},
        "idf": {"sorted_ids": uint32 [S], "weights": f32 [S],
                "default_weight": f32 []},
        "filter": {"sorted_ids": uint32 [F]},
        "scorer": {"w0": ..., "b0": ..., "w1": ..., "b1": ..., "w2": ...,
                   "b2": ...},
        # backends "scann" and "sharded": the trained structures and the
        # layout the reference's build chose, so slots and slabs line up
        "centroids": f32 [C, d], "books": f32 [M, 256, d/M],
        "slab": int,
        "capacity": int,          # scann only
        "salt": int,              # sharded only: the owner-hash salt
    }

``graph_state`` takes the reference's ``DynamicGraphStore.snapshot_state()``
(numpy arrays, id maps, and its ``GraphConfig``, read by field name) and
builds the port's store at that state, so a test can continue one stream
from one adjacency in both packages. ``multimodal_state`` does the same
for the reference's ``MultiModalStore.snapshot_state()``: it gives the
state the port's ``MultiModalStore.restore_state`` takes.
``engine_snapshot`` converts a whole ``DynamicGUS.snapshot_state()`` of
the reference (the engine's snapshot of record) into the port's, so a port
engine restores from it (the sharded index's salt included, so it
re-routes as the reference does); like the port's own snapshots it holds host
arrays only, and ``restore_state`` puts them on the engine's device.
``lm_params`` carries the LM tower's params tree (``init_params`` of any
family of the reference's ``models/``, as nested numpy arrays) into the
port's dict of tensors, and ``adamw_state`` its AdamW state (``{step, m,
v}``, and the compressed data-parallel step's residual ``ef``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.ann.brute import BruteIndex
from repro_torch.ann.scann import ScannIndex
from repro_torch.ann.sharded_index import ShardedGusIndex
from repro_torch.core.idf import FilterTable, IdfTable
from repro_torch.core.maintenance import MaintenanceConfig
from repro_torch.graph.store import DynamicGraphStore, GraphConfig
from repro_torch.models import build_model
from repro_torch.train.optimizer import adamw_init
from repro_torch.utils.device import resolve


def _t(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a).astype(dtype),
                           device=resolve(device))


def bucket_params(arrays: dict, device=None) -> dict:
    return {k: _t(v, np.float32, device) for k, v in arrays.items()}


def idf_table(arrays: dict, device=None) -> IdfTable:
    return IdfTable(_t(arrays["sorted_ids"], np.int64, device),
                    _t(arrays["weights"], np.float32, device),
                    _t(arrays["default_weight"], np.float32, device))


def filter_table(arrays: dict, device=None) -> FilterTable:
    return FilterTable(_t(arrays["sorted_ids"], np.int64, device))


def scorer_params(arrays: dict, device=None) -> dict:
    return {k: _t(v, np.float32, device) for k, v in arrays.items()}


def multimodal_state(state: dict) -> dict:
    """The reference's ``MultiModalStore.snapshot_state()`` (numpy arrays,
    its routing tables as ``(sorted_ids, weights, default_weight)`` and
    ``sorted_ids``) as the port's ``restore_state`` takes it: private
    numpy copies, bucket ids of the tables as int64."""
    ids, weights, default = state["idf"]
    return dict(
        state,
        counts={"ids": np.array(state["counts"]["ids"], np.uint32),
                "counts": np.array(state["counts"]["counts"], np.int64),
                "n_points": int(state["counts"]["n_points"])},
        postings={int(b): [int(p) for p in v]
                  for b, v in state["postings"].items()},
        ids=np.array(state["ids"], np.int64),
        point_buckets=[np.array(r, np.uint32) for r in state["point_buckets"]],
        emb_idx=[np.array(r, np.uint32) for r in state["emb_idx"]],
        emb_val=[np.array(r, np.float32) for r in state["emb_val"]],
        sketch=[np.array(r, np.float32) for r in state["sketch"]],
        idf=(np.array(ids, np.int64), np.array(weights, np.float32),
             np.array(default, np.float32)),
        filter=np.array(state["filter"], np.int64))


def load_bootstrapped(gus, state: dict, ids: np.ndarray, features: dict) -> None:
    """``DynamicGUS.bootstrap`` with the reference's trained state: install
    its hyperplanes, tables and scorer, create the index from its trained
    structures at its layout, then load the corpus through the mutation
    path (as the reference's ``build`` does after training) and seed the
    multi-modal plane and the maintained graph, where configured, as
    ``bootstrap`` does."""
    dev = gus.device
    gus.embedder = gus.embedder.reload(idf=idf_table(state["idf"], dev),
                                       filter_table=filter_table(
                                           state["filter"], dev))
    gus.embedder.params = bucket_params(state["bucket_params"], dev)
    gus.scorer_params = scorer_params(state["scorer"], dev)
    k_dims = gus.embedder.k_max
    if gus.cfg.backend == "scann":
        gus.index = ScannIndex.from_trained(
            k_dims, gus.cfg.scann, state["centroids"], state["books"],
            capacity=int(state["capacity"]), slab=int(state["slab"]),
            device=dev)
    elif gus.cfg.backend == "sharded":
        gus.index = ShardedGusIndex.from_trained(
            k_dims, gus.cfg.sharded, state["centroids"], state["books"],
            slab=int(state["slab"]), device=dev)
        gus.index.restore_state({"salt": int(state.get("salt", 3))})
    else:
        gus.index = BruteIndex(k_dims, device=dev)
    gus.store.clear()
    emb = gus.embedder(features)
    gus.index.upsert(np.asarray(ids), emb)
    gus.store.put(ids, features)
    if gus.multimodal is not None:
        bucket_ids, valid = gus.embedder.buckets(features)
        gus.multimodal.rebuild(np.asarray(ids), emb, bucket_ids, valid)
    gus._start_graph(ids, build_graph=True)


def graph_snapshot(state: dict) -> dict:
    """The reference's ``DynamicGraphStore.snapshot_state()`` with its
    ``GraphConfig`` read field by field into the port's: the state the
    port's ``restore_state`` takes (the arrays stay numpy)."""
    ref = state["cfg"]
    maint = MaintenanceConfig(**{f.name: getattr(ref.maintenance, f.name)
                                 for f in dataclasses.fields(
                                     MaintenanceConfig)})
    cfg = GraphConfig(k=ref.k, width=ref.width, capacity=ref.capacity,
                      probe=ref.probe, maintenance=maint)
    return dict(state, cfg=cfg)


def graph_state(state: dict, device=None) -> DynamicGraphStore:
    """A port ``DynamicGraphStore`` restored from the reference's
    ``snapshot_state()``."""
    snap = graph_snapshot(state)
    store = DynamicGraphStore(snap["cfg"], device)
    store.restore_state(snap)
    return store


def engine_snapshot(ref_state: dict) -> dict:
    """The reference's ``DynamicGUS.snapshot_state()`` as the port's
    ``DynamicGUS.restore_state`` takes it: the store's numpy features
    unchanged, the index's routing state (the sharded index's owner-hash
    salt; empty for brute and scann), the graph through ``graph_snapshot``
    and the multi-modal plane through ``multimodal_state``. Host arrays
    only."""
    graph = ref_state.get("graph")
    mm = ref_state.get("multimodal")
    index = dict(ref_state.get("index") or {})
    if index.get("salt") is not None:
        index["salt"] = int(index["salt"])
    return {
        "store": {"ids": np.array(ref_state["store"]["ids"], np.int64),
                  "features": {k: np.array(v) for k, v in
                               ref_state["store"]["features"].items()}},
        "index": index,
        "graph": graph_snapshot(graph) if graph is not None else None,
        "multimodal": multimodal_state(mm) if mm is not None else None,
    }


def lm_params(arrays: dict, cfg, device=None) -> dict:
    """The reference's params tree of ``cfg``'s family (nested dicts of
    numpy arrays of any float dtype, bf16 included, at any depth) as the
    port's tree of tensors on ``device``. Each leaf takes its dtype from
    the port's own ``init_params`` for ``cfg``, built on the ``meta``
    device (the router, the scans' gate weights and biases and the norms
    stay f32 where the reference keeps them so); the same template checks
    every key and shape."""
    template = build_model(cfg).init_params(0, cfg, "meta")
    return _carry(arrays, template, "params", resolve(device))


def adamw_state(arrays: dict, cfg, opt_cfg, device=None) -> dict:
    """The reference's AdamW state for ``cfg``'s params (``{step, m, v}``
    and, from ``init_ef_state``, ``ef``; numpy arrays) as the port's, on
    ``device``. The dtypes come from the port's own ``adamw_init`` on the
    ``meta`` device (the moments in ``opt_cfg.moment_dtype``, the step
    int32). A residual ``ef`` leaf shaped like its param is every shard's
    (the reference's replicated value) and becomes [1, ...]; one stacked
    [n, ...] is carried as it is."""
    dev = resolve(device)
    params = build_model(cfg).init_params(0, cfg, "meta")
    template = adamw_init(params, opt_cfg)
    out = _carry({k: arrays[k] for k in template}, template, "opt", dev)
    if "ef" in arrays:
        def ef_leaf(a, p):
            a = np.asarray(a, np.float32)
            a = a[None] if a.shape == tuple(p.shape) else a
            if a.shape[1:] != tuple(p.shape):
                raise ValueError(f"ef: shape {a.shape} against the param's "
                                 f"{tuple(p.shape)}")
            return torch.as_tensor(a, device=dev)
        out["ef"] = _map2(ef_leaf, arrays["ef"], params)
    return out


def _map2(fn, a: dict, t: dict) -> dict:
    """``fn(a_leaf, t_leaf)`` over template ``t``'s keys."""
    return {k: _map2(fn, a[k], t[k]) if isinstance(t[k], dict)
            else fn(a[k], t[k]) for k in t}


def _carry(a, t, path: str, dev):
    """numpy tree ``a`` as tensors of template ``t``'s keys, shapes and
    dtypes, on ``dev``."""
    if isinstance(t, dict) != isinstance(a, dict):
        raise ValueError(f"{path}: a leaf against a subtree")
    if isinstance(t, dict):
        if set(a) != set(t):
            raise ValueError(f"{path}: keys {sorted(a)} != the port's "
                             f"{sorted(t)}")
        return {k: _carry(a[k], t[k], f"{path}/{k}", dev) for k in t}
    a = np.array(a, np.float32)
    if a.shape != tuple(t.shape):
        raise ValueError(f"{path}: shape {a.shape} != the port's "
                         f"{tuple(t.shape)}")
    return torch.as_tensor(a, device=dev).to(t.dtype)
