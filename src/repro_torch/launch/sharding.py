"""Sharding policy (port of ``repro/launch/sharding.py``): partition specs
for the params, optimizer state, batches and caches of every (arch x
shape) cell, and what one device of a mesh holds under them.

The port runs on one controller and shards nothing itself. The policy is
what the dry-run sizes a cell by: ``per_device_bytes`` is the memory one
device of the production mesh would hold (``launch/dryrun.py``'s
``argument_bytes`` and ``output_bytes``), and the specs name the
collectives a sharded step would run (``dryrun.collectives_from_specs``).

A spec is a ``P``: a tuple whose entries are ``None``, an axis name or a
tuple of names, equal to ``tuple()`` of the reference's
``PartitionSpec``. A mesh is anything with ``shape`` and ``axis_names``
(``launch/mesh.py``'s ``GusMesh``, or ``make_production_mesh(...,
device="meta")``, which needs no device). Trees are the port's nested
dicts of tensors (meta tensors size a cell without memory), walked in the
reference's flatten order (``utils/tree.leaves_with_paths``).

Baseline policy ("auto"), the reference's rules and fallbacks unchanged:
for each parameter leaf, skip its stacked layer dims, then shard the
largest remaining dim divisible by the model-axis size on "model" and the
largest remaining divisible dim on the (composite) FSDP axis. Small
leaves (norm scales, biases) stay replicated. A dim that does not divide
is not sharded on that axis and the next candidate is taken (qwen2-vl's
28 heads fall back to replicating its projections across "model").
Since the policy shards only dims that divide, ``shard_shape`` is exact.
"""
from __future__ import annotations

import math

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.utils.tree import leaves_with_paths, tree_unflatten

# leaves smaller than this stay replicated (norm scales, biases, gates)
REPLICATE_BELOW = 1 << 16


class P(tuple):
    """A partition spec: one entry a dim (``None``, an axis name or a tuple
    of names); a shorter spec leaves the remaining dims unsharded."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _stack_depth(cfg: ModelConfig, top_key: str) -> int:
    """How many leading dims of a leaf under this top-level key are layer
    stacks (scan carriers) that must not be sharded."""
    if cfg.family == "ssm":
        return {"mlstm": 2, "slstm": 1}.get(top_key, 0)
    if cfg.family == "hybrid":
        return {"attn": 1, "mamba_moe": 2, "mamba_dense": 2}.get(top_key, 0)
    if cfg.family == "encdec":
        return {"enc": 1, "dec": 1}.get(top_key, 0)
    return {"blocks": 1}.get(top_key, 0)


def _mesh_axes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.shape))


def _dp(mesh) -> tuple:
    """(entry, size) of the composite data-parallel axis: ("pod", "data")
    or "data", and its device count."""
    axes = _mesh_axes(mesh)
    names = tuple(n for n in ("pod", "data") if n in axes)
    entry = names if len(names) > 1 else names[0]
    return entry, math.prod(axes[n] for n in names)


def auto_param_spec(path_keys, shape, cfg: ModelConfig, mesh) -> P:
    """Megatron-style name rules + divisibility fallbacks.

    Column-parallel (output dim on "model"): wq/wk/wv, gate/up, in/up_proj,
    expert w_gate/w_up (TP form), lm_head. Row-parallel (input dim on
    "model", psum after): wo, down, out/down_proj. The other large dim goes
    to the composite FSDP axis. Experts shard on "model" (EP) when E
    divides it. Dims that don't divide fall back to the next candidate
    (e.g. 28 heads -> head_dim).
    """
    axes = _mesh_axes(mesh)
    model_n = axes.get("model", 1)
    fsdp_names = tuple(n for n in ("pod", "data") if n in axes)
    fsdp_n = math.prod(axes[n] for n in fsdp_names) if fsdp_names else 1
    fsdp = (fsdp_names if len(fsdp_names) > 1 else fsdp_names[0]) \
        if fsdp_names else None

    shape = tuple(shape)
    skip = _stack_depth(cfg, str(path_keys[0])) if path_keys else 0
    name = str(path_keys[-1])
    # norm scales, biases and other small vectors replicate
    if math.prod(shape) < REPLICATE_BELOW or "norm" in name \
            or name in ("gn", "b", "D", "dt_bias", "conv_b", "bq", "bk",
                        "bv", "bo", "x_bq", "x_bk", "x_bv", "x_bo",
                        "b_up", "b_down"):
        return P(*([None] * len(shape)))
    body = shape[skip:]
    nd = len(body)

    def div(i, n):
        return n > 1 and body[i] % n == 0 and body[i] >= n

    def compose(model_dim, fsdp_dim):
        entries = [None] * nd
        if model_dim is not None:
            entries[model_dim] = "model"
        if fsdp_dim is not None and fsdp_dim != model_dim:
            entries[fsdp_dim] = fsdp
        return P(*([None] * skip + entries))

    def pick(pref_model: list, pref_fsdp: list):
        m = next((i for i in pref_model if div(i, model_n)), None)
        f = next((i for i in pref_fsdp
                  if i != m and fsdp is not None and div(i, fsdp_n)), None)
        return compose(m, f)

    # attention projections [d, H|Hkv, Dh] / [H, Dh, d]. Dh is never
    # sharded (RoPE's half split); heads that don't divide the model axis
    # replicate the projection across it instead.
    if name in ("wq", "wk", "wv") and nd == 3:
        if body[0] <= 64:                 # mlstm block-diag [H, Dh, Dh]
            return pick([2], [1])         # column-parallel on Dh_out
        return pick([1], [0])             # heads on model; d -> fsdp
    if name == "wo" and nd == 3:
        return pick([0], [2])
    if name in ("wq", "wk", "wv") and nd == 2:   # mlstm block-diag [Dh, Dh]
        return pick([1], [0])
    # MoE expert stacks [E, d, ff] / [E, ff, d]: EP when E divides model
    if name in ("w_gate", "w_up") and nd == 3:
        return pick([0, 2], [1])           # EP on E, else TP on ff
    if name == "w_down" and nd == 3:
        return pick([0, 1], [2])           # EP on E, else TP on ff
    # column-parallel matmuls
    if name in ("gate", "up", "w_up", "in_proj", "up_proj", "w",
                "x_w_up", "lm_head"):
        return pick([1], [0])
    # row-parallel matmuls
    if name in ("down", "w_down", "out_proj", "down_proj"):
        return pick([0], [1])
    if name == "embed":
        return pick([0], [1])             # vocab on model, d on fsdp
    if name in ("w_if", "x_proj"):
        return pick([0], [1])
    if name == "dt_proj":
        return pick([1], [])
    if name in ("A_log",):
        return pick([0], [])
    if name == "conv_w":
        return pick([1], [])
    if name == "r":                        # slstm recurrent [Dh, 4Dh]
        return pick([1], [0])
    if name in ("shared_gate", "shared_up"):
        return pick([1], [0])
    if name == "shared_down":
        return pick([0], [1])
    if name == "router":
        return pick([], [0])
    # whisper cross/self attn under x_ prefix
    if name.startswith("x_w") and nd == 3:
        if name == "x_wo":
            return pick([0, 1], [2])
        return pick([1, 2], [0])
    # generic fallback: largest divisible dim -> model, next -> fsdp
    cands = sorted(range(nd), key=lambda i: -body[i])
    m = next((i for i in cands if div(i, model_n)), None)
    f = next((i for i in cands
              if i != m and fsdp is not None and div(i, fsdp_n)), None)
    return compose(m, f)


def _path_keys(path: str) -> tuple:
    return tuple(path.split("/")) if path else ()


def param_specs(params_shape, cfg: ModelConfig, mesh):
    """A tree of ``P`` shaped like the params tree."""
    specs = [auto_param_spec(_path_keys(p), v.shape, cfg, mesh)
             for p, v in leaves_with_paths(params_shape)]
    return tree_unflatten(params_shape, specs)


def opt_specs(opt_shape, p_specs):
    """Optimizer state: moments inherit the param spec; step replicated."""
    return {"step": P(), "m": p_specs, "v": p_specs}


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, batch_shape):
    """Every batch leaf shards its leading (batch) dim over the dp axes
    when they divide it, else replicates."""
    dp, dp_n = _dp(mesh)

    def spec_of(s):
        lead = dp if s.shape[0] % dp_n == 0 else None
        return P(*([lead] + [None] * (len(s.shape) - 1)))

    return {k: spec_of(v) for k, v in batch_shape.items()}


def cache_specs_tree(cfg: ModelConfig, shape: ShapeConfig, mesh, cache_shape):
    """Decode caches: batch on the dp axes when divisible, the long (seq)
    dim on "model"; O(1) SSM states shard their channel dim on "model"."""
    model_n = _mesh_axes(mesh).get("model", 1)
    dp_entry, dp_n = _dp(mesh)
    b = shape.global_batch

    def spec_of(path, v):
        name = _path_keys(path)[-1]
        if name == "len":
            return P(None)
        vs = tuple(v.shape)
        entries = [None] * len(vs)
        # find the batch dim: first dim equal to global_batch after stacks
        for i, s in enumerate(vs):
            if s == b and b % dp_n == 0 and b >= dp_n:
                entries[i] = dp_entry
                break
        # KV caches: shard the seq dim (== shape.seq_len) on model
        for i, s in enumerate(vs):
            if entries[i] is None and s == shape.seq_len \
                    and s % model_n == 0:
                entries[i] = "model"
                return P(*entries)
        # SSM states: shard the largest remaining divisible dim on model
        cands = sorted(
            [(i, s) for i, s in enumerate(vs) if entries[i] is None],
            key=lambda t: -t[1])
        for i, s in cands:
            if model_n > 1 and s % model_n == 0 and s >= model_n \
                    and s > 128:
                entries[i] = "model"
                break
        # if batch couldn't shard on dp, also try it on dp via seq/channels
        if all(e is None or e == "model" for e in entries) and dp_n > 1:
            for i, s in cands:
                if entries[i] is None and s % dp_n == 0 and s > 128:
                    entries[i] = dp_entry
                    break
        return P(*entries)

    return tree_unflatten(cache_shape, [spec_of(p, v) for p, v in
                                        leaves_with_paths(cache_shape)])


def axis_size(entry, mesh) -> int:
    """The device count a spec entry splits a dim over (1 for ``None``)."""
    if entry is None:
        return 1
    axes = _mesh_axes(mesh)
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(axes[n] for n in names)


def shard_shape(shape, spec, mesh) -> tuple:
    """The shape one device of ``mesh`` holds of a ``shape`` tensor under
    ``spec``; raises where an entry's axes do not divide its dim (the
    policy never gives such a spec)."""
    shape = tuple(shape)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than {shape}")
    out = []
    for i, n in enumerate(shape):
        k = axis_size(spec[i], mesh) if i < len(spec) else 1
        if n % k:
            raise ValueError(f"dim {i} of {shape} does not divide over "
                             f"{spec[i]!r} ({k} devices)")
        out.append(n // k)
    return tuple(out)


def spec_at(specs, path: str):
    """The spec at ``path`` (a ``leaves_with_paths`` path) of a spec
    tree."""
    for key in _path_keys(path):
        seq = isinstance(specs, (list, tuple)) and not isinstance(specs, P)
        specs = specs[int(key)] if seq else specs[key]
    return specs


def per_device_bytes(tree, specs, mesh) -> int:
    """Bytes one device of ``mesh`` holds of ``tree`` (tensors, meta ones
    included) under ``specs`` (a tree of ``P`` of the same structure)."""
    return sum(math.prod(shard_shape(t.shape, spec_at(specs, path), mesh))
               * t.element_size() for path, t in leaves_with_paths(tree))
