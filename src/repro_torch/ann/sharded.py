"""The sharded GUS programs, driven from one controller (port of
``repro/ann/sharded.py``).

The reference runs each program as one ``shard_map`` over a device mesh:
the index tower sharded over every chip, queries replicated in, a
scatter/merge dataflow with static shapes. Here one Python process drives
every shard: each program is a plain function over one shard's tensors
(a dict per shard, on the device ``launch/mesh.py`` places it on), and the
collectives are explicit operations in linear shard order
(``shard = data * n_model + model``, the reference's ``_linear_shard_id``):

* ``all_gather(..., axis=1, tiled=True)`` is a ``torch.cat`` along dim 1
  on shard 0's device;
* ``psum`` is a sum of the per-shard tensors;
* the ``"hier"`` merge gathers and selects within each "data" row, then
  gathers the rows.

  query step   — per shard: centroid matmul over the local partitions ->
                 local top-nprobe -> fused shortlist
                 (``kernels.ops.pq_score_dedup_topk``: PQ LUT scores over
                 the probed slabs, SOAR dedup by point id, top-r) -> exact
                 sparse rescore and local top-k
                 (``kernels.ops.sparse_rescore_topk`` over the shard's
                 ``[C_loc * S, K]`` slab rows) -> global rows. Then one
                 gather of the k-per-shard candidates and a merge top-k.
                 ``fused=False`` composes the shortlist from ``pq_scores``,
                 ``topk_select`` and ``dedup_mask``, bitwise the same.
  mutate step  — the batch goes to every shard; each keeps the rows it
                 owns (a salted hash of the id), appends them ring-buffer
                 style into the nearest local partition's slab and, with
                 SOAR, into a secondary local partition (copies
                 interleaved per row: row0 primary, row0 secondary, row1
                 primary, ...). Returns each row's landing sites (global
                 partition, slot) per copy, summed over shards.
  delete step  — tombstones at (global partition, slot); each shard clears
                 the slots it owns, everything else writes nowhere.
  compact step — per shard, per partition: live rows slide to the front of
                 the slab in stable order, dead tails reset to padding,
                 the ring cursor restarts at the live count; returns the
                 old-slot -> new-slot map.

Every ``lax.top_k`` of the reference is ``kernels.ref.topk_ref`` (its
order: +0.0 above -0.0, then the lowest index) or the top-k kernel in
that order. The reference's XLA work (centroid matmul, one-hot ring
positions, stable sort of compaction, masked scatters, route sums) stays
plain torch. The mutate and delete steps write the shard tensors in
place (``ShardedGusIndex`` copies them first after a publish); the
compact step builds new ones.

Per-shard state: ``centroids`` f32 [C_loc, d], ``books`` f32 [M, 256,
d/M], ``members_idx`` int64 [C_loc, S, K] (uint32 values),
``members_val`` f32 [C_loc, S, K], ``codes`` u8 [C_loc, S, M],
``row_ids`` int32 [C_loc, S] (the bits of the uint32 point id; PAD_ID is
-1), ``valid`` bool [C_loc, S], ``counts`` int32 [C_loc].

The dry-run (``launch/dryrun.py``) sizes its cells with ``index_specs``,
``index_shapes`` and the ``*_shapes`` below, and fills them with
``seeded_cell``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.ann import partition as part_mod
from repro_torch.ann import quantize as pq
from repro_torch.core import hashing
from repro_torch.core.types import PAD_INDEX
from repro_torch.kernels import ops
from repro_torch.kernels.ref import topk_ref
from repro_torch.kernels.topk_select import topk_select


@dataclasses.dataclass(frozen=True)
class GusCellConfig:
    """Shapes of one sharded-GUS cell."""
    name: str = "gus_serve_100m"
    n_rows: int = 1 << 27          # 134M points globally
    k_dims: int = 16               # nnz per sparse embedding
    d_proj: int = 128              # sketch dim
    pq_m: int = 16                 # PQ subspaces
    pq_centers: int = 256
    n_partitions: int = 4096       # global partitions (sharded w/ slabs)
    slab: int = 8192               # rows per partition slab
    nprobe_local: int = 2          # partitions probed per shard
    query_batch: int = 4096
    mutate_batch: int = 65536
    top_k: int = 100
    reorder: int = 0               # per-shard exact-rescore shortlist
    #                                (0 = the historical default, 2*top_k)
    # candidate-merge schedule: "flat" (one gather of k-per-shard over
    # every shard) or "hier" (intra-"model" gather + top-k, then
    # cross-"data")
    merge: str = "flat"
    # SOAR secondary-copy weight (Sun et al. 2024); < 0 = single copy
    soar_lambda: float = -1.0
    # fused shortlist (PQ-score -> dedup -> top-r in one kernel); False
    # composes the same stages from individual ops, bitwise-identical
    fused: bool = True
    # score the shortlist from a symmetric int8-quantised LUT
    pq_int8: bool = False

    @property
    def use_soar(self) -> bool:
        return self.soar_lambda >= 0

    @property
    def n_copies(self) -> int:
        return 2 if self.use_soar else 1


# reserved id that no shard ever owns (a uint32, held in int64); the
# row_ids slabs hold its int32 bits, -1
PAD_ID = 0xFFFFFFFF
ROW_PAD = -1
MUTABLE = ("members_idx", "members_val", "codes", "row_ids", "valid",
           "counts")


def global_array(states: list[dict], key: str) -> torch.Tensor:
    """One array of the shards' states, concatenated in linear order on
    the CPU (a host copy; row ids as their uint32 values in int64)."""
    a = torch.cat([st[key].cpu() for st in states])
    if key == "row_ids":
        a = a.to(torch.int64) & 0xFFFFFFFF
    return a


def make_query_step(mesh, cell: GusCellConfig):
    """``step(q_idx, q_val, q_sketch, states) -> (rows, dists)``: global
    rows int64 [B, top_k] (``(shard * C_loc + part) * S + pos``; -1 where
    the distance is +inf) and dists f32 [B, top_k] (minus the exact
    score), on shard 0's device."""
    hier = cell.merge == "hier" and len(mesh.axis_names) > 1
    n_model = mesh.shape[-1]

    def local_query(shard_id, q_idx, q_val, q_sketch, st):
        dev = st["valid"].device
        q_idx, q_val, q_sketch = (t.to(dev) for t in (q_idx, q_val, q_sketch))
        b = q_idx.shape[0]
        c_loc, s = st["valid"].shape
        m = st["books"].shape[0]
        # 1) local partition selection
        pscores = part_mod.partition_scores(q_sketch, st["centroids"])
        top_ps, top_parts = topk_ref(pscores, cell.nprobe_local)
        # 2+3) shortlist over the probed slabs: both copies of a point live
        # on its owner shard, so the dedup by point id is complete
        lut = pq.query_lut(q_sketch, st["books"])
        flat_codes = st["codes"][top_parts].reshape(b, -1, m)
        flat_valid = st["valid"][top_parts].reshape(b, -1)
        flat_ids = st["row_ids"][top_parts].reshape(b, -1)
        bias = top_ps.repeat_interleave(s, dim=-1)
        r = min(cell.reorder if cell.reorder > 0 else cell.top_k * 2,
                flat_valid.shape[-1])
        if cell.fused:
            short_vals, short = ops.pq_score_dedup_topk(
                lut, flat_codes, flat_ids, r, valid=flat_valid, bias=bias,
                quantized=cell.pq_int8)
        else:
            approx = ops.pq_scores(lut, flat_codes, quantized=cell.pq_int8)
            approx = torch.where(flat_valid, approx + bias, float("-inf"))
            short_vals, short = topk_select(approx, r, signed_zeros=True)
            short_vals = ops.dedup_mask(short_vals, short, flat_ids,
                                        flat_valid)
        # 4) exact rescore of the deduped shortlist and the local top-k;
        # the slab rows are the shard's [C_loc * S, K], a candidate's slot
        # part * S + pos
        flat_slots = (top_parts[:, :, None] * s
                      + torch.arange(s, device=dev)).reshape(b, -1)
        k_dims = st["members_idx"].shape[2]
        slots, dists = ops.sparse_rescore_topk(
            q_idx, q_val, flat_slots.to(torch.int32), short, short_vals,
            st["members_idx"].reshape(-1, k_dims),
            st["members_val"].reshape(-1, k_dims), min(cell.top_k, r))
        rows = torch.where(slots >= 0, shard_id * c_loc * s + slots.long(), -1)
        return -dists, rows

    def step(q_idx, q_val, q_sketch, states):
        dev0 = mesh.devices[0]
        parts = [local_query(i, q_idx, q_val, q_sketch, st)
                 for i, st in enumerate(states)]
        scores = [p[0].to(dev0) for p in parts]
        rows = [p[1].to(dev0) for p in parts]
        if hier:
            # stage 1 within each "data" row, stage 2 across the rows
            v1s, r1s = [], []
            for lo in range(0, len(states), n_model):
                v1, p1 = topk_ref(torch.cat(scores[lo:lo + n_model], 1),
                                  cell.top_k)
                v1s.append(v1)
                r1s.append(torch.gather(
                    torch.cat(rows[lo:lo + n_model], 1), 1, p1))
            scores, rows = v1s, r1s
        fin_scores, fin_pos = topk_ref(torch.cat(scores, 1), cell.top_k)
        return torch.gather(torch.cat(rows, 1), 1, fin_pos), -fin_scores

    return step


def make_mutate_step(mesh, cell: GusCellConfig, salt: int = 3):
    """Batched upsert: ``step(ids, new_idx, new_val, new_sketch, new_codes,
    states, new_codes2=None) -> (states, (route_part, route_pos))``.

    ``ids`` int64 [B] (uint32 values; ``PAD_ID`` rows land nowhere). Each
    row hash-routes to one shard (``uhash(salt, id) % n_shards``), which
    appends it into the nearest local partition's slab and, with SOAR, a
    secondary one (``ann.partition.assign_block``, the host mirror's own
    function); copies interleave per row, so the slab layout is a pure
    function of the row sequence. Returns each row's landing sites
    ``(global partition, slot)`` per copy, int64 [B, n_copies] on shard
    0's device (``(-1, 0)`` for a row no shard owns). ``salt`` is the
    owner hash's seed: ``ShardedGusIndex.resplit`` bumps it and builds a
    new step."""
    n_shards = mesh.size
    lam = cell.soar_lambda if cell.use_soar else -1.0

    def local_mutate(shard_id, ids, new_idx, new_val, new_sketch, new_codes,
                     new_codes2, st):
        dev = st["valid"].device
        ids, new_idx, new_val, new_sketch, new_codes, new_codes2 = (
            t.to(dev) for t in (ids, new_idx, new_val, new_sketch, new_codes,
                                new_codes2))
        c_loc, s = st["valid"].shape
        owner = hashing.uhash(salt, ids) % n_shards
        mine = (owner == shard_id) & (ids != PAD_ID)
        # nearest local partition (and the SOAR secondary) for every row;
        # rows not owned write nowhere
        p1, p2 = part_mod.assign_block(new_sketch, st["centroids"], lam)
        if cell.use_soar:
            part = torch.stack([p1, p2], dim=1).reshape(-1)   # interleaved
            put_idx = new_idx.repeat_interleave(2, dim=0)
            put_val = new_val.repeat_interleave(2, dim=0)
            put_codes = torch.stack([new_codes, new_codes2], dim=1) \
                .reshape(-1, new_codes.shape[1])
            put_ids = ids.repeat_interleave(2)
            put_mine = mine.repeat_interleave(2)
        else:
            part, put_idx, put_val, put_codes = p1, new_idx, new_val, \
                new_codes
            put_ids, put_mine = ids, mine
        # ring position: cursor[part] + my running count within part
        onehot = torch.nn.functional.one_hot(part, c_loc) \
            * put_mine[:, None]
        within = onehot.cumsum(0) - onehot                     # prior count
        pos = (st["counts"][part].long() + (within * onehot).sum(-1)) % s
        # masked scatter: the rows this shard does not own are dropped
        # before the write (the reference's mode="drop")
        w_part, w_pos = part[put_mine], pos[put_mine]
        st["members_idx"][w_part, w_pos] = put_idx[put_mine]
        st["members_val"][w_part, w_pos] = put_val[put_mine]
        st["codes"][w_part, w_pos] = put_codes[put_mine]
        st["row_ids"][w_part, w_pos] = ops._as_int32_bits(put_ids[put_mine])
        st["valid"][w_part, w_pos] = True
        st["counts"] += onehot.sum(0).to(torch.int32)
        route_part = torch.where(put_mine, shard_id * c_loc + part + 1, 0)
        route_pos = torch.where(put_mine, pos, 0)
        return route_part, route_pos

    def step(ids, new_idx, new_val, new_sketch, new_codes, states,
             new_codes2=None):
        if new_codes2 is None:
            new_codes2 = new_codes            # single-copy: slot unused
        dev0 = mesh.devices[0]
        routes = [local_mutate(i, ids, new_idx, new_val, new_sketch,
                               new_codes, new_codes2, st)
                  for i, st in enumerate(states)]
        # exactly one shard owns each row: the sums are its landing sites
        nc = cell.n_copies
        route_part = sum(r[0].to(dev0) for r in routes) - 1
        route_pos = sum(r[1].to(dev0) for r in routes)
        return states, (route_part.reshape(-1, nc), route_pos.reshape(-1, nc))

    return step


def make_delete_step(mesh, cell: GusCellConfig):
    """Tombstones: ``step(parts, poss, states) -> states`` clears validity
    at (global partition, slot) pairs. Each shard clears the pairs in its
    partition range; pairs with ``part == -1`` (padding), other shards'
    and out-of-range slots write nowhere. Tombstoned slots keep their
    stale payload until the compact step squeezes them out."""

    def step(parts, poss, states):
        for shard_id, st in enumerate(states):
            dev = st["valid"].device
            p, q = parts.to(dev), poss.to(dev)
            c_loc, s = st["valid"].shape
            local = p - shard_id * c_loc
            ok = (p >= 0) & (local >= 0) & (local < c_loc) & (q >= 0) \
                & (q < s)
            st["valid"][local[ok], q[ok]] = False
        return states

    return step


def make_compact_step(mesh, cell: GusCellConfig):
    """Slab compaction: ``step(states) -> (new_states, new_pos)``.

    Per shard, per local partition, live rows slide to the front of the
    slab in stable order (what keeps post-compaction queries
    bit-identical: every tie in the query step breaks by candidate
    order); dead tails reset to padding; the ring cursor restarts at the
    live count. ``new_pos`` is the old-slot -> new-slot map, i32 [C, S]
    (-1 at dead slots) on shard 0's device."""

    def local_compact(st):
        valid = st["valid"]
        s = valid.shape[1]
        ar = torch.arange(s, device=valid.device)
        live_rank = valid.to(torch.int64).cumsum(1) - 1
        key = torch.where(valid, live_rank, s + ar[None, :])
        perm = torch.sort(key, dim=1, stable=True).indices
        n_live = valid.sum(1).to(torch.int32)
        new_valid = ar[None, :] < n_live[:, None]

        def g2(a, fill):
            return torch.where(new_valid, torch.gather(a, 1, perm), fill)

        def g3(a, fill):
            idx = perm[:, :, None].expand(-1, -1, a.shape[2])
            return torch.where(new_valid[:, :, None],
                               torch.gather(a, 1, idx), fill)

        new_pos = torch.where(valid, live_rank, -1).to(torch.int32)
        return ({**st, "members_idx": g3(st["members_idx"], PAD_INDEX),
                 "members_val": g3(st["members_val"], 0.0),
                 "codes": g3(st["codes"], 0).to(torch.uint8),
                 "row_ids": g2(st["row_ids"], ROW_PAD),
                 "valid": new_valid, "counts": n_live}, new_pos)

    def step(states):
        out = [local_compact(st) for st in states]
        dev0 = mesh.devices[0]
        return ([o[0] for o in out],
                torch.cat([o[1].to(dev0) for o in out]))

    return step


# ------------------------------------------------------- the dry-run's cells

STATE_KEYS = ("centroids", "books", *MUTABLE)
# the index vocabulary of a seeded cell: small, so rows share indices and
# the exact rescore finds matches
VOCAB = 64
# the live share of each slab of a seeded cell: the rest is room for a
# mutate step's batch
FILL = 0.5


def index_specs(cell: GusCellConfig, mesh) -> dict:
    """How each state key is split over the shards (the reference's
    PartitionSpecs): 0 where dim 0 is split over every mesh axis in linear
    shard order, ``None`` where the key is replicated (``books``)."""
    return {key: None if key == "books" else 0 for key in STATE_KEYS}


def index_shapes(cell: GusCellConfig) -> dict:
    """key -> (global shape, torch dtype) of the index state. Shapes are
    the reference's; dtypes the port's: ``members_idx`` int64 holding the
    uint32 values, ``row_ids`` int32 holding their bits."""
    c, s = cell.n_partitions, cell.slab
    k, m = cell.k_dims, cell.pq_m
    return {
        "centroids": ((c, cell.d_proj), torch.float32),
        "books": ((m, cell.pq_centers, cell.d_proj // m), torch.float32),
        "members_idx": ((c, s, k), torch.int64),
        "members_val": ((c, s, k), torch.float32),
        "codes": ((c, s, m), torch.uint8),
        "row_ids": ((c, s), torch.int32),
        "valid": ((c, s), torch.bool),
        "counts": ((c,), torch.int32),
    }


def query_shapes(cell: GusCellConfig) -> tuple:
    """(shape, dtype) of ``q_idx`` (int64: uint32 values), ``q_val``,
    ``q_sketch``."""
    b, k = cell.query_batch, cell.k_dims
    return (((b, k), torch.int64), ((b, k), torch.float32),
            ((b, cell.d_proj), torch.float32))


def mutate_shapes(cell: GusCellConfig) -> tuple:
    """(shape, dtype) of ``ids`` and ``new_idx`` (int64: uint32 values),
    ``new_val``, ``new_sketch``, ``new_codes``."""
    b, k = cell.mutate_batch, cell.k_dims
    return (((b,), torch.int64), ((b, k), torch.int64),
            ((b, k), torch.float32), ((b, cell.d_proj), torch.float32),
            ((b, cell.pq_m), torch.uint8))


def delete_shapes(cell: GusCellConfig) -> tuple:
    """(shape, dtype) of the tombstones' ``parts`` and ``poss``: int64, as
    the mutate step returns its landing sites."""
    b = cell.mutate_batch
    return (((b,), torch.int64), ((b,), torch.int64))


def _generator(dev: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def _sparse_rows(g, shape, dev):
    """Indices from ``VOCAB`` with an eighth padding, values in +-{1, 2,
    3}: every dot of two rows is a small integer."""
    idx = torch.randint(0, VOCAB, shape, generator=g, device=dev)
    pad = torch.rand(shape, generator=g, device=dev) < 0.125
    idx = torch.where(pad, PAD_INDEX, idx)
    mag = torch.randint(1, 4, shape, generator=g, device=dev)
    sign = torch.randint(0, 2, shape, generator=g, device=dev) * 2 - 1
    return idx, (mag * sign).to(torch.float32)


def seeded_cell(cell: GusCellConfig, mesh, *, seed: int = 0
                ) -> tuple[list[dict], dict]:
    """One cell's per-shard states on the mesh's devices and its step
    inputs, drawn from ``seed`` by a ``torch.Generator`` on each shard's
    device (shard ``i`` draws from ``seed * 1_000_003 + i``).

    Every value is a small integer (centroids, books, sketches, sparse
    rows from ``VOCAB``), so every sum the query step forms is exact in
    any order and a card agrees with the CPU bit for bit. Each slab's
    first ``FILL`` of its slots are live and its cursor is there; the rest
    are empty (padding, invalid). A live slot's row id is ``global
    partition * S + slot``: unique and below ``C * S``, the first id of
    the mutation batch. Inputs: ``"query"``, copies of stored rows (query
    ``b`` a live row of shard ``b % shards``, its sketch that partition's
    centroid, so the owning shard probes it); ``"mutate"``, ids ``C * S +
    arange(B)`` with random rows (sketches in [-6, 6], so rows spread over
    the partitions). Draws differ between devices: a CPU twin of a card's
    cell is a copy, not a second draw."""
    n = mesh.size
    if cell.n_partitions % n:
        raise ValueError(f"seeded_cell: {cell.n_partitions} partitions do "
                         f"not split over {n} shards")
    c_loc, s, k, m, d = (cell.n_partitions // n, cell.slab, cell.k_dims,
                         cell.pq_m, cell.d_proj)
    live = int(s * FILL)
    dev0 = mesh.devices[0]
    g0 = _generator(dev0, seed * 1_000_003 + n)
    books = torch.randint(-3, 4, (m, cell.pq_centers, d // m), generator=g0,
                          device=dev0).to(torch.float32)
    b = cell.query_batch
    q_idx = torch.empty((b, k), dtype=torch.int64, device=dev0)
    q_val = torch.empty((b, k), dtype=torch.float32, device=dev0)
    q_sk = torch.empty((b, d), dtype=torch.float32, device=dev0)
    states = []
    for i, dev in enumerate(mesh.devices):
        g = _generator(dev, seed * 1_000_003 + i)
        idx = torch.full((c_loc, s, k), PAD_INDEX, dtype=torch.int64,
                         device=dev)
        val = torch.zeros((c_loc, s, k), dtype=torch.float32, device=dev)
        idx[:, :live], val[:, :live] = _sparse_rows(g, (c_loc, live, k), dev)
        codes = torch.zeros((c_loc, s, m), dtype=torch.uint8, device=dev)
        codes[:, :live] = torch.randint(0, cell.pq_centers, (c_loc, live, m),
                                        generator=g, device=dev,
                                        dtype=torch.uint8)
        slot = torch.arange(s, device=dev)
        valid = (slot < live).expand(c_loc, s).contiguous()
        part = torch.arange(i * c_loc, (i + 1) * c_loc, device=dev)
        row_ids = torch.where(valid, part[:, None] * s + slot, ROW_PAD)
        st = {"centroids": torch.randint(-4, 5, (c_loc, d), generator=g,
                                         device=dev).to(torch.float32),
              "books": books.to(dev), "members_idx": idx,
              "members_val": val, "codes": codes,
              "row_ids": row_ids.to(torch.int32), "valid": valid,
              "counts": torch.full((c_loc,), live, dtype=torch.int32,
                                   device=dev)}
        states.append(st)
        mine = torch.arange(i, b, n, device=dev0)
        if len(mine):
            p = torch.randint(0, c_loc, (len(mine),), generator=g, device=dev)
            j = torch.randint(0, live, (len(mine),), generator=g, device=dev)
            q_idx[mine] = idx[p, j].to(dev0)
            q_val[mine] = val[p, j].to(dev0)
            q_sk[mine] = st["centroids"][p].to(dev0)
    bm = cell.mutate_batch
    new_idx, new_val = _sparse_rows(g0, (bm, k), dev0)
    mutate = (torch.arange(bm, device=dev0) + cell.n_partitions * s,
              new_idx, new_val,
              torch.randint(-6, 7, (bm, d), generator=g0,
                            device=dev0).to(torch.float32),
              torch.randint(0, cell.pq_centers, (bm, m), generator=g0,
                            device=dev0, dtype=torch.uint8))
    return states, {"query": (q_idx, q_val, q_sk), "mutate": mutate}
