"""The bucket-column kernels' arithmetic (``kernels/csrc/buckets.cu``),
written out in numpy uint32, against the reference's ``generate_buckets``
on the CPU: the per-column constants that ``kernels/buckets.py`` computes
from the schema and the ``BucketConfig`` alone, combined with each
column's value as the kernels combine them, give the reference's ids and
valid flags bit for bit. The port's plain wrappers are held to the same
columns, and making the constants draws nothing from the hyperplanes'
generator."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.buckets import BucketConfig as JBucketConfig
from repro.core.buckets import generate_buckets as j_generate_buckets
from repro.core.types import FeatureSpec as JFeatureSpec
from repro_torch.core.buckets import BucketConfig, make_bucket_params
from repro_torch.core.types import PAD_ITEM, FeatureSpec
from repro_torch.kernels import buckets as kb

SCHEMAS = {
    "arxiv": dict(dense={"text": 128}, sets={}, scalars=("year",)),
    "products": dict(dense={"bow_pca": 100}, sets={"copurchase": 16},
                     scalars=()),
    "mixed": dict(dense={"b": 40, "a": 24}, sets={"t": 11, "s": 5},
                  scalars=("y", "x")),
}
# the cells' buckets; the mixed schema with more MinHash tables than the
# kernel takes in one pass over a row's items, and two scalar widths
CONFIGS = {
    "arxiv": dict(dense_tables=8, dense_bits=10, set_tables=6,
                  scalar_widths=(2.0,)),
    "products": dict(dense_tables=8, dense_bits=10, set_tables=6,
                     scalar_widths=(2.0,)),
    "mixed": dict(dense_tables=5, dense_bits=12, set_tables=10,
                  scalar_widths=(2.0, 0.25), seed=7),
}
ROWS = 67
M32 = np.uint32(0xFFFFFFFF)
GOLDEN = np.uint32(0x9E3779B9)


def _fmix32(x):
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def _combine(h, v):
    return _fmix32(h ^ (v + GOLDEN + (h << np.uint32(6))
                        + (h >> np.uint32(2))))


def _features(rng, spec: dict, rows: int) -> dict:
    """Seeded features with the edges: all-PAD and half-PAD set rows,
    items at the int32 limits, negative, fractional and whole-bin
    scalars, +-0.0."""
    feats = {}
    for name, dim in spec["dense"].items():
        feats[f"dense:{name}"] = rng.normal(size=(rows, dim)).astype(
            np.float32)
    for name, cap in spec["sets"].items():
        items = rng.integers(-2 ** 31, 2 ** 31, (rows, cap), dtype=np.int64)
        items[::3] = rng.integers(0, 40, (len(items[::3]), cap))
        items[rng.random((rows, cap)) < 0.4] = PAD_ITEM
        items[0] = PAD_ITEM
        items[1, :2] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max]
        items[2, : cap // 2] = PAD_ITEM
        feats[f"set:{name}"] = items.astype(np.int32)
    for name in spec["scalars"]:
        x = (rng.normal(size=rows) * 40).astype(np.float32)
        x[:6] = [-3.75, -2.0, -0.0, 0.0, 0.25, 4.0]
        feats[f"scalar:{name}"] = x
    return feats


def _planes(spec: dict, cfg: BucketConfig) -> dict:
    """Hyperplanes drawn with numpy, handed to both packages."""
    rng = np.random.default_rng(0)
    return {f"hyperplanes:{name}": rng.normal(size=(
        cfg.dense_tables, dim, cfg.dense_bits)).astype(np.float32)
        for name, dim in sorted(spec["dense"].items())}


def _projections(feats, spec: dict, planes: dict) -> list:
    """The reference's own SimHash projections [T, B, bits], sorted."""
    return [np.asarray(jnp.einsum("bd,tdk->tbk",
                                  jnp.asarray(feats[f"dense:{n}"]),
                                  jnp.asarray(planes[f"hyperplanes:{n}"])))
            for n in sorted(spec["dense"])]


def _kernel_columns(feats, projections, tspec, cfg):
    """The kernels' arithmetic in numpy uint32: (ids, valid) [B, k_max]."""
    cols = kb.column_constants(tspec, cfg)
    prefix = np.asarray(cols.prefix, np.uint32)
    seed_mix = np.asarray(cols.seed_mix, np.uint32)
    rows = next(iter(feats.values())).shape[0]
    ids = np.zeros((rows, cfg.k_max(tspec)), np.uint32)
    valid = np.zeros(ids.shape, bool)
    c = 0
    weights = np.uint32(1) << np.arange(min(cfg.dense_bits, 32),
                                        dtype=np.uint32)
    for proj in projections:
        codes = ((proj[..., :32] > 0).astype(np.uint32) * weights).sum(
            -1, dtype=np.uint32)                         # [T, B]
        for t in range(cfg.dense_tables):
            ids[:, c] = _combine(prefix[c], codes[t])
            valid[:, c] = True
            c += 1
    for name in sorted(tspec.sets):
        items = feats[f"set:{name}"]
        present = items != PAD_ITEM
        x = items.view(np.uint32) * GOLDEN
        for t in range(cfg.set_tables):
            low = np.where(present, _fmix32(x ^ seed_mix[t]), M32).min(-1)
            ids[:, c] = _combine(prefix[c], low)
            valid[:, c] = present.any(-1)
            c += 1
    for name in sorted(tspec.scalars):
        x = feats[f"scalar:{name}"]
        for wi, width in enumerate(cfg.scalar_widths):
            bins = np.floor(x / np.float32(width)).astype(np.int32)
            ids[:, c] = _combine(prefix[c], bins.view(np.uint32))
            valid[:, c] = True
            c += 1
    assert c == ids.shape[1]
    return ids, valid


@pytest.mark.parametrize("schema", sorted(SCHEMAS))
def test_kernel_arithmetic_matches_the_reference_bitwise(schema):
    """The constants and the kernels' uint32 arithmetic give the
    reference's bucket ids and valid flags, bit for bit, from the
    reference's own projections; so do the port's plain wrappers."""
    spec, kw = SCHEMAS[schema], CONFIGS[schema]
    tspec, cfg = FeatureSpec(**spec), BucketConfig(**kw)
    feats = _features(np.random.default_rng(len(schema)), spec, ROWS)
    planes = _planes(spec, cfg)
    want_ids, want_valid = j_generate_buckets(
        {k: jnp.asarray(v) for k, v in feats.items()}, JFeatureSpec(**spec),
        JBucketConfig(**kw), {k: jnp.asarray(v) for k, v in planes.items()})
    want_ids = np.asarray(want_ids)
    want_valid = np.asarray(want_valid)
    assert want_ids.dtype == np.uint32
    if tspec.sets:                 # the edges are there: an empty row
        assert not want_valid[0].all() and want_valid[1:].any()

    projections = _projections(feats, spec, planes)
    ids, valid = _kernel_columns(feats, projections, tspec, cfg)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(valid, want_valid)

    t_ids = torch.empty(want_ids.shape, dtype=torch.int64)
    t_valid = torch.empty(want_ids.shape, dtype=torch.bool)
    kb.simhash_scalar_columns(
        [torch.from_numpy(np.array(p)) for p in projections],
        [torch.as_tensor(feats[f"scalar:{n}"])
         for n in sorted(tspec.scalars)],
        tspec, cfg, t_ids, t_valid)
    kb.minhash_columns(
        [torch.as_tensor(feats[f"set:{n}"]) for n in sorted(tspec.sets)],
        tspec, cfg, t_ids, t_valid)
    np.testing.assert_array_equal(t_ids.numpy(), want_ids.astype(np.int64))
    np.testing.assert_array_equal(t_valid.numpy(), want_valid)
    assert kb.simhash_scalar_columns.launches == 0       # CPU: plain only
    assert kb.minhash_columns.launches == 0


@pytest.mark.parametrize("bits", [10, 12])
def test_simhash_codes_at_signed_zeros(bits):
    """Projections of exactly +0.0 and -0.0 set no bit, at 10 and 12 bits:
    the kernels' ``proj > 0`` against the reference's packed codes."""
    spec = dict(dense={"text": ROWS}, sets={}, scalars=())
    kw = dict(dense_tables=3, dense_bits=bits)
    tspec, cfg = FeatureSpec(**spec), BucketConfig(**kw)
    rng = np.random.default_rng(bits)
    proj = rng.normal(size=(3, ROWS, bits)).astype(np.float32)
    proj[rng.random(proj.shape) < 0.3] = 0.0
    proj[rng.random(proj.shape) < 0.3] = -0.0
    # the reference packs these signs itself: hand it x = I and planes =
    # the projection, so its einsum returns the projection unchanged
    x = np.eye(ROWS, dtype=np.float32)
    want, _ = j_generate_buckets(
        {"dense:text": jnp.asarray(x)}, JFeatureSpec(**spec),
        JBucketConfig(**kw), {"hyperplanes:text": jnp.asarray(proj)})
    ids, _ = _kernel_columns({"dense:text": x}, [proj], tspec, cfg)
    np.testing.assert_array_equal(ids, np.asarray(want))


def test_constants_draw_nothing_from_the_planes_generator():
    """The constants come from the schema and the config alone: the
    hyperplanes drawn after them are bitwise those drawn before, the
    global generator is untouched, and the parameters hold the planes
    only."""
    tspec = FeatureSpec(**SCHEMAS["mixed"])
    cfg = BucketConfig(**CONFIGS["mixed"])
    before = make_bucket_params(tspec, cfg, "cpu")
    state = torch.random.get_rng_state()
    cols = kb.column_constants(tspec, cfg)
    kb._device_constants(tspec, cfg, torch.device("cpu"))
    after = make_bucket_params(tspec, cfg, "cpu")
    assert torch.equal(state, torch.random.get_rng_state())
    assert set(before) == set(after) == {"hyperplanes:a", "hyperplanes:b"}
    for key in before:
        assert torch.equal(before[key].view(torch.int32),
                           after[key].view(torch.int32))
    assert len(cols.prefix) == cfg.k_max(tspec)
    assert len(cols.seed_mix) == cfg.set_tables
