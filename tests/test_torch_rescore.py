"""The plain versions of the two fused steps against the reference, on the
CPU: the index's exact rescore with its final top-k
(``sparse_rescore_topk``) and the pair score (``pair_score``: pair
features and the scorer MLP). The CUDA kernels are held against these
plain versions on the card (tests/test_torch_kernels_cuda.py).

Tolerances: the rescore is bitwise with unit values (sums of exact
products, so any order agrees), exact ties included, and within atol
1e-6 with IDF-like values (the plain version sums in the kernel's order,
the reference in XLA's), slots equal; the pair score within rtol 1e-5,
atol 1e-6 (norms and sums in another order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ann.sparse import sparse_dot_one_many
from repro.core.scorer import pair_features as j_pair_features
from repro.core.scorer import scorer_apply as j_scorer_apply
from repro.data.synthetic import OGB_ARXIV_LIKE as J_ARXIV
from repro.data.synthetic import OGB_PRODUCTS_LIKE as J_PRODUCTS
from repro_torch.core.scorer import pair_layout, score_pairs
from repro_torch.core.types import PAD_INDEX
from repro_torch.data.synthetic import OGB_ARXIV_LIKE, OGB_PRODUCTS_LIKE
from repro_torch.kernels import cases, ops, ref

assert jax.default_backend() == "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on
    one machine, and torch's default of one thread per core oversubscribes
    it against the other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.partial(jax.jit, static_argnames=("k",))
def _reference_step4(q_idx, q_val, flat_slots, short_pos, short_scores,
                     sp_idx, sp_val, *, k):
    """Step 4 of the reference's ``_query_step``
    (``repro/ann/scann.py:126-144``) from its own pieces: the shortlist's
    slots, ``sp_idx[safe]``, ``vmap(sparse_dot_one_many)``, the mask and
    ``lax.top_k``."""
    short_slots = jnp.take_along_axis(flat_slots, short_pos, axis=-1)
    short_slots = jnp.where(jnp.isfinite(short_scores), short_slots, -1)
    safe = jnp.maximum(short_slots, 0)
    exact = jax.vmap(sparse_dot_one_many)(q_idx, q_val, sp_idx[safe],
                                          sp_val[safe])
    exact = jnp.where(short_slots >= 0, exact, -jnp.inf)
    final_scores, pos = jax.lax.top_k(exact, min(k, short_pos.shape[1]))
    final_slots = jnp.take_along_axis(short_slots, pos, axis=-1)
    final_slots = jnp.where(jnp.isfinite(final_scores), final_slots, -1)
    return final_slots, -final_scores


def _rescore_both(case: dict, k: int):
    """(port's plain version, reference) as numpy (slots, dists)."""
    got = ops.sparse_rescore_topk(
        *[torch.as_tensor(case[name]) for name in cases.RESCORE_ORDER], k)
    ref_args = {name: jnp.asarray(case[name]) for name in
                cases.RESCORE_ORDER}
    for name in ("q_idx", "sp_idx"):               # uint32 in the reference
        ref_args[name] = jnp.asarray(case[name].astype(np.uint32))
    want = _reference_step4(*ref_args.values(), k=k)
    return ([g.numpy() for g in got], [np.asarray(w) for w in want])


def _assert_bitwise(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].view(np.int32),
                                  want[1].view(np.int32))


def _case(seed: int, unit: bool, b=4, n=64, r=24, cap=100, kd=6,
          vocab=12) -> dict:
    return cases.rescore_inputs(np.random.default_rng(seed), b, n, r, cap,
                                kd, vocab, unit)


@pytest.mark.parametrize("unit", [True, False])
def test_rescore_plain_matches_reference(unit):
    """4 queries, 64 candidates, a shortlist of 24 and k = 10: unit values
    from a vocabulary of 12 (many exact ties across shortlist positions)
    bitwise; IDF-like values with the slots equal and the distances within
    atol 1e-6. Row 0's shortlist is all -inf, 15% of the rest too."""
    got, want = _rescore_both(_case(3, unit), 10)
    if unit:
        _assert_bitwise(got, want)
        assert len(np.unique(want[1][1])) < 10      # ties reach the cut
    else:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=0)
    assert (got[0][0] == -1).all() and np.isposinf(got[1][0]).all()


def _edge(name: str) -> tuple[dict, int]:
    case = _case(11, True)
    if name == "all -1 slots":
        case["flat_slots"][1] = -1                 # finite scores, no slot
    elif name == "fewer live than k":
        case["short_scores"][1:, 3:] = -np.inf     # 3 live entries a row
    elif name == "r=1":
        case["short_pos"] = case["short_pos"][:, :1].copy()
        case["short_scores"] = case["short_scores"][:, :1].copy()
    elif name == "PAD_INDEX in query and rows":
        case["q_idx"][:, :4] = PAD_INDEX
        case["q_val"][:, :4] = 0.0
        case["sp_idx"][::2, :5] = PAD_INDEX
    return case, 10


@pytest.mark.parametrize("name", ["all -1 slots", "fewer live than k", "r=1",
                                  "PAD_INDEX in query and rows"])
def test_rescore_plain_edge_cases(name):
    """A row whose slots are all -1 (finite shortlist scores), rows with
    fewer live entries than k, a shortlist of one, and padding in the
    query and the slab rows: bitwise with the reference."""
    case, k = _edge(name)
    got, want = _rescore_both(case, k)
    _assert_bitwise(got, want)
    if name == "all -1 slots":
        assert (got[0][1] == -1).all()
    if name == "fewer live than k":
        assert (got[0][1:, 3:] == -1).all()
    if name == "r=1":
        assert got[0].shape == (4, 1)


@pytest.mark.parametrize("shape", [(4, 24, 6, 6), (3, 17, 9, 5)])
def test_sparse_dot_seq_ref_matches_batched_ref_on_unit_values(shape):
    """The kernel's summation order agrees bitwise with the unordered sum
    where the products are exact (unit values), padding included."""
    b, r, kq, kd = shape
    rng = np.random.default_rng(b + r)
    q = cases.sparse_rows(rng, (b, kq), 10, True)
    db = cases.sparse_rows(rng, (b, r, kd), 10, True)
    args = [torch.as_tensor(a) for a in (*q, *db)]
    want = ref.sparse_dot_batched_ref(*args)
    got = ref.sparse_dot_seq_ref(*args)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (want > 0).any()


def _params(rng, f: int) -> dict:
    dims = [f, 10, 10, 1]
    out = {}
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"w{i}"] = (rng.normal(size=(d_in, d_out))
                        * (2.0 / d_in) ** 0.5).astype(np.float32)
        out[f"b{i}"] = rng.normal(size=(d_out,)).astype(np.float32) * 0.1
    return out


@pytest.mark.parametrize("group", [1, 10])
@pytest.mark.parametrize("which", ["arxiv", "products"])
def test_pair_score_plain_matches_reference(which, group):
    """``ops.pair_score`` (and ``score_pairs``) on the CPU against the
    reference's ``pair_features`` + ``scorer_apply`` on the query rows
    repeated ``group`` times: the arxiv spec (dense 128, a scalar) and the
    products spec (dense 100, a set of 16), 8 query rows."""
    spec, j_spec = {"arxiv": (OGB_ARXIV_LIKE.spec, J_ARXIV.spec),
                    "products": (OGB_PRODUCTS_LIKE.spec,
                                 J_PRODUCTS.spec)}[which]
    rng = np.random.default_rng(group)
    fq = cases.feature_rows(rng, spec, 8)
    fc = cases.feature_rows(rng, spec, 8 * group)
    if group > 1:                  # a candidate equal to its query
        for key in fq:
            fc[key][0] = fq[key][0]
    keys, layout = pair_layout(spec)
    params = _params(rng, layout.n_features)
    tparams = {k: torch.as_tensor(v) for k, v in params.items()}
    got = ops.pair_score(tparams, [torch.as_tensor(fq[k]) for k in keys],
                         [torch.as_tensor(fc[k]) for k in keys], layout,
                         group).numpy()
    rep = {k: jnp.asarray(np.repeat(v, group, axis=0)) for k, v in fq.items()}
    want = np.asarray(j_scorer_apply(
        {k: jnp.asarray(v) for k, v in params.items()},
        j_pair_features(rep, {k: jnp.asarray(v) for k, v in fc.items()},
                        j_spec)))
    assert got.shape == (8 * group,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        score_pairs(tparams, fq, fc, spec, group=group).numpy(), got)
