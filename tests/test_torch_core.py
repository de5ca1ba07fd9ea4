"""The port's CLUGP passes (clustering, contraction, game) held against
the JAX package on the same inputs, on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import graphgen as jgen  # noqa: E402
from repro.core.clustering import (compact_labels_jax,  # noqa: E402
                                   streaming_clustering_jax)
from repro.core.game import jax_game_rounds, jax_greedy_assign  # noqa: E402
from repro.core.stages import cluster_graph_arrays as jax_cga  # noqa: E402
from repro_torch.core import graphgen, metrics  # noqa: E402
from repro_torch.core.clustering import (compact_labels,  # noqa: E402
                                         default_vmax, streaming_clustering)
from repro_torch.core import game as G  # noqa: E402
from repro_torch.core.game import game_rounds, greedy_assign  # noqa: E402
from repro_torch.core.stages import (cluster_graph_arrays,  # noqa: E402
                                     lambda_from_totals)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("gen,args", [
    ("web_graph", dict(scale=9, edge_factor=5, seed=3)),
    ("rmat_graph", dict(scale=8, edge_factor=4, seed=1)),
    ("social_graph", dict(n=300, m=3, seed=2))])
def test_graphgen_is_bit_identical(gen, args):
    a = getattr(graphgen, gen)(**args)
    b = getattr(jgen, gen)(**args)
    assert a.num_vertices == b.num_vertices
    np.testing.assert_array_equal(a.src, b.src)
    np.testing.assert_array_equal(a.dst, b.dst)
    assert metrics.replication_factor(a.src, a.dst, a.src % 4, a.num_vertices,
                                      4) > 1.0


@pytest.fixture(scope="module")
def g10():
    return graphgen.web_graph(scale=10, edge_factor=5, seed=4)


@pytest.mark.parametrize("sdf,id_cap", [(0.0, None), (4.0, None),
                                        (0.0, 1200), (4.0, 1000)])
def test_clustering_matches_reference(g10, sdf, id_cap):
    """Blocked clustering: raw labels, degrees, split marks, replica
    counts and next_id bit for bit — also when ``id_cap`` overflows."""
    vmax = default_vmax(g10.num_edges, 8)
    want = streaming_clustering_jax(g10.src, g10.dst, g10.num_vertices, vmax,
                                    split_degree_factor=sdf, id_cap=id_cap)
    got = streaming_clustering(_t(g10.src), _t(g10.dst), g10.num_vertices,
                               vmax, split_degree_factor=sdf, id_cap=id_cap)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if id_cap is not None:
        assert int(got[4]) > id_cap - 2        # the overflow is visible
    cap = id_cap or g10.num_vertices + 2 * g10.num_edges + 2
    wc, wm = compact_labels_jax(want[0], cap)
    gc, gm = compact_labels(got[0], cap)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    assert int(gm) == int(wm)


def test_clustering_no_split_matches_reference(g10):
    vmax = default_vmax(g10.num_edges, 8)
    want = streaming_clustering_jax(g10.src, g10.dst, g10.num_vertices, vmax,
                                    allow_split=False)
    got = streaming_clustering(_t(g10.src), _t(g10.dst), g10.num_vertices,
                               vmax, allow_split=False)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# (web_graph seed, split_degree_factor, allow_split, id_cap, edges cut
# off the end): both seeds, a degree-triggered split, no split, an id_cap
# that overflows; the uncut streams (E = 2,496 and 2,482) end in a block
# padded with dead edges, the cut one fills its last block
PASS_CASES = [(5, 0.0, True, None, 0), (6, 0.0, True, None, 0),
              (5, 3.0, True, None, 0), (6, 3.0, True, None, 0),
              (5, 0.0, False, None, 0), (6, 0.0, True, 700, 0),
              (5, 3.0, True, None, 64)]


@pytest.mark.parametrize("seed,sdf,split,id_cap,cut", PASS_CASES)
def test_cluster_pass_matches_reference(seed, sdf, split, id_cap, cut):
    """The K1 pass's plain version (``streaming_clustering(kernel=
    "torch")``: per block the localize, the walk and the write-back of
    ``_block_step``) against ``streaming_clustering_jax`` bit for bit:
    clu, deg, divided, replicas, next_id."""
    g = graphgen.web_graph(scale=9, edge_factor=6, seed=seed)
    E = g.num_edges - cut
    src, dst = g.src[:E], g.dst[:E]
    assert (E % 128 == 0) == (cut != 0)
    vmax = default_vmax(E, 8)
    want = streaming_clustering_jax(src, dst, g.num_vertices, vmax,
                                    allow_split=split,
                                    split_degree_factor=sdf, id_cap=id_cap)
    got = streaming_clustering(_t(src), _t(dst), g.num_vertices, vmax,
                               allow_split=split, split_degree_factor=sdf,
                               id_cap=id_cap, kernel="torch")
    for w, r in zip(want, got):
        np.testing.assert_array_equal(r.numpy(), np.asarray(w))
    if id_cap is not None:
        assert int(got[4]) > id_cap - 2        # the overflow is visible
    if split:
        assert bool(got[2].any())              # some vertex was split


@pytest.fixture(scope="module")
def game_inputs():
    """Cluster graph of a scale-9 stream at k = 8, contracted by the JAX
    package (cross edges padded with the drop sentinel m_cap)."""
    g = graphgen.web_graph(scale=9, edge_factor=6, seed=0)
    k = 8
    vmax = default_vmax(g.num_edges, k)
    clu, *_ = streaming_clustering_jax(g.src, g.dst, g.num_vertices, vmax)
    cap = g.num_vertices + 2 * g.num_edges + 2
    compact, m = compact_labels_jax(clu, cap)
    m_cap = -(-int(m) // 256) * 256
    jg = jax_cga(jnp.asarray(g.src), jnp.asarray(g.dst), compact, m_cap,
                 True)
    lam = np.float32(float(lambda_from_totals(
        _t(np.asarray(jg.sizes)).sum(), _t(np.asarray(jg.n_cross)), k,
        None)))
    return g, k, compact, m_cap, jg, lam


def test_contraction_drops_sentinel_lanes(game_inputs):
    """Counts scattered onto the sentinel m_cap are dropped (an extra
    slot sliced off) and integer-valued f32 sums are exact."""
    g, k, compact, m_cap, jg, _ = game_inputs
    pg = cluster_graph_arrays(_t(g.src), _t(g.dst), _t(compact), m_cap, True)
    for name in ("sizes", "row_tot", "xs", "xd", "n_cross"):
        np.testing.assert_array_equal(getattr(pg, name).numpy(),
                                      np.asarray(getattr(jg, name)))
    assert int((pg.xs == m_cap).sum()) > 0
    # λ from the totals matches the reference's lambda_jax
    from repro.core.stages import lambda_jax
    want = lambda_jax(jg.sizes.sum(), jg.n_cross, k, None)
    got = lambda_from_totals(pg.sizes.sum(), pg.n_cross, k, None)
    assert float(got) == float(want)


@pytest.mark.parametrize("mode,use_pallas", [("torch", False),
                                             ("cuda", True),
                                             ("cuda", False)])
def test_game_rounds_match_reference(game_inputs, mode, use_pallas):
    """Batched Jacobi rounds with the reference's own random draws
    injected (start assignment and per-batch damping masks): assignment
    and round count equal.  No near-tie flip shows up at this size, so
    the comparison is exact, not on Φ.  ``mode="torch"`` is the dense
    per-batch form; ``"cuda"`` the CSR form over each batch's rows (its
    plain version here), against the reference with and without the
    Pallas sweep.  The fixture's 105 clusters fill two of its four
    64-row batches, so the CSR form also skips batches with no live row."""
    g, k, compact, m_cap, jg, lam = game_inputs
    seed, batch = 3, 64
    want, want_rounds = jax_game_rounds(
        jg.xs, jg.xd, jg.sizes, jg.row_tot, k, jnp.float32(lam),
        batch_size=batch, max_rounds=64, seed=seed, use_pallas=use_pallas)
    key = jax.random.PRNGKey(seed)
    assign0 = jax.random.randint(key, (m_cap,), 0, k, dtype=jnp.int32)
    n_batches = -(-m_cap // batch)

    def draw(rnd, b):
        p = jnp.maximum(0.5 * 0.92 ** jnp.float32(rnd), 0.08)
        mask = jax.random.bernoulli(
            jax.random.fold_in(key, rnd * n_batches + b + 1), p, (m_cap,))
        return _t(np.asarray(mask))

    got, rounds = game_rounds(
        _t(np.asarray(jg.xs)), _t(np.asarray(jg.xd)),
        _t(np.asarray(jg.sizes)), _t(np.asarray(jg.row_tot)), k,
        torch.tensor([lam]), batch_size=batch, max_rounds=64, seed=seed,
        mode=mode, assign0=_t(np.asarray(assign0)), draw=draw)
    assert rounds == int(want_rounds) and rounds > 1
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_game_rounds_default_draws_are_seeded(game_inputs):
    g, k, compact, m_cap, jg, lam = game_inputs
    args = [_t(np.asarray(a)) for a in (jg.xs, jg.xd, jg.sizes, jg.row_tot)]
    runs = [game_rounds(*args, k, torch.tensor([lam]), batch_size=6400,
                        max_rounds=64, seed=s, mode="torch") for s in (0, 0, 1)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert not torch.equal(runs[0][0], runs[2][0])


# the game's draws: a numpy uint64 twin of the port's int64 hash, written
# from its definition (32-bit finalizer; golden-ratio row multiplier; the
# seed salted, mixed, xor-ed with the stream, mixed again)
_U32 = np.uint64(0xFFFFFFFF)


def _np_mix32(h):
    h = np.asarray(h, dtype=np.uint64)
    for mul, shift in ((0x7FEB352D, 16), (0x5BD1E995, 15)):
        h = ((h ^ (h >> np.uint64(shift))) * np.uint64(mul)) & _U32
    return h ^ (h >> np.uint64(16))


def _np_base(seed, stream):
    salted = np.uint64((seed ^ 0x9E3779B9) & 0xFFFFFFFF)
    return _np_mix32(_np_mix32(salted) ^ np.uint64(stream & 0xFFFFFFFF))


def _np_draws(seed, stream, rows):
    rows = np.asarray(rows, dtype=np.uint64)
    return _np_mix32((rows * np.uint64(0x61C88647) + _np_base(seed, stream))
                     & _U32)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 40 + 3, -1])
def test_game_hash_matches_a_numpy_uint64_twin(seed):
    """Every product of the int64 hash stays below 2⁶³, so it equals the
    wrap-free uint64 twin bit for bit, up to the largest 32-bit row; its
    first values are pinned."""
    rows = np.array([0, 1, 2, 3, 1000, 2 ** 20, 2 ** 32 - 1])
    for stream in (0, 1, 2623):
        assert G.stream_base(seed, stream) == int(_np_base(seed, stream))
        got = G.hash_draws(G.stream_base(seed, stream), torch.from_numpy(
            rows))
        np.testing.assert_array_equal(got.numpy().astype(np.uint64),
                                      _np_draws(seed, stream, rows))
    if seed == 0:
        assert G.stream_base(0, 0) == 1833843278
        assert G.hash_draws(1833843278, torch.arange(4)).tolist() == [
            775373287, 3067608095, 2304130635, 2781313263]


def test_game_default_draws_follow_the_hash():
    """The start lanes are stream 0 ``% k``; round rnd's damping mask is
    drawn once over all rows, each row on its batch's stream
    ``rnd·n_batches + b + 1``, as the integer compare of its top 24 bits
    against floor(p·2²⁴)."""
    m_cap, k, seed, batch, n_batches = 300, 64, 5, 128, 3
    rows = np.arange(m_cap)
    np.testing.assert_array_equal(
        G.start_assignment(m_cap, k, seed, "cpu").numpy(),
        (_np_draws(seed, 0, rows) % np.uint64(k)).astype(np.int32))
    draw = G.damping_draws(seed, m_cap, batch, n_batches, 64, "cpu")
    for rnd in (0, 1, 40):
        p = max(0.5 * 0.92 ** rnd, 0.08)
        want = np.concatenate([
            (_np_draws(seed, rnd * n_batches + b + 1, rows)
             >> np.uint64(8))[b * batch:(b + 1) * batch]
            < np.uint64(int(p * 2 ** 24)) for b in range(n_batches)])
        masks = [draw(rnd, b) for b in range(n_batches)]
        assert all(m is masks[0] for m in masks)
        np.testing.assert_array_equal(masks[0].numpy(), want)
        assert abs(want.mean() - p) < 0.1


@pytest.mark.parametrize("k", [4, 8])
def test_greedy_assign_matches_reference(game_inputs, k):
    """Stable sort by (-size, id) and first-index load ties: many equal
    sizes (and the zero-size padding) make both matter."""
    *_, jg, _ = game_inputs
    sizes = np.asarray(jg.sizes)
    want = jax_greedy_assign(jnp.asarray(sizes), k)
    got = greedy_assign(_t(sizes), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(sizes)) < len(sizes) // 2
