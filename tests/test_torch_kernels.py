"""The port's kernels (K1 cluster scatter, K2 game best response, K3 ELL
SpMV, T transform scan) held against the JAX package on the same inputs.

On the CPU every wrapper runs its plain PyTorch version; the reference's
Pallas kernels run in interpret mode, as ``tests/test_kernels.py`` runs
them; ``tests/test_torch_cuda.py`` holds the CUDA kernels against those
plain versions on the card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
    return t if dtype is None else t.to(dtype)


# ------------------------------------------------------------------ K1

def _cluster_block_inputs(seed, B=128):
    """A localized clustering block with realistic slot aliasing (a copy
    of ``tests/test_kernels.py``'s generator, in numpy)."""
    rng = np.random.default_rng(seed)
    lu = rng.integers(0, 2 * B, B).astype(np.int32)
    lv = rng.integers(0, 2 * B, B).astype(np.int32)
    live = (rng.random(B) > 0.1).astype(np.int32)
    lv = np.where(live == 1, lv, lu)          # dead lanes alias u == v
    ints = np.stack([lu, lv, live], 1)
    buf = np.full(10 * B, -1, np.int32)
    buf[2 * B:4 * B] = rng.integers(0, 6, 2 * B)
    buf[4 * B:10 * B] = 0
    pre = rng.choice(2 * B, 2 * B // 3, replace=False)
    cl = rng.integers(2 * B, 2 * B + 16, pre.size)
    buf[pre] = cl
    np.add.at(buf, 2 * B + cl, rng.integers(1, 8, pre.size))
    scal = np.array([16, 0, pre.size, int(buf[2*B:4*B].sum())], np.int32)
    return ints, buf, scal


@pytest.mark.parametrize("seed,sdf,split,vmax", [
    (0, 0.0, True, 12.5), (1, 0.0, True, 12.5), (2, 0.0, True, 12.5),
    (0, 4.0, True, 12.5), (1, 4.0, True, 12.5), (2, 4.0, True, 12.5),
    (7, 0.0, False, 9.0)])
def test_cluster_scatter_matches_reference(seed, sdf, split, vmax):
    ints, buf, scal = _cluster_block_inputs(seed)
    want = jops.cluster_scatter(jnp.asarray(ints), jnp.asarray(buf),
                                jnp.asarray(scal), vmax, allow_split=split,
                                split_degree_factor=sdf, interpret=True)
    got = ops.cluster_scatter(_t(ints), _t(buf), _t(scal), vmax,
                              allow_split=split, split_degree_factor=sdf)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


# ------------------------------------------------------------------ K2

@pytest.mark.parametrize("M,kpad,k", [(256, 128, 16), (512, 128, 128),
                                      (256, 256, 200)])
def test_game_bestresponse_matches_reference(M, kpad, k):
    rng = np.random.default_rng(0)
    aff = (rng.random((M, kpad)) * 10).astype(np.float32)
    sizes = rng.integers(1, 50, M).astype(np.float32)
    row_tot = (aff.sum(1) + rng.random(M)).astype(np.float32)
    cur = rng.integers(0, k, M).astype(np.int32)
    loads = (rng.random(kpad) * 100).astype(np.float32)
    want_b, want_c = jops.game_best_response(
        jnp.asarray(aff), jnp.asarray(sizes), jnp.asarray(row_tot),
        jnp.asarray(cur), jnp.asarray(loads), lam=2.5, k=k, block_m=128,
        interpret=True)
    got_b, got_c = ops.game_bestresponse(
        _t(aff), _t(sizes), _t(row_tot), _t(cur), _t(loads),
        lam=torch.tensor([2.5]), k=k)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-6)


def test_game_bestresponse_ties_take_first_index():
    """Integer-valued tables tie often: both take the first minimum."""
    M, kpad, k = 256, 128, 8
    rng = np.random.default_rng(5)
    aff = rng.integers(0, 3, (M, kpad)).astype(np.float32)
    sizes = np.ones(M, np.float32)
    row_tot = aff[:, :k].sum(1).astype(np.float32)
    cur = rng.integers(0, k, M).astype(np.int32)
    loads = np.full(kpad, 4.0, np.float32)
    want_b, _ = jref.game_bestresponse_ref(
        jnp.asarray(aff), jnp.asarray(sizes), jnp.asarray(row_tot),
        jnp.asarray(cur), jnp.asarray(loads), lam=1.0, k=k)
    got_b, _ = ops.game_bestresponse(_t(aff), _t(sizes), _t(row_tot),
                                     _t(cur), _t(loads),
                                     lam=torch.tensor([1.0]), k=k)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))


# ------------------------------------------------------------------ K3

@pytest.mark.parametrize("R,W,N", [(256, 8, 300), (512, 16, 1000),
                                   (256, 1, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ell_spmv_matches_reference(R, W, N, dtype):
    rng = np.random.default_rng(0)
    vals = rng.random((R, W)).astype(np.float32)
    cols = rng.integers(0, N, (R, W)).astype(np.int32)
    x = rng.random(N).astype(np.float32)
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" \
        else (jnp.bfloat16, torch.bfloat16)
    want = jref.ell_spmv_ref(jnp.asarray(vals, jd), jnp.asarray(cols),
                             jnp.asarray(x, jd))
    got = ops.ell_spmv(_t(vals, td), _t(cols), _t(x, td))
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def test_row_split_ell_splits_hubs():
    """A hub's in-edges spread over ⌈indeg/W⌉ rows; the row sums fold
    back into exactly the per-destination sums."""
    rng = np.random.default_rng(2)
    dst = np.concatenate([np.zeros(100, np.int64), rng.integers(1, 50, 200)])
    src = rng.integers(0, 60, dst.shape[0])
    x = rng.random(61).astype(np.float32)
    x[60] = 0.0
    ell = ops.row_split_ell(dst, src, np.ones(dst.shape[0]), 50,
                            pad_col=60, device="cpu")
    W = ell.width
    assert W in (1, 2, 4, 8, 16, 32) and ell.vals.shape[1] == W
    assert int((ell.row_slot == 0).sum()) == -(-100 // W)
    assert ell.vals.shape[0] < 100 + 200          # no row padded to 100
    want = np.bincount(dst, weights=x[src], minlength=50)
    np.testing.assert_allclose(ell.spmv(_t(x)).numpy(), want, rtol=1e-5)


# ------------------------------------------------------------------- T

def _transform_case(seed, E=3000, V=400, k=8):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, V, E).astype(np.int32)
    dst = (rng.zipf(1.6, E) % V).astype(np.int32)
    vp = rng.integers(0, k, V).astype(np.int32)
    vp[:3] = 0                                 # a crowded partition
    deg = rng.integers(1, 20, V).astype(np.int32)
    divided = rng.random(V) < 0.2
    mask = rng.random(E) > 0.15
    return src, dst, vp, deg, divided, mask, k


@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("tau", [1.0, 1.1])
def test_transform_matches_reference(use_mask, tau):
    from repro.core.transform import transform_jax
    from repro_torch.core.transform import transform
    src, dst, vp, deg, divided, mask, k = _transform_case(3)
    want = transform_jax(src, dst, vp, deg, divided, k, tau,
                         mask=mask if use_mask else None)
    got = transform(_t(src), _t(dst), _t(vp), _t(deg), _t(divided), k, tau,
                    mask=_t(mask) if use_mask else None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the crowded partition fills up, so the cap and the least-loaded
    # fallback (first index on ties) decide part of the stream
    live = got.numpy()[mask] if use_mask else got.numpy()
    loads = np.bincount(live, minlength=k)
    assert loads.max() <= int(np.ceil(tau * src.shape[0] / k)) + 1
    assert loads[0] >= int(tau * src.shape[0] / k)


@pytest.mark.parametrize("use_mask", [False, True])
def test_majority_vertex_map_matches_reference(use_mask):
    from repro.core.transform import majority_vertex_map_jax
    from repro_torch.core.transform import majority_vertex_map
    src, dst, vp, deg, divided, mask, k = _transform_case(4)
    assign = np.random.default_rng(9).integers(0, k, src.shape[0]) \
        .astype(np.int32)
    m = mask if use_mask else None
    want = majority_vertex_map_jax(src, dst, assign, 400, k, mask=m)
    got = majority_vertex_map(_t(src), _t(dst), _t(assign), 400, k,
                              mask=None if m is None else _t(m))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
