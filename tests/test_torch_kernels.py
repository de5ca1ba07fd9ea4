"""The port's kernels (K1 cluster scatter, K2 game best response and its
CSR form, K3 ELL SpMV, K4 flash attention, T transform scan and its
tiered emulation) held against the JAX package on the same inputs.

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


def _csr_game_case(m=384, k=16, kpad=128, seed=0):
    """A cluster graph with a hub row (row 7, ~40% of the cross edges),
    rows with a size but no cross edge (200..219) and empty padding rows
    (300..): cross edges as (xs, xd) padded with the sentinel m, as the
    contraction emits them, plus integer sizes, loads and current
    partitions."""
    rng = np.random.default_rng(seed)
    pool = np.setdiff1d(np.arange(300), np.arange(200, 220))
    xs = rng.choice(pool, 3000)
    xd = rng.choice(pool, 3000)
    xd[:1200] = rng.choice(pool[pool != 7], 1200)
    xs[:1200] = 7
    keep = xs != xd
    xs, xd = xs[keep], xd[keep]
    xs = np.concatenate([xs, np.full(50, m)]).astype(np.int32)
    xd = np.concatenate([xd, np.full(50, m)]).astype(np.int32)
    row_tot = (np.bincount(xs, minlength=m + 1)
               + np.bincount(xd, minlength=m + 1))[:m].astype(np.float32)
    sizes = (rng.integers(1, 40, m) + row_tot).astype(np.float32)
    sizes[300:] = 0.0
    assign = rng.integers(0, k, m).astype(np.int32)
    loads = np.zeros(kpad, np.float32)
    np.add.at(loads, assign, sizes)
    return xs, xd, sizes, row_tot, assign, loads, k, kpad


@pytest.mark.parametrize("row0,row1", [(0, 64), (7, 8), (190, 260),
                                       (280, 384), (0, 384)])
def test_game_bestresponse_csr_matches_reference(row0, row1):
    """The CSR form's plain version on a row range against the
    reference's dense scatter (``mode="drop"`` on the sentinel) swept by
    ``ref.game_bestresponse_ref`` and by the Pallas kernel in interpret
    mode, bit for bit on best, cost and the game's cost at the current
    partition; the ranges hold the hub, rows without cross edges and
    empty rows."""
    from repro_torch.core.game import cluster_csr
    xs, xd, sizes, row_tot, assign, loads, k, kpad = _csr_game_case()
    m = sizes.shape[0]
    lam = 2.5
    ja = jnp.asarray(assign)
    aff = (jnp.zeros((m, kpad), jnp.float32)
           .at[xs, ja[jnp.clip(xd, 0, m - 1)]].add(1.0, mode="drop")
           .at[xd, ja[jnp.clip(xs, 0, m - 1)]].add(1.0, mode="drop"))
    args = (aff, jnp.asarray(sizes), jnp.asarray(row_tot), ja,
            jnp.asarray(loads))
    want_b, want_c = jref.game_bestresponse_ref(*args, lam=lam, k=k)
    pal_b, pal_c = jops.game_best_response(*args, lam=lam, k=k, block_m=128,
                                           interpret=True)
    want_cur = (jnp.float32(lam) / jnp.float32(k)) * args[1] * args[4][ja] \
        + 0.5 * (args[2] - aff[jnp.arange(m), ja])
    real = (xs < m) & (xd < m)
    rowptr, col = cluster_csr(_t(xs[real]).long(), _t(xd[real]).long(), m)
    assert int((rowptr[1:] - rowptr[:-1])[7]) > 1000     # the hub
    got_b, got_c, got_cur = ops.game_bestresponse_csr(
        rowptr, col, _t(assign), _t(sizes), _t(row_tot), _t(loads[:k]),
        lam=torch.tensor([lam]), k=k, row0=row0, row1=row1)
    sl = slice(row0, row1)
    for want in (want_b, pal_b):
        np.testing.assert_array_equal(got_b.numpy(), np.asarray(want)[sl])
    for want in (want_c, pal_c):
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want)[sl])
    np.testing.assert_array_equal(got_cur.numpy(), np.asarray(want_cur)[sl])


def test_game_bestresponse_csr_rejects_bad_ranges():
    from repro_torch.kernels.game_bestresponse import CSR_MAX_K
    xs, xd, sizes, row_tot, assign, loads, k, _ = _csr_game_case()
    rowptr = torch.zeros(sizes.shape[0] + 1, dtype=torch.int32)
    col = torch.zeros(0, dtype=torch.int32)
    base = (rowptr, col, _t(assign), _t(sizes), _t(row_tot))
    lam = torch.tensor([1.0])
    for row0, row1 in ((5, 5), (-1, 3), (0, sizes.shape[0] + 1)):
        with pytest.raises(ValueError, match="row range"):
            ops.game_bestresponse_csr(*base, _t(loads[:k]), lam=lam, k=k,
                                      row0=row0, row1=row1)
    big = CSR_MAX_K + 1
    with pytest.raises(ValueError, match="outside"):
        ops.game_bestresponse_csr(*base, torch.zeros(big), lam=lam, k=big,
                                  row0=0, row1=1)


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


# ------------------------------------------------------------------ K4

def _qkv(shape_q, shape_kv, seed, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in (shape_q, shape_kv, shape_kv)]
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" \
        else (jnp.bfloat16, torch.bfloat16)
    return [jnp.asarray(a, jd) for a in arrs], [_t(a, td) for a in arrs]


FLASH_SHAPES = [
    (1, 4, 4, 128, 128, 64),
    (2, 4, 2, 128, 256, 64),
    (1, 8, 1, 256, 256, 128),   # MQA
    (2, 6, 2, 128, 128, 32),    # GQA group 3
]


# causal only on the square shapes, as tests/test_kernels.py's sweep runs
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal", [
    (*s, c) for s in FLASH_SHAPES for c in (True, False)
    if not (c and s[3] != s[4])])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_reference(B, Hq, Hkv, Sq, Skv, D, causal,
                                           dtype):
    """The plain version against the Pallas kernel in interpret mode on
    ``tests/test_kernels.py``'s sweep, at that file's tolerances."""
    (jq, jk, jv), (q, k, v) = _qkv((B, Hq, Sq, D), (B, Hkv, Skv, D), Sq + D,
                                   dtype)
    want = jops.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                block_kv=64, interpret=True)
    got = ops.flash_attention(q, k, v, causal=causal)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ragged_matches_reference(dtype, causal):
    """Sq = Skv = 100, which the Pallas kernel's block asserts refuse but
    the model's prompts need: the plain version against the reference's
    einsum oracle, qwen2-7b's head grouping (group 7)."""
    (jq, jk, jv), (q, k, v) = _qkv((1, 28, 100, 128), (1, 4, 100, 128), 11,
                                   dtype)
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal)
    got = ops.flash_attention_plain(q, k, v, causal=causal, block_kv=32)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_with_kernel_rounding_matches_reference(
        causal):
    """The plain version rounding p to bf16 before P·V over 64-row KV
    blocks, as K4's bf16 path does, against the Pallas kernel in interpret
    mode (p in f32): the rounding stays within the bf16 tolerance, and
    with ``p_dtype=float32`` the plain version is unchanged."""
    (jq, jk, jv), (q, k, v) = _qkv((2, 6, 256, 32), (2, 2, 256, 32), 13,
                                   "bfloat16")
    want = jops.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                block_kv=64, interpret=True)
    got = ops.flash_attention_plain(q, k, v, causal=causal, block_kv=64,
                                    p_dtype=torch.bfloat16)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)
    assert torch.equal(
        ops.flash_attention_plain(q, k, v, causal=causal, block_kv=64,
                                  p_dtype=torch.float32),
        ops.flash_attention_plain(q, k, v, causal=causal, block_kv=64))


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


def _tier_case(name, seed=0):
    """Edge streams built to send the tiered walk through each tier: the
    endpoints' partitions (a, b) are drawn in partition space and mapped
    to four vertices a partition.  Returns (src, dst, vertex_part, deg,
    divided, mask, k, lmax); ``mask`` pads ~8% of the lanes except where
    a case counts loads exactly."""
    from repro_torch.kernels.transform_scan import CHUNK as C
    rng = np.random.default_rng(seed)

    def rand(n, k, zipf=False):
        if zipf:
            return [(rng.zipf(1.5, n) - 1) % k for _ in range(2)]
        return [rng.integers(0, k, n) for _ in range(2)]

    def const(n, p, q):
        return [np.full(n, p), np.full(n, q)]
    exact_from = 0                    # lanes before this are never padded
    if name == "tiny_lmax":           # all 64 fill inside the first chunk
        k, parts, lmax = 64, [rand(3 * C + 100, 64)], 3.0
    elif name == "both_stretch":      # two fills, a both-full chunk whose
        k, lmax = 3, 2000.0           # argmins fill partition 2, then all
        parts = [const(C // 2, 0, 0), const(C // 2, 1, 1),
                 const(C, 0, 1), rand(2000, 3)]
        exact_from = 2 * C
    elif name in ("fill_at_chunk_end", "fill_at_next_chunk"):
        k, lmax = 4, float(C if name == "fill_at_chunk_end" else C + 1)
        parts, exact_from = [const(C + 64, 0, 0), rand(3 * C, 4)], C + 64
    elif name == "k1":
        k, parts, lmax = 1, [rand(2 * C + 7, 1)], float(C)
    elif name == "k200":
        k, parts, lmax = 200, [rand(5 * C, 200)], 1.05 * 5 * C / 200
    else:                             # "k64": skewed, a few late fills
        k, parts = 64, [rand(6 * C + 333, 64, zipf=True)]
        lmax = 1.1 * (6 * C + 333) / 64 * 8
    a = np.concatenate([p[0] for p in parts])
    b = np.concatenate([p[1] for p in parts])
    E = a.shape[0]
    src = (4 * a + rng.integers(0, 4, E)).astype(np.int32)
    dst = (4 * b + rng.integers(0, 4, E)).astype(np.int32)
    vp = np.repeat(np.arange(k), 4).astype(np.int32)
    deg = rng.integers(1, 20, 4 * k).astype(np.int32)
    divided = rng.random(4 * k) < 0.2
    mask = rng.random(E) > 0.08
    mask[:exact_from] = True
    return src, dst, vp, deg, divided, mask, k, lmax


# the tiers each case must reach (beyond agreeing with the reference)
TIER_CASES = {"tiny_lmax": ("exact", "frozen"),
              "both_stretch": ("exact", "redone", "frozen"),
              "fill_at_chunk_end": ("exact", "frozen"),
              "fill_at_next_chunk": ("parallel", "exact"),
              "k1": ("parallel", "exact", "frozen"),
              "k200": ("parallel", "exact"),
              "k64": ("parallel", "exact")}


@pytest.mark.parametrize("name", list(TIER_CASES))
def test_transform_tiered_walk_matches_reference(name):
    """The kernel's tiered walk, emulated on the host with its chunk size
    and tier decisions, against ``transform_jax`` (and the plain walk)
    bit for bit, on streams that reach the tiers the case names."""
    from repro.core.transform import transform_jax
    src, dst, vp, deg, divided, mask, k, lmax = _tier_case(name)
    want = np.asarray(transform_jax(src, dst, vp, deg, divided, k,
                                    mask=mask, lmax=lmax))
    pu, pv, nm = ops.transform_inputs(_t(src).long(), _t(dst).long(),
                                      _t(vp), _t(deg), _t(divided),
                                      _t(mask))
    got, tiers = ops.transform_scan_tiered_plain(pu, pv, nm, k, lmax)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ops.transform_scan(pu, pv, nm, k, lmax).numpy(), want)
    for tier in TIER_CASES[name]:
        assert tiers[tier] > 0, (tier, tiers)
    assert tiers["exact"] <= k + tiers["redone"]


def _seeded_case(start, k, seed=0):
    """A stream of three and a half chunks over four vertices a partition,
    the (k,) loads it starts from and a fractional cap: ``below`` (no
    partition near the cap), ``at`` (some exactly at ceil(cap), so full),
    ``over`` (some past it), ``all`` (every partition full: each edge
    takes the least-loaded partition), ``mixed`` (a spread that fills
    partitions through the stream)."""
    from repro_torch.kernels.transform_scan import CHUNK as C
    rng = np.random.default_rng(seed)
    E = 3 * C + C // 2
    a = (rng.zipf(1.6, E) - 1) % k
    b = rng.integers(0, k, E)
    src = (4 * a + rng.integers(0, 4, E)).astype(np.int32)
    dst = (4 * b + rng.integers(0, 4, E)).astype(np.int32)
    vp = np.repeat(np.arange(k), 4).astype(np.int32)
    deg = rng.integers(1, 20, 4 * k).astype(np.int32)
    divided = rng.random(4 * k) < 0.2
    base = rng.integers(0, 2000, k)
    cap = 1.1 * (base.sum() + E) / k + 0.37
    c = int(np.ceil(cap))
    loads = {"below": base,
             "at": np.where(np.arange(k) % 3 == 0, c, base),
             "over": np.where(np.arange(k) % 4 == 1, c + rng.integers(
                 1, 500, k), base),
             "all": c + rng.integers(0, 50, k),
             "mixed": np.where(base > 1500, c - rng.integers(0, 40, k),
                               base)}[start]
    return src, dst, vp, deg, divided, k, loads.astype(np.int64), cap


@pytest.mark.parametrize("start,k", [("below", 4), ("at", 8), ("over", 8),
                                     ("all", 3), ("mixed", 64),
                                     ("at", 200)])
def test_seeded_walks_match_host_oracle(start, k):
    """The walks from seeded loads (the plain walk, the tiered emulation
    and ``core.transform.transform(loads=, lmax=)``) against the host
    oracle ``transform_np(loads=, lmax=)``, bit for bit, under a
    fractional cap compared as the host compares it."""
    from repro.core.transform import transform_np
    from repro_torch.core.transform import host_exact_cap, transform
    src, dst, vp, deg, divided, k, loads, cap = _seeded_case(start, k)
    want = transform_np(src, dst, vp, deg, divided, k, loads=loads,
                        lmax=cap)
    pu, pv, nm = ops.transform_inputs(_t(src).long(), _t(dst).long(),
                                      _t(vp), _t(deg), _t(divided))
    hcap = host_exact_cap(cap)
    np.testing.assert_array_equal(
        ops.transform_scan_plain(pu, pv, nm, k, hcap, _t(loads)).numpy(),
        want)
    got, tiers = ops.transform_scan_tiered_plain(pu, pv, nm, k, hcap,
                                                 loads)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        transform(_t(src), _t(dst), _t(vp), _t(deg), _t(divided), k,
                  loads=_t(loads), lmax=cap).numpy(), want)
    assert sum(tiers[t] for t in ("parallel", "frozen", "exact")) == 4
    if start == "all":       # every edge is both-full from the start
        assert tiers["both_edges"] == src.shape[0]
    elif start != "below":   # partitions full at the start change choices
        assert tiers["both_edges"] > 0 or tiers["exact"] > 0


def test_seeded_loads_are_checked():
    pu = torch.zeros(8, dtype=torch.int32)
    for bad, msg in ((torch.zeros(3, dtype=torch.int64), "shape"),
                     (torch.tensor([0, -1, 0, 0]), "non-negative"),
                     (torch.tensor([2 ** 31 - 4, 0, 0, 0]), "int32")):
        with pytest.raises(ValueError, match=msg):
            ops.transform_scan(pu, pu, pu, 4, 4.0, bad)
    from repro_torch.core.transform import host_exact_cap
    with pytest.raises(ValueError, match="2\\*\\*24"):
        host_exact_cap(2.0 ** 24 + 0.5)
    assert host_exact_cap(1881.0000000000002) == 1882.0


def test_transform_scan_rejects_k_above_max():
    from repro_torch.kernels.transform_scan import MAX_K
    pu = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        ops.transform_scan(pu, pu, pu, MAX_K + 1, 4.0)
    assert ops.transform_scan(pu, pu, pu, MAX_K, 4.0).shape == (8,)
