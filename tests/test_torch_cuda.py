"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Every test here needs an NVIDIA GPU and skips without one (the
kernels have no CPU or interpret mode); this file imports nothing of JAX,
so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU or "
                    "interpret mode")
    return torch.device("cuda")


def _block(seed, B=128):
    rng = np.random.default_rng(seed)
    lu = rng.integers(0, 2 * B, B).astype(np.int32)
    lv = rng.integers(0, 2 * B, B).astype(np.int32)
    live = (rng.random(B) > 0.1).astype(np.int32)
    lv = np.where(live == 1, lv, lu)
    buf = np.full(10 * B, -1, np.int32)
    buf[2 * B:4 * B] = rng.integers(0, 6, 2 * B)
    buf[4 * B:] = 0
    pre = rng.choice(2 * B, 2 * B // 3, replace=False)
    cl = rng.integers(2 * B, 2 * B + 16, pre.size)
    buf[pre] = cl
    np.add.at(buf, 2 * B + cl, rng.integers(1, 8, pre.size))
    scal = np.array([16, 0, pre.size, int(buf[2*B:4*B].sum())], np.int32)
    return (torch.from_numpy(np.stack([lu, lv, live], 1).copy()),
            torch.from_numpy(buf), torch.from_numpy(scal))


@pytest.mark.cuda
@pytest.mark.parametrize("seed,sdf,split", [(0, 0.0, True), (1, 4.0, True),
                                            (2, 0.0, False)])
def test_cluster_scatter_on_card(dev, seed, sdf, split):
    ints, buf, scal = _block(seed)
    got = ops.cluster_scatter(ints.to(dev), buf.to(dev), scal.to(dev), 12.5,
                              allow_split=split, split_degree_factor=sdf)
    want = ops.cluster_scatter_plain(ints, buf, scal, 12.5,
                                     allow_split=split,
                                     split_degree_factor=sdf)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


# the CPU test's cases (tests/test_torch_core.py): web_graph seed,
# split_degree_factor, allow_split, id_cap (700 overflows), edges cut off
# the end (64 fills the last block; the others end in a padded block)
PASS_CASES = [(5, 0.0, True, None, 0), (6, 0.0, True, None, 0),
              (5, 3.0, True, None, 0), (6, 3.0, True, None, 0),
              (5, 0.0, False, None, 0), (6, 0.0, True, 700, 0),
              (5, 3.0, True, None, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("seed,sdf,split,id_cap,cut", PASS_CASES)
def test_cluster_pass_on_card(dev, seed, sdf, split, id_cap, cut):
    """The K1 pass (one launch over the whole stream) against its plain
    version on the same localized blocks: clu, deg, vol, scal and packed
    bit for bit, and the whole clustering through both."""
    from repro_torch.core import web_graph
    from repro_torch.core.clustering import (default_vmax, localize_stream,
                                             streaming_clustering)
    g = web_graph(scale=9, edge_factor=6, seed=seed)
    E, V = g.num_edges - cut, g.num_vertices
    src = torch.from_numpy(g.src[:E]).to(dev)
    dst = torch.from_numpy(g.dst[:E]).to(dev)
    vmax = default_vmax(E, 8)
    cap = id_cap or V + 2 * E + 2
    ints, uvg = localize_stream(src, dst, V)
    state = []
    for run in (ops.cluster_pass, ops.cluster_pass_plain):
        clu = torch.full((V + 1,), -1, dtype=torch.int32, device=dev)
        deg = torch.zeros(V + 1, dtype=torch.int32, device=dev)
        vol = torch.zeros(cap, dtype=torch.int32, device=dev)
        scal = torch.zeros(4, dtype=torch.int32, device=dev)
        ops.reset_launch_counts()
        packed = run(ints, uvg, clu, deg, vol, scal, vmax, allow_split=split,
                     split_degree_factor=sdf)
        state.append((clu, deg, vol, scal, packed))
        if run is ops.cluster_pass:
            assert ops.launch_counts() == {"cluster_scatter": 1}
    for a, b in zip(*state):
        assert torch.equal(a, b)
    a = streaming_clustering(src, dst, V, vmax, allow_split=split,
                             split_degree_factor=sdf, id_cap=id_cap)
    b = streaming_clustering(src, dst, V, vmax, allow_split=split,
                             split_degree_factor=sdf, id_cap=id_cap,
                             kernel="torch")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("M,kpad,k", [(512, 128, 64), (256, 256, 200)])
def test_game_bestresponse_on_card(dev, M, kpad, k):
    gen = torch.Generator(device=dev).manual_seed(0)
    aff = torch.randint(0, 4, (M, kpad), generator=gen, device=dev).float()
    sizes = torch.randint(1, 50, (M,), generator=gen, device=dev).float()
    rt = aff.sum(1) + 1.0
    cur = torch.randint(0, k, (M,), generator=gen, device=dev,
                        dtype=torch.int32)
    loads = torch.rand(kpad, generator=gen, device=dev) * 100
    lam = torch.tensor([2.5], device=dev)
    kb, kc = ops.game_bestresponse(aff, sizes, rt, cur, loads, lam=lam, k=k)
    pb, pc = ops.game_bestresponse_plain(aff, sizes, rt, cur, loads,
                                         lam=lam, k=k)
    assert torch.equal(kb, pb) and torch.equal(kc, pc)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ell_spmv_on_card(dev, dtype):
    vals = torch.rand(1024, 8, device=dev).to(dtype)
    cols = torch.randint(0, 500, (1024, 8), device=dev, dtype=torch.int32)
    x = torch.rand(500, device=dev).to(dtype)
    torch.testing.assert_close(ops.ell_spmv(vals, cols, x),
                               ops.ell_spmv_plain(vals, cols, x),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_transform_scan_on_card(dev):
    rng = np.random.default_rng(3)
    E, V, k = 20000, 800, 8
    src = torch.from_numpy(rng.integers(0, V, E))
    dst = torch.from_numpy(rng.zipf(1.6, E) % V)
    vp = torch.from_numpy(rng.integers(0, k, V).astype(np.int32))
    vp[:3] = 0
    deg = torch.from_numpy(rng.integers(1, 20, V).astype(np.int32))
    divided = torch.from_numpy(rng.random(V) < 0.2)
    live = torch.from_numpy(rng.random(E) > 0.1)
    pu, pv, nm = ops.transform_inputs(src, dst, vp, deg, divided, live)
    got = ops.transform_scan(pu.to(dev), pv.to(dev), nm.to(dev), k,
                             1.1 * E / k)
    assert torch.equal(got.cpu(),
                       ops.transform_scan_plain(pu, pv, nm, k, 1.1 * E / k))


def _tier_stream(name, seed=0):
    """(pu, pv, normal, k, lmax) of tests/test_torch_kernels.py's
    ``_tier_case`` streams (the same builder in partition space, without
    JAX): each reaches the tiers that file names for it."""
    from repro_torch.kernels.transform_scan import CHUNK as C
    rng = np.random.default_rng(seed)

    def rand(n, k, zipf=False):
        if zipf:
            return [(rng.zipf(1.5, n) - 1) % k for _ in range(2)]
        return [rng.integers(0, k, n) for _ in range(2)]

    def const(n, p, q):
        return [np.full(n, p), np.full(n, q)]
    exact_from = 0
    if name == "tiny_lmax":
        k, parts, lmax = 64, [rand(3 * C + 100, 64)], 3.0
    elif name == "both_stretch":
        k, lmax = 3, 2000.0
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
    else:
        k, parts = 64, [rand(6 * C + 333, 64, zipf=True)]
        lmax = 1.1 * (6 * C + 333) / 64 * 8
    a = np.concatenate([p[0] for p in parts])
    b = np.concatenate([p[1] for p in parts])
    E = a.shape[0]
    src = torch.from_numpy(4 * a + rng.integers(0, 4, E))
    dst = torch.from_numpy(4 * b + rng.integers(0, 4, E))
    vp = torch.from_numpy(np.repeat(np.arange(k), 4).astype(np.int32))
    deg = torch.from_numpy(rng.integers(1, 20, 4 * k).astype(np.int32))
    divided = torch.from_numpy(rng.random(4 * k) < 0.2)
    mask = rng.random(E) > 0.08
    mask[:exact_from] = True
    pu, pv, nm = ops.transform_inputs(src, dst, vp, deg, divided,
                                      torch.from_numpy(mask))
    return pu, pv, nm, k, lmax


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tiny_lmax", "both_stretch",
                                  "fill_at_chunk_end", "fill_at_next_chunk",
                                  "k1", "k200", "k64"])
def test_transform_tiers_on_card(dev, name):
    """T's tiered kernel against the plain walk bit for bit, and its tier
    counts against the host emulation's, on streams built to reach every
    tier (early and late fills, several fills in one chunk, a fill on a
    chunk boundary, both-full stretches, a frozen walk redone, padding
    lanes, k = 1, 3, 4, 64, 200)."""
    pu, pv, nm, k, lmax = _tier_stream(name)
    got, tiers = ops.transform_scan_tiers(pu.to(dev), pv.to(dev), nm.to(dev),
                                          k, lmax)
    want, want_tiers = ops.transform_scan_tiered_plain(pu, pv, nm, k, lmax)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(want, ops.transform_scan_plain(pu, pv, nm, k, lmax))
    assert tiers == want_tiers


def _seeded_stream(start, k, seed=0):
    """(pu, pv, normal, k, loads0, cap) of tests/test_torch_kernels.py's
    ``_seeded_case`` streams (the same generator, without JAX): loads that
    start below, at, over or all at the cap, or mixed."""
    from repro_torch.kernels.transform_scan import CHUNK as C
    rng = np.random.default_rng(seed)
    E = 3 * C + C // 2
    a = (rng.zipf(1.6, E) - 1) % k
    b = rng.integers(0, k, E)
    src = torch.from_numpy(4 * a + rng.integers(0, 4, E))
    dst = torch.from_numpy(4 * b + rng.integers(0, 4, E))
    vp = torch.from_numpy(np.repeat(np.arange(k), 4).astype(np.int32))
    deg = torch.from_numpy(rng.integers(1, 20, 4 * k).astype(np.int32))
    divided = torch.from_numpy(rng.random(4 * k) < 0.2)
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
    pu, pv, nm = ops.transform_inputs(src, dst, vp, deg, divided)
    return pu, pv, nm, k, torch.from_numpy(loads.astype(np.int64)), cap


@pytest.mark.cuda
@pytest.mark.parametrize("start,k", [("below", 4), ("at", 8), ("over", 8),
                                     ("all", 3), ("mixed", 64),
                                     ("at", 200)])
def test_transform_seeded_on_card(dev, start, k):
    """T from seeded loads (``loads0``) against the plain walk bit for
    bit, and its tier counts against the host emulation's, under the
    host-exact cap; without ``loads0`` it equals the zero-load walk."""
    from repro_torch.core.transform import host_exact_cap
    pu, pv, nm, k, loads, cap = _seeded_stream(start, k)
    hcap = host_exact_cap(cap)
    got, tiers = ops.transform_scan_tiers(pu.to(dev), pv.to(dev), nm.to(dev),
                                          k, hcap, loads.to(dev))
    want, want_tiers = ops.transform_scan_tiered_plain(pu, pv, nm, k, hcap,
                                                       loads)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(want, ops.transform_scan_plain(pu, pv, nm, k, hcap,
                                                      loads))
    assert tiers == want_tiers
    zero = ops.transform_scan(pu.to(dev), pv.to(dev), nm.to(dev), k, hcap)
    assert torch.equal(zero.cpu(),
                       ops.transform_scan_plain(pu, pv, nm, k, hcap))


@pytest.mark.cuda
def test_graph_server_on_card_matches_cpu(dev, tmp_path):
    """A short GraphServer run at scale 12 on the card and on the CPU from
    the same assignment: replies agree (integers equal, pagerank within
    rtol 1e-5), each window and restream assigns the same edges, the RF
    trace and stats are equal, T launches once a flush plus twice a
    restream, and a checkpoint resumes on the card."""
    from repro_torch.core import CLUGPConfig, web_graph
    from repro_torch.dist.ft import ServiceFT
    from repro_torch.launch.serve_graph import replies_agree
    from repro_torch.serve import GraphServer
    from repro_torch.session import GraphSession, SessionConfig
    g = web_graph(scale=12, seed=0)
    cfg = SessionConfig(clugp=CLUGPConfig.optimized(8, restream=1),
                        exchange="halo", iters=20)
    card = GraphSession(cfg, device=dev).partition(g.src, g.dst,
                                                   g.num_vertices)
    cpu = GraphSession(cfg, device="cpu").with_partition(
        g.src, g.dst, g.num_vertices, card.assign)
    kw = dict(max_batch=8, window=1024, rf_watermark=1.01,
              restream_passes=2)
    servers = [GraphServer(s.layout(), **kw) for s in (card, cpu)]
    rng = np.random.default_rng(2)
    arrivals = [(rng.integers(0, g.num_vertices, 256),
                 rng.integers(0, g.num_vertices, 256)) for _ in range(8)]
    replies, launches = [], []
    for srv in servers:
        ops.reset_launch_counts()
        got = []
        for phase in range(2):
            ts = [srv.submit("score", program=p, vertices=[0, 5, 99])
                  for p in ("pagerank", "degree", "cc", "labelprop")]
            ts += [srv.submit("owner", vertices=[0, 5, 99]),
                   srv.submit("neighbors", vertices=[5])]
            srv.serve_pending()
            got.append([srv.result(t).value for t in ts])
            if phase == 0:
                for s, d in arrivals:
                    srv.ingest(s, d)
        replies.append(got)
        launches.append(ops.launch_counts())
    card_srv, cpu_srv = servers
    st = card_srv.stats
    assert launches[0]["transform_scan"] == st["windows"] + 2 * st["restreams"]
    assert launches[0]["ell_spmv"] > 0
    assert launches[1] == {}                   # the CPU run launches nothing
    for a, b in zip(*replies):
        for x, y in zip(a[:5], b[:5]):
            assert replies_agree(x, y, None)
        assert np.array_equal(a[5][0], b[5][0])
    assert card_srv.stats == cpu_srv.stats and card_srv.stats["restreams"]
    assert card_srv.rf_trace == cpu_srv.rf_trace
    assert np.array_equal(card_srv.sess.assign, cpu_srv.sess.assign)
    card_srv.ft = ServiceFT(tmp_path)
    card_srv.checkpoint()
    resumed = GraphServer.resume(ServiceFT(tmp_path), device=dev)
    assert resumed.sess.device.type == "cuda"
    assert np.array_equal(resumed.sess.assign, card_srv.sess.assign)


@pytest.mark.cuda
def test_transform_scan_scale16_on_card(dev):
    """T on a scale-16 web graph's transform inputs (a random prior, the
    optimized profile's cap τ = 1.1) against the plain walk."""
    from repro_torch.core import web_graph
    g = web_graph(scale=16, edge_factor=8, seed=0)
    k = 64
    rng = np.random.default_rng(1)
    vp = torch.from_numpy(rng.integers(0, k, g.num_vertices).astype(np.int32))
    deg = torch.from_numpy(np.bincount(g.src, minlength=g.num_vertices)
                           + np.bincount(g.dst, minlength=g.num_vertices)
                           ).to(torch.int32)
    divided = torch.from_numpy(rng.random(g.num_vertices) < 0.05)
    pu, pv, nm = ops.transform_inputs(torch.from_numpy(g.src).long(),
                                      torch.from_numpy(g.dst).long(), vp,
                                      deg, divided)
    lmax = 1.1 * g.num_edges / k
    got, tiers = ops.transform_scan_tiers(pu.to(dev), pv.to(dev), nm.to(dev),
                                          k, lmax)
    want, want_tiers = ops.transform_scan_tiered_plain(pu, pv, nm, k, lmax)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(want, ops.transform_scan_plain(pu, pv, nm, k, lmax))
    assert tiers == want_tiers
    print(tiers)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 64, 200])
def test_game_bestresponse_csr_on_card(dev, k):
    """The fused K2 against its plain version on a skewed cluster graph
    (a hub row, rows without cross edges, empty rows), over batch-sized
    row ranges: best, cost and the game's current cost bit for bit."""
    from repro_torch.core.game import cluster_csr
    rng = np.random.default_rng(k)
    m = 3000
    xs = rng.integers(0, 2500, 40000)
    xd = (rng.zipf(1.3, 40000) - 1) % 2500     # row 0 is the hub
    keep = xs != xd
    xs = torch.from_numpy(xs[keep]).to(dev)
    xd = torch.from_numpy(xd[keep]).to(dev)
    rowptr, col = cluster_csr(xs, xd, m)
    row_tot = (rowptr[1:] - rowptr[:-1]).float()
    sizes = row_tot + torch.from_numpy(rng.integers(0, 30, m)).to(dev)
    sizes[2800:] = 0.0
    assign = torch.from_numpy(rng.integers(0, k, m).astype(np.int32)).to(dev)
    loads = torch.zeros(k, device=dev).index_add_(0, assign.long(), sizes)
    lam = torch.tensor([0.37], device=dev)
    assert int(row_tot[0]) > 5000
    for row0, row1 in ((0, 640), (640, 1280), (2400, 3000), (0, 1), (5, 7)):
        ops.reset_launch_counts()
        got = ops.game_bestresponse_csr(rowptr, col, assign, sizes, row_tot,
                                        loads, lam=lam, k=k, row0=row0,
                                        row1=row1)
        assert ops.launch_counts() == {"game_bestresponse_csr": 1}
        want = ops.game_bestresponse_csr_plain(rowptr, col, assign, sizes,
                                               row_tot, loads, lam=lam, k=k,
                                               row0=row0, row1=row1)
        for g_, w_ in zip(got, want):
            assert torch.equal(g_, w_)


@pytest.mark.cuda
def test_partition_kernel_path_matches_plain_path(dev):
    """The whole game-off pipeline on the card: kernels vs plain."""
    from repro_torch.core import CLUGPConfig, partition, web_graph
    g = web_graph(scale=10, edge_factor=6, seed=2)
    out = {}
    for mode in ("cuda", "torch"):
        cfg = CLUGPConfig.optimized(8, restream=1, game=False, kernel=mode,
                                    cluster_kernel=mode)
        out[mode] = partition(g.src, g.dst, g.num_vertices, cfg, device=dev)
    np.testing.assert_array_equal(out["cuda"].assign, out["torch"].assign)


@pytest.mark.cuda
def test_partition_with_game_kernel_path_matches_plain_path(dev):
    """The whole pipeline with the game on the card: the CSR game on the
    fused K2 and T's tiered walk against the dense plain game and the
    plain walk, the same seeded draws on both (assignment and rounds)."""
    from repro_torch.core import CLUGPConfig, partition, web_graph
    g = web_graph(scale=12, edge_factor=6, seed=2)
    out = {}
    for mode in ("cuda", "torch"):
        cfg = CLUGPConfig.optimized(16, restream=1, batch_size=256,
                                    kernel=mode, cluster_kernel=mode)
        ops.reset_launch_counts()
        out[mode] = partition(g.src, g.dst, g.num_vertices, cfg, device=dev)
        if mode == "cuda":
            launched = ops.launch_counts()
            assert launched["game_bestresponse_csr"] > 0
            assert "game_bestresponse" not in launched
    assert out["cuda"].game_rounds == out["torch"].game_rounds > 1
    np.testing.assert_array_equal(out["cuda"].cluster_assign,
                                  out["torch"].cluster_assign)
    np.testing.assert_array_equal(out["cuda"].assign, out["torch"].assign)


# the shapes of tests/test_kernels.py's flash sweep, then qwen2-7b's heads
# (Hq = 28, Hkv = 4: group 7) at a ragged length
FLASH_SHAPES = [(1, 4, 4, 128, 128, 64), (2, 4, 2, 128, 256, 64),
                (1, 8, 1, 256, 256, 128), (2, 6, 2, 128, 128, 32),
                (1, 28, 4, 300, 300, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal", [
    (*s, c) for s in FLASH_SHAPES for c in (True, False)
    if not (c and s[3] != s[4])])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_on_card(dev, B, Hq, Hkv, Sq, Skv, D, causal, dtype):
    """K4 against its plain version: 2e-5 in f32 (no TF32 on either side),
    2e-2 in bf16 (the kernel rounds p to bf16 before P·V)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(Sq + D)
    q = torch.randn(B, Hq, Sq, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Hkv, Skv, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Hkv, Skv, D, generator=gen, device=dev).to(dtype)
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = ops.flash_attention_plain(q, k, v, causal=causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Skv", [(100, 100), (300, 300), (100, 300),
                                    (300, 100)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_attention_bf16_ragged_gqa(dev, D, causal, Sq, Skv):
    """The bf16 kernel (wgmma, TMA) at every head dim on qwen2-7b's head
    split (28/4) and lengths that are no multiple of its 128-row tiles:
    2e-2 against the plain version."""
    gen = torch.Generator(device=dev).manual_seed(Sq * 7 + Skv + D)
    q = torch.randn(2, 28, Sq, D, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k, v = torch.randn(2, 2, 4, Skv, D, generator=gen, device=dev,
                       dtype=torch.bfloat16)
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = ops.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_attention_bf16_strided_views_match_contiguous(dev, D):
    """(B, S, H, D) activations as transposed views: the tensor maps read
    them through their strides, with the same result as contiguous
    copies, bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(D)
    q = torch.randn(3, 200, 28, D, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    kv = torch.randn(3, 200, 2, 4, D, generator=gen, device=dev,
                     dtype=torch.bfloat16)
    qt, kt, vt = (q.transpose(1, 2), kv[:, :, 0].transpose(1, 2),
                  kv[:, :, 1].transpose(1, 2))
    got = ops.flash_attention(qt, kt, vt, causal=True)
    want = ops.flash_attention(qt.contiguous(), kt.contiguous(),
                               vt.contiguous(), causal=True)
    assert torch.equal(got, want)
    torch.testing.assert_close(
        got.float(), ops.flash_attention_plain(qt, kt, vt).float(),
        rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_flash_attention_reads_strided_views(dev):
    """The model passes (B, S, H, D) activations as transposed views; the
    output keeps that layout."""
    gen = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn(2, 77, 28, 128, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    kv = torch.randn(2, 2, 77, 4, 128, generator=gen, device=dev,
                     dtype=torch.bfloat16)
    qt, kt, vt = q.transpose(1, 2), kv[0].transpose(1, 2), kv[1].transpose(1, 2)
    got = ops.flash_attention(qt, kt, vt, causal=True)
    assert got.transpose(1, 2).is_contiguous()
    want = ops.flash_attention(qt.contiguous(), kt.contiguous(),
                               vt.contiguous(), causal=True)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_flash_attention_refuses_what_it_does_not_take(dev):
    q = torch.zeros(1, 4, 16, 48, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, q, q)
    q = torch.zeros(1, 4, 16, 64, device=dev)
    with pytest.raises(ValueError, match="share"):
        ops.flash_attention(q, q.half(), q.half())


def _params_to(tree, device, dtype):
    """A parameter tree on ``device``, its matrices in ``dtype``."""
    if isinstance(tree, dict):
        return {k: _params_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_params_to(v, device, dtype) for v in tree]
    return tree.to(device, dtype if tree.dim() >= 2 else tree.dtype)


def _rel_l2(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reduced_qwen2_prefill_on_card_matches_cpu(dev, dtype, monkeypatch):
    """The reduced qwen2-7b prefill on the card (K4, cuBLAS without TF32)
    against the same on the CPU, same weights, last logits elementwise:
    1e-4 in f32, 2e-2 in bf16 (the kernel tests' bf16 tolerance).  In
    bf16 K4 rounds p to bf16 before P·V, which moves these logits by about
    1e-2 relative L2, so the CPU's attention rounds p the same way (its
    plain version over 128-row KV blocks, the kernel's running max).  The
    readings are printed: the drift against the CPU with p in f32, and
    with the plain version in K4's place on the card."""
    from functools import partial

    from repro_torch.configs import get_config
    from repro_torch.models import init_params, lm, prefill

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen2_7b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 100)))

    def run(device, attention=None):
        if attention is not None:
            monkeypatch.setattr(lm, "flash_attention", attention)
        out, _ = prefill(_params_to(params, device, dtype),
                         {"tokens": toks.to(device)}, cfg, dtype=dtype)
        monkeypatch.undo()
        return out.float().cpu()

    ops.reset_launch_counts()
    got = run(dev)
    assert ops.launch_counts().get("flash_attention") == cfg.n_layers
    assert torch.isfinite(got).all()
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    want = run("cpu", partial(ops.flash_attention_plain, block_kv=128,
                              p_dtype=torch.bfloat16)
               if dtype == torch.bfloat16 else None)
    line = (f"{dtype}: card vs cpu max |d| {float((got - want).abs().max()):.4e}"
            f" rel L2 {_rel_l2(got, want):.4e}")
    if dtype == torch.bfloat16:
        cpu = run("cpu")
        line += (f"; with p in f32 on the cpu: rel L2 {_rel_l2(got, cpu):.4e}; "
                 f"plain in K4's place on the card: rel L2 "
                 f"{_rel_l2(run(dev, ops.flash_attention_plain), cpu):.4e}")
    print(line)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def gas_layout():
    """A scale-14 web graph under a seeded random assignment, k = 16 (the
    layout is host numpy; each test moves its tables to its device)."""
    from repro_torch.core import web_graph
    from repro_torch.graph import build_layout
    g = web_graph(scale=14, edge_factor=8, seed=0)
    assign = np.random.default_rng(0).integers(0, 16, g.num_edges) \
        .astype(np.int32)
    return g, build_layout(g.src, g.dst, assign, g.num_vertices, 16)


GAS_ITERS = {"pagerank": 30, "cc": 40, "labelprop": 40, "sssp": 40,
             "bfs": 40, "degree": 1, "centrality": 30, "ppr": 30}
K3_PROGRAMS = ("pagerank", "ppr", "centrality")


@pytest.mark.cuda
@pytest.mark.parametrize("exchange", ("dense", "halo"))
@pytest.mark.parametrize("name", tuple(GAS_ITERS))
def test_gas_program_on_card_matches_cpu(dev, gas_layout, name, exchange):
    """Every GAS program on the card against its plain run on the CPU:
    the integer programs bit for bit (min and integer sums are exact in
    any order), the f32 ones (K3 and float atomics) within rtol 1e-5.
    K3 launches once an iteration for the programs that gather on it and
    never for the others."""
    from repro_torch.graph import get_program, simulate_gas
    g, lay = gas_layout
    prog = get_program(name, g.num_vertices)
    ops.reset_launch_counts()
    got = simulate_gas(prog, lay, GAS_ITERS[name], exchange=exchange,
                       device=dev)
    launched = ops.launch_counts()
    want = simulate_gas(prog, lay, GAS_ITERS[name], exchange=exchange,
                        device="cpu")
    k3 = GAS_ITERS[name] if name in K3_PROGRAMS else 0
    assert launched.get("ell_spmv", 0) == k3
    assert not {n for n, c in launched.items() if c} - {"ell_spmv"}
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("exchange", ("dense", "halo"))
def test_gas_fused_bundles_on_card_match_cpu(dev, gas_layout, exchange):
    """The fused bundles on the card against the CPU, with early exit:
    the i32 bundle to its fixed point bit for bit (the same iteration
    count), the f32 bundle 30 iterations within rtol 1e-5 with K3 launched
    three times an iteration."""
    from repro_torch.graph import get_program, simulate_gas_many
    g, lay = gas_layout
    i32 = [get_program(p, g.num_vertices)
           for p in ("cc", "labelprop", "sssp", "bfs")]
    got, git = simulate_gas_many(i32, lay, 200, exchange=exchange, tol=0.0,
                                 return_iters=True, device=dev)
    want, wit = simulate_gas_many(i32, lay, 200, exchange=exchange, tol=0.0,
                                  return_iters=True, device="cpu")
    assert git == wit < 200
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    f32 = [get_program(p, g.num_vertices) for p in K3_PROGRAMS]
    ops.reset_launch_counts()
    got = simulate_gas_many(f32, lay, 30, exchange=exchange, device=dev)
    assert ops.launch_counts().get("ell_spmv") == 30 * len(f32)
    want = simulate_gas_many(f32, lay, 30, exchange=exchange, device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-10)


@pytest.mark.cuda
def test_wire_encoders_on_card_match_cpu(dev):
    """The lossy wires' encoders on the card bit for bit against the CPU:
    the int8 row quantizer and the int4 groups (their scales divide by a
    tensor: a Python divisor becomes a reciprocal multiply on CUDA), the
    nibble pack of all 15 × 15 code pairs, both error-feedback encoders
    and the top-Δ choice on rows with ties."""
    from repro_torch.dist import compress, halo
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal((64, 8, 61))
                          * rng.uniform(0, 10, (64, 8, 1))).astype(np.float32))
    for fn in (compress.quantize_rows, halo._quantize_groups):
        for a, b in zip(fn(x.to(dev)), fn(x)):
            assert torch.equal(a.cpu(), b)
    lo, hi = np.meshgrid(np.arange(-7, 8), np.arange(-7, 8))
    codes = torch.from_numpy(np.stack([lo.ravel(), hi.ravel()], -1)
                             .reshape(1, -1).astype(np.int8))
    packed = halo._nibble_pack(codes.to(dev))
    assert torch.equal(packed.cpu(), halo._nibble_pack(codes))
    assert torch.equal(halo._nibble_unpack(packed).cpu(), codes)
    lanes, sref, sres = (torch.from_numpy(rng.standard_normal((8, 8, 3, 40))
                                          .astype(np.float32))
                         for _ in range(3))
    for enc in (halo._ef_encode, halo._ef_encode_fused):
        got = enc(lanes.to(dev), sref.to(dev), sres.to(dev))
        for a, b in zip(got, enc(lanes, sref, sres)):
            assert torch.equal(a.cpu(), b)
    ex = halo.RaggedQuantizedHaloExchange(schedule=(40,))
    tied = torch.from_numpy(rng.choice([0.5, -0.5, 0.25, 0.0], 2 * 3 * 40)
                            .astype(np.float32))
    out = []
    for d in (dev, torch.device("cpu")):
        zeros = torch.zeros(2 * 40, dtype=torch.int64, device=d)
        seg = ex._segments({"rq_mirror": zeros, "rq_master": zeros,
                            "routes": {}}, 3, 1)
        st = {"sref": torch.zeros(240, device=d),
              "rref": torch.zeros(240, device=d)}
        out.append(ex._encode(tied.to(d), st, seg))
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a.cpu(), b)
    assert torch.equal(out[0][0]["sref"].cpu(), out[1][0]["sref"])


NEW_EXCHANGES = ("quantized", "ragged", "ragged_quantized")


@pytest.mark.cuda
@pytest.mark.parametrize("exchange", NEW_EXCHANGES)
@pytest.mark.parametrize("name", tuple(GAS_ITERS))
def test_new_exchanges_on_card(dev, gas_layout, name, exchange):
    """Every program on the three new wires on the card: the integer
    programs bit for bit against the CPU (their payloads ship exact), the
    f32 ones on ragged within rtol 1e-5 of the CPU; on the lossy wires,
    where float atomics on the card can flip a code, pagerank is held to
    the reference's bounds against the float64 oracle (quantized at 30
    iterations within 1e-5; ragged-quantized at 100 within 1e-6) and ppr
    and centrality must be finite.  K3 once an iteration of the f32
    programs, no other kernel."""
    from repro_torch.graph import get_program, reference_pagerank
    from repro_torch.graph import simulate_gas
    g, lay = gas_layout
    prog = get_program(name, g.num_vertices)
    iters = GAS_ITERS[name]
    if name == "pagerank" and exchange == "ragged_quantized":
        iters = 100
    ops.reset_launch_counts()
    got = simulate_gas(prog, lay, iters, exchange=exchange, device=dev)
    launched = ops.launch_counts()
    assert launched.get("ell_spmv", 0) == \
        (iters if name in K3_PROGRAMS else 0)
    assert not {n for n, c in launched.items() if c} - {"ell_spmv"}
    if name not in K3_PROGRAMS or exchange == "ragged":
        want = simulate_gas(prog, lay, iters, exchange=exchange,
                            device="cpu")
        if name in K3_PROGRAMS:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-10)
        else:
            np.testing.assert_array_equal(got, want)
    elif name == "pagerank":
        ref = reference_pagerank(g.src, g.dst, g.num_vertices, iters)
        bound = 1e-5 if exchange == "quantized" else 1e-6
        assert np.abs(got - ref).max() < bound
    else:
        assert np.isfinite(got).all()


@pytest.mark.cuda
@pytest.mark.parametrize("exchange", ("ragged", "ragged_quantized"))
def test_overlap_and_hopwise_on_card(dev, gas_layout, exchange):
    """The overlapped body on the card: the i32 bundle and labelprop equal
    the phase-ordered runs bit for bit; the hopwise reduce equals the
    deferred one for a min payload."""
    from repro_torch.dist.halo import get_exchange
    from repro_torch.graph import get_program, simulate_gas, simulate_gas_many
    from repro_torch.graph.engine import stack_dev
    g, lay = gas_layout
    i32 = [get_program(p, g.num_vertices)
           for p in ("cc", "labelprop", "sssp", "bfs")]
    base = simulate_gas_many(i32, lay, 40, exchange=exchange, device=dev)
    over = simulate_gas_many(i32, lay, 40, exchange=exchange, overlap=True,
                             device=dev)
    for a, b in zip(base, over):
        np.testing.assert_array_equal(a, b)
    prog = get_program("labelprop", g.num_vertices)
    np.testing.assert_array_equal(
        simulate_gas(prog, lay, 40, exchange=exchange, overlap=True,
                     device=dev),
        simulate_gas(prog, lay, 40, exchange=exchange, device=dev))
    ex, tables = get_exchange(exchange, lay), stack_dev(lay, exchange, dev)
    vals = torch.randint(0, 1000, (lay.k, 2, lay.l_max), dtype=torch.int32,
                         device=dev)
    a, _ = ex.reduce_stacked_multi(vals, tables, "min")
    b, _ = ex.reduce_stacked_multi(vals, tables, "min", hopwise=True)
    assert torch.equal(a, b)
