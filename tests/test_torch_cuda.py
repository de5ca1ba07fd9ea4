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


def _gs_inputs(k, m=300, pad=60, seed=0):
    """A sweep's inputs with ``pad`` pad rows at the end (no size, no row
    total, no cut mass): integer-valued f32 cut mass and sizes, loads
    from the assignment, λ near λ_max's scale."""
    rng = np.random.default_rng(seed)
    live = m - pad
    aff = np.zeros((m, k), np.float32)
    aff[:live] = rng.integers(0, 4, (live, k))
    sizes = np.zeros(m, np.float32)
    sizes[:live] = rng.integers(1, 200, live)
    row_tot = aff.sum(1) + np.where(np.arange(m) < live,
                                    rng.integers(0, 8, m), 0)
    assign = rng.integers(0, k, m).astype(np.int32)
    loads = np.bincount(assign, weights=sizes, minlength=k).astype(np.float32)
    lam = np.float32(k * k * row_tot.sum() / 2 / sizes.sum() ** 2)
    return [torch.from_numpy(x) for x in (aff, sizes, row_tot.astype(
        np.float32), assign, loads, np.array([lam], np.float32))], live


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 31, 32, 33, 64, 256, 1024])
def test_game_gs_on_card(dev, k):
    """G (one launch a sweep) against its plain version bit for bit:
    assignment, loads and moves, over every row and over the live prefix
    (the pad rows past it never move)."""
    (aff, sizes, row_tot, assign, loads, lam), live = _gs_inputs(k)
    want = ops.game_gs_plain(aff, sizes, row_tot, assign, loads, lam=lam,
                             k=k)
    assert k == 1 or int(want[2]) > 0
    for n in (None, live):
        ops.reset_launch_counts()
        got = ops.game_gs(*(t.to(dev) for t in (aff, sizes, row_tot, assign,
                                                loads)),
                          lam=lam.to(dev), k=k, n=n)
        assert ops.launch_counts() == {"game_gs": 1}
        for g_, w_ in zip(got, want):
            assert torch.equal(g_.cpu().to(w_.dtype), w_)


@pytest.mark.cuda
def test_scan_partition_on_card_matches_cpu(dev):
    """The scan partition on the card (K1, G once a round, T) against the
    port on the CPU from the same injected start assignment, edge for
    edge, with equal rounds."""
    from repro_torch.core import CLUGPConfig, partition, web_graph
    g = web_graph(scale=12, edge_factor=6, seed=2)
    cfg = CLUGPConfig.optimized(16, restream=1, kernel="scan")
    off = partition(g.src, g.dst, g.num_vertices,
                    CLUGPConfig.optimized(16, game=False), device="cpu")
    start = torch.from_numpy(np.random.default_rng(5).integers(
        0, 16, off.stats["m_cap"]).astype(np.int32))
    ops.reset_launch_counts()
    card = partition(g.src, g.dst, g.num_vertices, cfg, device=dev,
                     assign0=start)
    launched = ops.launch_counts()
    assert launched["game_gs"] == card.game_rounds > 1
    assert "game_bestresponse_csr" not in launched
    cpu = partition(g.src, g.dst, g.num_vertices, cfg, device="cpu",
                    assign0=start)
    assert card.game_rounds == cpu.game_rounds
    np.testing.assert_array_equal(card.cluster_assign, cpu.cluster_assign)
    np.testing.assert_array_equal(card.assign, cpu.assign)


@pytest.mark.cuda
def test_sweep_on_card_matches_per_k_partitions(dev):
    """``partition_sweep`` on the card equals a partition at each k (the
    caps agree here, so the seeded starts do too)."""
    from repro_torch.core import (CLUGPConfig, partition, partition_sweep,
                                  web_graph)
    g = web_graph(scale=12, edge_factor=6, seed=2)
    cfg = CLUGPConfig.optimized(8, restream=1, kernel="scan")
    ks = (4, 16, 64)
    sweep = partition_sweep(g.src, g.dst, g.num_vertices, cfg, ks,
                            device=dev)
    for k, res in zip(ks, sweep):
        one = partition(g.src, g.dst, g.num_vertices,
                        CLUGPConfig.optimized(k, restream=1, kernel="scan"),
                        device=dev)
        assert one.stats["m_cap"] == res.stats["m_cap"]
        np.testing.assert_array_equal(one.assign, res.assign)
        assert res.stats["sweep"] and res.stats["k_max"] == 64


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,causal", [(300, True), (300, False),
                                       (2048, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_group5_on_card(dev, Sq, causal, dtype):
    """K4 at llama4-scout's heads (Hq = 40 over Hkv = 8: group 5) against
    its plain version: 2e-5 in f32, 2e-2 in bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(Sq + int(causal))
    q = torch.randn(2, 40, Sq, 128, generator=gen, device=dev).to(dtype)
    k, v = torch.randn(2, 2, 8, Sq, 128, generator=gen, device=dev).to(dtype)
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = ops.flash_attention_plain(q, k, v, causal=causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("capacity_factor", [1.25, 16.0])
@pytest.mark.parametrize("top_k,n_shared", [(1, 1), (2, 0)])
def test_moe_apply_on_card_matches_cpu(dev, top_k, n_shared,
                                       capacity_factor):
    """The grouped dispatch, expert products and combine on the card
    against the same on the CPU, f32 without TF32, 1e-5; the dispatch
    tables' tokens (routing, drops) equal, their gates within 1e-5 (the
    router's logits and softmax round apart, by up to 2e-6 relative)."""
    from repro_torch.models import moe as M
    torch.backends.cuda.matmul.allow_tf32 = False
    E, d = 16, 256
    p = M.moe_init(torch.Generator().manual_seed(top_k), d, 384, E, n_shared)
    x = torch.from_numpy(np.random.default_rng(top_k).standard_normal(
        (4, 200, d)).astype(np.float32))
    kw = dict(n_experts=E, top_k=top_k, capacity_factor=capacity_factor)
    got = M.moe_apply(_params_to(p, dev, torch.float32), x.to(dev), **kw)
    want = M.moe_apply(p, x, **kw)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    cap = M.expert_capacity(200, top_k, E, capacity_factor)
    tables = [M.dispatch_tables(*M.route(q, y, top_k=top_k), n_experts=E,
                                capacity=cap)
              for q, y in ((_params_to(p, dev, torch.float32), x.to(dev)),
                           (p, x))]
    assert torch.equal(tables[0][0].cpu(), tables[1][0])
    torch.testing.assert_close(tables[0][1].cpu(), tables[1][1], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
def test_reduced_llama4_prefill_and_decode_on_card_match_cpu(dev):
    """Reduced llama4-scout on the card (K4 once a layer in prefill, none
    in decode) against the CPU, same weights, f32 without TF32: last
    prefill logits and three decode steps' logits within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_cache, init_params, \
        prefill
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llama4_scout_17b_a16e").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    on_card = _params_to(params, dev, torch.float32)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 100)))
    ops.reset_launch_counts()
    got, _ = prefill(on_card, {"tokens": toks.to(dev)}, cfg,
                     dtype=torch.float32)
    assert ops.launch_counts().get("flash_attention") == cfg.n_layers
    want, _ = prefill(params, {"tokens": toks}, cfg, dtype=torch.float32)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    caches = [init_cache(cfg, 2, 3, dtype=torch.float32, device=d)
              for d in (dev, "cpu")]
    ops.reset_launch_counts()
    for t in range(3):
        a, _ = decode_step(on_card, caches[0], toks[:, t:t + 1].to(dev), t,
                           cfg, dtype=torch.float32)
        b, _ = decode_step(params, caches[1], toks[:, t:t + 1], t, cfg,
                           dtype=torch.float32)
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    assert not any(ops.launch_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Skv", [(100, 100), (300, 300), (100, 300),
                                    (300, 100), (256, 256)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_mla_head_dims_on_card(dev, Sq, Skv, causal, dtype):
    """K4 at MLA's head dims (q and k 192 = nope 128 + rope 64, v 128; 8
    heads, group 1) against its plain version: 2e-5 in f32, 2e-2 in bf16.
    As the model passes them: (B, S, H, D) activations as transposed
    views, v a slice of wider rows (kv_b's output past its nope columns);
    the output is (B, S, H, 128) seen as (B, H, S, 128), and equals the
    kernel's result on contiguous copies bit for bit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(Sq * 3 + Skv + int(causal))
    q = torch.randn(2, Sq, 8, 192, generator=gen, device=dev).to(dtype)
    k = torch.randn(2, Skv, 8, 192, generator=gen, device=dev).to(dtype)
    kvb = torch.randn(2, Skv, 8, 256, generator=gen, device=dev).to(dtype)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), \
        kvb[..., 128:].transpose(1, 2)
    got = ops.flash_attention(qt, kt, vt, causal=causal)
    torch.cuda.synchronize()
    assert got.shape == (2, 8, Sq, 128) and got.transpose(1, 2).is_contiguous()
    want = ops.flash_attention_plain(qt, kt, vt, causal=causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    same = ops.flash_attention(qt.contiguous(), kt.contiguous(),
                               vt.contiguous(), causal=causal)
    assert torch.equal(got, same)


@pytest.mark.cuda
def test_flash_attention_mla_gqa_group_and_rounding_on_card(dev):
    """At (192, 128) with 16 q heads over 4 KV heads (group 4) and p
    rounded as the kernel rounds it (the plain version over 128-row KV
    tiles with p in bf16), bf16 agrees within 1e-2."""
    gen = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn(1, 16, 384, 192, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k = torch.randn(1, 4, 384, 192, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    v = torch.randn(1, 4, 384, 128, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    got = ops.flash_attention(q, k, v, causal=True)
    want = ops.flash_attention_plain(q, k, v, causal=True, block_kv=128,
                                     p_dtype=torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.cuda
def test_flash_attention_refuses_head_dim_pairs_it_is_not_built_for(dev):
    q = torch.zeros(1, 4, 16, 128, device=dev, dtype=torch.bfloat16)
    v = torch.zeros(1, 4, 16, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_attention(q, q, v)
    with pytest.raises(ValueError, match="Dv"):
        ops.flash_attention(q, q, v[:, :2])


@pytest.mark.cuda
@pytest.mark.parametrize("capacity_factor", [1.25, 32.0])
def test_moe_apply_top8_of_256_on_card_matches_cpu(dev, capacity_factor):
    """deepseek-v3's routing (256 experts, top-8, softmax after top-k, a
    shared expert) on the card against the CPU, f32 without TF32: the
    combine sums 8 terms a token with float atomics, in another order
    than the CPU's, so the layer is held within 1e-5 (ROADMAP Queue 3,
    "MoE combine order"); the dispatch tables' tokens equal."""
    from repro_torch.models import moe as M
    torch.backends.cuda.matmul.allow_tf32 = False
    E, d = 256, 256
    p = M.moe_init(torch.Generator().manual_seed(8), d, 128, E, 1)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (4, 200, d)).astype(np.float32))
    kw = dict(n_experts=E, top_k=8, capacity_factor=capacity_factor,
              router_softmax_after_topk=True)
    got = M.moe_apply(_params_to(p, dev, torch.float32), x.to(dev), **kw)
    want = M.moe_apply(p, x, **kw)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    cap = M.expert_capacity(200, 8, E, capacity_factor)
    tables = [M.dispatch_tables(*M.route(q, y, top_k=8,
                                         router_softmax_after_topk=True),
                                n_experts=E, capacity=cap)
              for q, y in ((_params_to(p, dev, torch.float32), x.to(dev)),
                           (p, x))]
    assert torch.equal(tables[0][0].cpu(), tables[1][0])


@pytest.mark.cuda
def test_small_mla_model_on_card_matches_cpu(dev):
    """The reduced deepseek-v3 with MLA at its published head dims (nope
    128, rope 64, v 128; the reduced ones, 24/16, are no K4 shape) on the
    card against the CPU, same weights, f32 without TF32: K4 once a layer
    in prefill, none in decode; last prefill logits and three decode
    steps' logits within 1e-4."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import MLAConfig, decode_step, init_cache, \
        init_params, prefill
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("deepseek_v3_671b").reduced()
    cfg = dataclasses.replace(cfg, mla=MLAConfig(
        q_lora=64, kv_lora=32, nope_dim=128, rope_dim=64, v_dim=128))
    params = init_params(cfg, torch.Generator().manual_seed(0))
    on_card = _params_to(params, dev, torch.float32)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 100)))
    ops.reset_launch_counts()
    got, _ = prefill(on_card, {"tokens": toks.to(dev)}, cfg,
                     dtype=torch.float32)
    assert ops.launch_counts().get("flash_attention") == cfg.n_layers
    want, _ = prefill(params, {"tokens": toks}, cfg, dtype=torch.float32)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    caches = [init_cache(cfg, 2, 3, dtype=torch.float32, device=d)
              for d in (dev, "cpu")]
    ops.reset_launch_counts()
    for t in range(3):
        a, _ = decode_step(on_card, caches[0], toks[:, t:t + 1].to(dev), t,
                           cfg, dtype=torch.float32)
        b, _ = decode_step(params, caches[1], toks[:, t:t + 1], t, cfg,
                           dtype=torch.float32)
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    assert not any(ops.launch_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["cuda", "scan"])
def test_game_default_draws_give_one_partition_on_card_and_cpu(dev, kernel):
    """With the game on and its default draws (the counter hash: no
    injected start or damping mask), the card and the CPU give one
    partition: cluster assignment, edge assignment and rounds equal, for
    the Jacobi CSR game and the scan game."""
    from repro_torch.core import CLUGPConfig, partition, web_graph
    from repro_torch.core.game import damping_draws, start_assignment
    g = web_graph(scale=12, edge_factor=6, seed=2)
    cfg = CLUGPConfig.optimized(16, restream=1, kernel=kernel)
    card = partition(g.src, g.dst, g.num_vertices, cfg, device=dev)
    cpu = partition(g.src, g.dst, g.num_vertices, cfg, device="cpu")
    assert card.game_rounds == cpu.game_rounds > 1
    np.testing.assert_array_equal(card.cluster_assign, cpu.cluster_assign)
    np.testing.assert_array_equal(card.assign, cpu.assign)
    assert torch.equal(start_assignment(5000, 64, 3, dev).cpu(),
                       start_assignment(5000, 64, 3, "cpu"))
    draws = [damping_draws(3, 5000, 640, 8, 64, d) for d in (dev, "cpu")]
    for rnd in (0, 7, 63):
        assert torch.equal(draws[0](rnd, 0).cpu(), draws[1](rnd, 0))


SSM_TOL = {"mamba2_130m": 1e-4, "jamba_1_5_large_398b": 5e-3}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(SSM_TOL))
def test_reduced_ssm_prefill_and_decode_on_card_match_cpu(dev, arch):
    """Reduced mamba2-130m and jamba (2 periods; K4 at its attention
    sublayer, once a period) on the card against the CPU, same weights,
    f32 without TF32: last prefill logits, then eight decode steps' logits
    and the SSM states they write, at the CPU tests' tolerances (1e-4;
    jamba's 16 sublayers amplify rounding, 5e-3).  Decode launches no
    kernel."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_cache, init_params, \
        prefill
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    tol = SSM_TOL[arch]
    params = init_params(cfg, torch.Generator().manual_seed(0))
    on_card = _params_to(params, dev, torch.float32)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 64)))
    ops.reset_launch_counts()
    got, _ = prefill(on_card, {"tokens": toks.to(dev)}, cfg,
                     dtype=torch.float32)
    periods = cfg.n_layers // cfg.attn_period if cfg.attn_period else 0
    assert ops.launch_counts().get("flash_attention", 0) == periods
    want, _ = prefill(params, {"tokens": toks}, cfg, dtype=torch.float32)
    torch.testing.assert_close(got.cpu(), want, rtol=tol, atol=tol)
    caches = [init_cache(cfg, 2, 8, dtype=torch.float32, device=d)
              for d in (dev, "cpu")]
    ops.reset_launch_counts()
    for t in range(8):
        a, _ = decode_step(on_card, caches[0], toks[:, t:t + 1].to(dev), t,
                           cfg, dtype=torch.float32)
        b, _ = decode_step(params, caches[1], toks[:, t:t + 1], t, cfg,
                           dtype=torch.float32)
        torch.testing.assert_close(a.cpu(), b, rtol=tol, atol=tol)
    assert not any(ops.launch_counts().values())
    for group in caches[1]:
        torch.testing.assert_close(caches[0][group]["state"].cpu(),
                                   caches[1][group]["state"], rtol=tol,
                                   atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Skv", [(100, 100), (300, 300), (100, 300),
                                    (300, 100), (2048, 2048)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_hd160_on_card(dev, Sq, Skv, causal, dtype):
    """K4 at pixtral's head dim (D = Dv = 160: five 32-column panels; 16 q
    heads over 4 KV heads, group 4) against its plain version: 2e-5 in
    f32, 2e-2 in bf16, and in bf16 within 1e-2 of the plain version that
    rounds p as the kernel does (64-row KV tiles, p in bf16).  As the
    model passes them: (B, S, H, D) activations as transposed views; the
    output is (B, S, H, 160) seen as (B, H, S, 160) and equals the
    kernel's result on contiguous copies bit for bit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(Sq * 5 + Skv + int(causal))
    q = torch.randn(2, Sq, 16, 160, generator=gen, device=dev).to(dtype)
    kv = torch.randn(2, Skv, 2, 4, 160, generator=gen, device=dev).to(dtype)
    qt, kt, vt = (q.transpose(1, 2), kv[:, :, 0].transpose(1, 2),
                  kv[:, :, 1].transpose(1, 2))
    got = ops.flash_attention(qt, kt, vt, causal=causal)
    torch.cuda.synchronize()
    assert got.shape == (2, 16, Sq, 160) and \
        got.transpose(1, 2).is_contiguous()
    want = ops.flash_attention_plain(qt, kt, vt, causal=causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        rounded = ops.flash_attention_plain(
            qt, kt, vt, causal=causal, block_kv=ops.kernel_block_kv(160),
            p_dtype=torch.bfloat16)
        torch.testing.assert_close(got.float(), rounded.float(), rtol=1e-2,
                                   atol=1e-2)
    same = ops.flash_attention(qt.contiguous(), kt.contiguous(),
                               vt.contiguous(), causal=causal)
    assert torch.equal(got, same)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_one_query_row_on_card(dev, dtype):
    """The encoder-decoder's decode cross-attention: one query row (Sq =
    1) over Skv = 1,024 memory rows, not causal, D 64, seamless's 16 heads
    (group 1) and a group-2 split, q a transposed (B, 1, H, D) view:
    against the plain version, 2e-5 in f32 and 2e-2 in bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    for hkv in (16, 8):
        gen = torch.Generator(device=dev).manual_seed(hkv)
        q = torch.randn(4, 1, 16, 64, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(4, 1024, hkv, 64, generator=gen,
                            device=dev).to(dtype).transpose(1, 2)
                for _ in range(2))
        got = ops.flash_attention(q.transpose(1, 2), k, v, causal=False)
        torch.cuda.synchronize()
        want = ops.flash_attention_plain(q.transpose(1, 2), k, v,
                                         causal=False)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


# the reduced encoder-decoder and VLM on the card: (arch, head dim), and
# K4's launches a prefill and a decode step (seamless: encoder, decoder
# and cross-attention a layer pair, the cross-attention a step)
ENCDEC_VLM = {("seamless_m4t_large_v2", None): (6, 2),
              ("pixtral_12b", None): (2, 0), ("pixtral_12b", 160): (2, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("arch,head_dim", sorted(
    ENCDEC_VLM, key=lambda c: (c[0], c[1] or 0)))
def test_reduced_encdec_and_vlm_on_card_match_cpu(dev, arch, head_dim):
    """Reduced seamless-m4t (2 + 2 layers, 40 source frames for 64 tokens)
    and pixtral (8 prefix positions; at its reduced head dim and at 160)
    on the card against the CPU, same weights, f32 without TF32: the last
    prefill logits, then eight decode steps' logits (seamless attending
    the encoder's output) and the KV cache, 1e-4.  K4 launches once an
    attention of the prefill and once a cross-attention of a step."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, encode, init_cache, \
        init_params, prefill
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    if head_dim is not None:
        cfg = dataclasses.replace(cfg, head_dim=head_dim)
    k4_prefill, k4_step = ENCDEC_VLM[(arch, head_dim)]
    params = init_params(cfg, torch.Generator().manual_seed(0))
    on_card = _params_to(params, dev, torch.float32)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64)))}
    side = ("src_embeds", 40) if cfg.family == "encdec" else (
        "prefix_embeds", cfg.prefix_tokens)
    batch[side[0]] = torch.from_numpy(rng.standard_normal(
        (2, side[1], cfg.d_model)).astype(np.float32))
    ops.reset_launch_counts()
    got, _ = prefill(on_card, {k: v.to(dev) for k, v in batch.items()}, cfg,
                     dtype=torch.float32)
    assert ops.launch_counts() == {"flash_attention": k4_prefill}
    want, _ = prefill(params, batch, cfg, dtype=torch.float32)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    memory = [None, None]
    if cfg.family == "encdec":
        memory = [encode(on_card, batch["src_embeds"].to(dev), cfg,
                         dtype=torch.float32),
                  encode(params, batch["src_embeds"], cfg,
                         dtype=torch.float32)]
    caches = [init_cache(cfg, 2, 8, dtype=torch.float32, device=d)
              for d in (dev, "cpu")]
    toks = batch["tokens"]
    ops.reset_launch_counts()
    for t in range(8):
        a, _ = decode_step(on_card, caches[0], toks[:, t:t + 1].to(dev), t,
                           cfg, dtype=torch.float32, memory=memory[0])
        b, _ = decode_step(params, caches[1], toks[:, t:t + 1], t, cfg,
                           dtype=torch.float32, memory=memory[1])
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    assert ops.launch_counts().get("flash_attention", 0) == 8 * k4_step
    for group in caches[1]:
        for name in caches[1][group]:
            torch.testing.assert_close(caches[0][group][name].cpu(),
                                       caches[1][group][name], rtol=1e-4,
                                       atol=1e-4)


# ------------------------------------------------------------------ training

@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,S,D,Dv,causal", [
    (2, 4, 4, 300, 64, 64, True), (1, 28, 4, 200, 128, 128, False),
    (1, 8, 8, 130, 192, 128, True), (1, 8, 2, 150, 160, 160, True),
    (2, 6, 2, 77, 32, 32, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_lse_on_card(dev, B, Hq, Hkv, S, D, Dv, causal,
                                     dtype):
    """The rows' log-sum-exp K4 writes for the backward, at every head-dim
    pair, against the plain version's on the same inputs: 1e-5 on the f32
    path; 1e-3 absolute on the bf16 path, whose scores are exact products
    of bf16 values summed in f32, as the plain version's are, the
    log-sum-exp f32 arithmetic on both sides)."""
    from repro_torch.kernels import flash_attention as K4

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(S + D)
    q = torch.randn(B, Hq, S, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Hkv, S, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Hkv, S, Dv, generator=gen, device=dev).to(dtype)
    o, lse = K4._kernel(q, k, v, causal, None, with_lse=True)
    torch.cuda.synchronize()
    want_o, want = ops.flash_attention_plain(q, k, v, causal=causal,
                                             return_lse=True)
    tol = 1e-3 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(lse, want, rtol=0 if dtype == torch.bfloat16
                               else tol, atol=tol)
    assert torch.equal(o, ops.flash_attention(q, k, v, causal=causal))


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,S,D,Dv,causal,dtype", [
    (2, 8, 8, 256, 64, 64, True, torch.bfloat16),
    (1, 28, 4, 300, 128, 128, True, torch.bfloat16),
    (1, 8, 2, 150, 160, 160, True, torch.bfloat16),
    (1, 8, 8, 200, 192, 128, True, torch.bfloat16),
    (1, 8, 8, 200, 192, 128, False, torch.float32),
    (2, 7, 1, 150, 64, 64, True, torch.float32)])
def test_flash_attention_backward_on_card(dev, B, Hq, Hkv, S, D, Dv, causal,
                                          dtype):
    """dq, dk, dv through K4's ``FlashAttention`` (the kernel's forward and
    log-sum-exp, then ``flash_attention_backward``: the backward kernel in
    bf16, the plain version in f32) against autograd of the plain version
    on the same card: 2e-2 in bf16 (K4's bf16 tolerance: the kernels round
    p, and the backward dS, to bf16), 1e-4 of each gradient's largest
    magnitude in f32.  One forward launch, and in bf16 one backward
    launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(S * 3 + D)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)
    q, k, v = rand(B, Hq, S, D), rand(B, Hkv, S, D), rand(B, Hkv, S, Dv)
    do = rand(B, Hq, S, Dv)
    grads = []
    for fn in (ops.flash_attention, ops.flash_attention_plain):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ops.reset_launch_counts()
        out = fn(*leaves, causal=causal)
        grads.append(torch.autograd.grad(out, leaves, do))
        if fn is ops.flash_attention:
            want = {"flash_attention": 1}
            if dtype == torch.bfloat16:
                want["flash_attention_bwd"] = 1
            assert ops.launch_counts() == want
    torch.cuda.synchronize()
    for got, want in zip(*grads):
        if dtype == torch.bfloat16:
            torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                       atol=2e-2)
        else:
            scale = float(want.abs().max())
            torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_parameter_gets_a_gradient_on_card(dev, dtype, monkeypatch):
    """One ``make_train_step`` of a 2-layer stablelm-like model (head dim
    64) on the card: K4 twice a layer (the forward and the remat
    recompute) and in bf16 its backward kernel once a layer (f32 takes the
    plain backward), every gradient leaf finite and non-zero, and in f32
    every leaf within 1e-4 of its largest magnitude of the same step with
    the plain version (differentiated by autograd) in K4's place."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params, lm, tree_leaves
    from repro_torch.train import Optimizer, adamw, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("stablelm_1_6b").reduced(),
                              n_heads=4, n_kv_heads=4, head_dim=64,
                              d_model=256)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64))).to(dev)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    base, seen = adamw(), []

    def update(grads, state, p, step):
        seen.append(tree_leaves(grads))
        return base.update(grads, state, p, step)
    spy = Optimizer("adamw", base.init, update)

    ops.reset_launch_counts()
    make_train_step(cfg, spy, dtype=dtype)(params, spy.init(params), batch, 0)
    want = {"flash_attention": 2 * cfg.n_layers}
    if dtype == torch.bfloat16:
        want["flash_attention_bwd"] = cfg.n_layers
    assert ops.launch_counts() == want
    for g in seen[0]:
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any())
    if dtype == torch.float32:
        monkeypatch.setattr(lm, "flash_attention", ops.flash_attention_plain)
        make_train_step(cfg, spy, dtype=dtype)(params, spy.init(params),
                                               batch, 0)
        for got, want in zip(*seen):
            torch.testing.assert_close(
                got, want, rtol=0, atol=1e-4 * float(want.abs().max()))


# K4's backward kernel: (B, Hq, Hkv, Sq, Skv, D, Dv, causal, (B, S, H, D)
# views) — groups 1, 4 and 7, Sq ≠ Skv both ways (causal with Sq < Skv
# leaves KV tiles no q row sees: their dK and dV are zeros), every head-dim
# pair the kernel takes
BWD_CASES = [(2, 8, 8, 256, 256, 64, 64, True, True),
             (2, 8, 8, 256, 256, 64, 64, False, False),
             (1, 28, 4, 300, 300, 128, 128, True, True),
             (1, 28, 4, 300, 300, 128, 128, False, False),
             (2, 8, 2, 200, 333, 64, 64, False, True),
             (2, 8, 2, 200, 333, 64, 64, True, False),
             (1, 4, 1, 333, 150, 128, 128, True, True),
             (1, 4, 1, 150, 333, 128, 128, True, False),
             (1, 7, 1, 129, 77, 32, 32, False, True),
             (1, 7, 1, 77, 129, 32, 32, True, False),
             (2, 14, 2, 517, 517, 64, 64, True, True),
             (1, 8, 8, 64, 512, 128, 128, True, True),
             (2, 8, 2, 300, 300, 160, 160, True, True),
             (1, 4, 1, 200, 333, 160, 160, False, False),
             (1, 8, 2, 333, 150, 160, 160, True, False),
             (1, 8, 8, 300, 300, 192, 128, True, True),
             (2, 4, 4, 150, 333, 192, 128, False, True),
             (1, 4, 4, 333, 77, 192, 128, True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,Dv,causal,views", BWD_CASES)
def test_flash_attention_bwd_kernel_matches_its_rounding_twin(
        dev, B, Hq, Hkv, Sq, Skv, D, Dv, causal, views):
    """The bf16 backward kernel (one launch) against the plain version on
    the same bf16 inputs and the forward kernel's o and log-sum-exp:
    against ``round_dtype=torch.bfloat16`` held in f32 (P and dS rounded
    as the kernel rounds them), dq, dk, dv within 5e-3 of each gradient's
    largest magnitude (the two differ in the order of their f32 sums,
    and the kernel rounds its results to bf16: at most half a bf16 step,
    2⁻⁹ of a value); against the unrounded plain version within 2e-2
    (K4's bf16 tolerance)."""
    from repro_torch.kernels import flash_attention as K4
    gen = torch.Generator(device=dev).manual_seed(Sq * 7 + Skv + D)

    def act(h, s, d):
        if views:
            return torch.randn(B, s, h, d, generator=gen, device=dev,
                               dtype=torch.bfloat16).transpose(1, 2)
        return torch.randn(B, h, s, d, generator=gen, device=dev,
                           dtype=torch.bfloat16)
    q, do = act(Hq, Sq, D), act(Hq, Sq, Dv)
    k, v = act(Hkv, Skv, D), act(Hkv, Skv, Dv)
    o, lse = K4._kernel(q, k, v, causal, None, with_lse=True)
    ops.reset_launch_counts()
    got = ops.flash_attention_backward(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"flash_attention_bwd": 1}
    f32 = [t.float() for t in (q, k, v, o, lse, do)]
    twin = ops.flash_attention_backward_plain(*f32, causal,
                                              round_dtype=torch.bfloat16)
    plain = ops.flash_attention_backward_plain(*f32, causal)
    for name, g, t, w, x in zip(("dq", "dk", "dv"), got, twin, plain,
                                (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.shape == x.shape
        assert torch.isfinite(g).all(), name
        scale = float(t.abs().max())
        err = float((g.float() - t).abs().max())
        assert err <= 5e-3 * scale, f"{name}: {err:.3e} vs 5e-3 × {scale:.3e}"
        torch.testing.assert_close(g.float(), w, rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_flash_attention_bwd_takes_an_expanded_gradient(dev):
    """``out.sum()``'s gradient reaches the backward as an expanded tensor
    (stride 0), which no tensor map can read: the wrapper copies it and
    the kernel gives the gradients of a contiguous all-ones ``do`` bit
    for bit."""
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn(2, 4, 130, 64, generator=gen, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.reset_launch_counts()
    ops.flash_attention(*leaves).sum().backward()
    assert ops.launch_counts() == {"flash_attention": 1,
                                   "flash_attention_bwd": 1}
    from repro_torch.kernels import flash_attention as K4
    o, lse = K4._kernel(q, k, v, True, None, with_lse=True)
    want = ops.flash_attention_backward(q, k, v, o, lse, torch.ones_like(o))
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_takes_mla_operands_as_they_lie(dev, causal):
    """MLA's operands as the model passes them: v a strided slice of
    ``kv_b``'s output rows past the nope columns, k the materialised
    ``kf`` (nope columns, then the shared rope head broadcast), q and dO
    transposed views of (B, S, H, D).  The kernel reads them as they lie
    (one launch, no copy): its gradients equal those of contiguous copies
    of the same values bit for bit."""
    from repro_torch.kernels import flash_attention as K4
    gen = torch.Generator(device=dev).manual_seed(11)
    B, S, H, nope, rope, dv = 2, 200, 8, 128, 64, 128

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)
    kv = rand(B, S, H, nope + dv)
    k_rope = rand(B, S, 1, rope)
    k = torch.cat([kv[..., :nope], k_rope.expand(B, S, H, rope)],
                  -1).transpose(1, 2)
    v = kv[..., nope:].transpose(1, 2)
    q, do = rand(B, S, H, nope + rope).transpose(1, 2), \
        rand(B, S, H, dv).transpose(1, 2)
    assert not v.is_contiguous() and v.stride(1) == nope + dv
    o, lse = K4._kernel(q, k, v, causal, None, with_lse=True)
    ops.reset_launch_counts()
    got = ops.flash_attention_backward(q, k, v, o, lse, do, causal)
    assert ops.launch_counts() == {"flash_attention_bwd": 1}
    want = ops.flash_attention_backward(
        *(t.contiguous() for t in (q, k, v, o)), lse, do.contiguous(),
        causal)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_two_ranks_on_one_card_match_two_cpu_ranks(dev):
    """The sharded partitioner and the per-rank engine with 2 ranks on
    one card (gloo, staged through the host) against 2 ranks on the CPU:
    the partition (game on, the rank-folded draws) and cc bit for bit,
    pagerank within rtol 1e-5 (the card's K3 and ``index_add_`` sums are
    float atomics)."""
    from repro_torch.core import CLUGPConfig, web_graph
    from repro_torch.core.partitioner import partition
    from repro_torch.graph import engine as E
    from repro_torch.graph.partition import build_layout
    from repro_torch.launch.mesh import make_graph_mesh
    g = web_graph(scale=12, edge_factor=8, seed=1)
    cfg = CLUGPConfig.optimized(8, restream=1)
    runs = [partition(g.src, g.dst, g.num_vertices, cfg, backend="sharded",
                      nodes=2, device=d) for d in (None, "cpu")]
    assert [r.stats["mesh"]["transport"] for r in runs] == ["gloo", "gloo"]
    np.testing.assert_array_equal(runs[0].assign, runs[1].assign)
    assert runs[0].stats["game_rounds"] == runs[1].stats["game_rounds"]
    # a 2-partition layout of the same stream, one partition a rank
    lay = build_layout(g.src, g.dst, runs[0].assign % 2, g.num_vertices, 2)
    meshes = [make_graph_mesh(2), make_graph_mesh(2, device="cpu")]
    for ex in ("halo", "ragged"):
        card, cpu = (E.shard_map_gas_many(
            [E.pagerank_program(g.num_vertices), E.ppr_program(
                g.num_vertices)], lay, m, 30, exchange=ex) for m in meshes)
        for a, b in zip(card, cpu):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-9)
        card, cpu = (E.shard_map_cc(lay, m, 30, exchange=ex) for m in meshes)
        np.testing.assert_array_equal(card, cpu)


def _lm_mesh_job(mesh, d):
    """Sequence-parallel decode, one tensor-parallel qwen2-7b layer at full
    width and ``pipeline_apply`` on 4 ranks sharing the card."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.dist import decode as DEC
    from repro_torch.dist.mesh import make_mesh
    from repro_torch.dist.pipeline_parallel import pipeline_apply
    from repro_torch.dist.sharding import SINGLE_POD_RULES, shard, use_rules
    from repro_torch.models.lm import init_layer, run_layers
    from repro_torch.train import place_params
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    t = {k: v.to(dev) for k, v in d.items()}
    cfg = dataclasses.replace(get_config("qwen2_7b"), n_layers=1)
    out = {}
    with use_rules(SINGLE_POD_RULES, mesh):
        kb, vb = (shard(t[n], "batch", "sp_seq", None, None)
                  for n in ("k", "v"))
        out["sp"] = DEC.sp_decode_attention(t["q"], kb, vb, 37,
                                            max_len=t["k"].shape[1]).cpu()
        layer = place_params(mesh)("['g_dense'][0]", init_layer(
            cfg, "dense", torch.Generator(device=dev).manual_seed(5)))
        out["layer"] = run_layers(t["x"], [layer], cfg).cpu()
    stage = make_mesh({"stage": mesh.size})
    ws = [t["w"][r] if r == stage.rank else None for r in range(stage.size)]
    out["pipeline"] = pipeline_apply(stage, "stage", ws, t["xs"],
                                     lambda x, w: torch.tanh(x @ w)).cpu()
    return out


@pytest.mark.cuda
def test_lm_mesh_on_four_card_ranks_matches_one_card(dev):
    """On make_test_mesh(1, 4) over gloo, ranks sharing the card, f32:
    ``sp_decode_attention`` over a cache split by sequence, one
    tensor-parallel qwen2-7b layer at full width (2 × 64 tokens), each
    within 1e-4 of the largest magnitude of the one-card port; and
    ``pipeline_apply`` against ``reference_apply`` within 2e-5."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.dist import decode as DEC
    from repro_torch.dist.mesh import run_on_ranks
    from repro_torch.dist.pipeline_parallel import reference_apply
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.lm import init_layer, run_layers
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("qwen2_7b"), n_layers=1)
    gen = torch.Generator(device=dev).manual_seed(3)

    def f(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    d = dict(q=f(4, 1, 8, 64), k=f(4, 64, 2, 64), v=f(4, 64, 2, 64),
             x=f(2, 64, cfg.d_model), w=f(4, 16, 16) / 4, xs=f(6, 4, 16))
    got = run_on_ranks(_lm_mesh_job, make_test_mesh(1, 4),
                       {k: v.cpu() for k, v in d.items()}, timeout=600)

    def close(a, b, rel):
        assert float((a - b).abs().max()) <= rel * float(b.abs().max())
    close(got["sp"], DEC.sp_decode_attention(d["q"], d["k"], d["v"],
                                             37).cpu(), 1e-4)
    layer = init_layer(cfg, "dense", torch.Generator(device=dev)
                       .manual_seed(5))
    close(got["layer"], run_layers(d["x"], [layer], cfg).cpu(), 1e-4)
    want = reference_apply(list(d["w"]), d["xs"],
                           lambda x, w: torch.tanh(x @ w)).cpu()
    torch.testing.assert_close(got["pipeline"], want, rtol=2e-5, atol=2e-5)
