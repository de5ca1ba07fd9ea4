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
