"""The port's sharded partitioner (``partition(..., backend="sharded")``),
its mesh and collectives (``repro_torch.launch.mesh``,
``repro_torch.dist.collectives``) and ``compressed_psum``, with ranks
spawned on the CPU over gloo, held against the JAX package's sharded
backend run in a subprocess on XLA host devices.

Tolerances:
- game off, 2 and 4 ranks: the assignment bit for bit against the
  reference's sharded backend and against the ``np`` host combine;
- game on (the Gauss–Seidel scan game, which the reference's ``auto``
  resolves to off a TPU) with the reference's per-device start
  assignments injected on each rank (``fold_in(PRNGKey(seed), i)``): the
  assignment, rounds and m_cap bit for bit;
- game on with the port's own rank-folded draws: the reference test's
  gates (balance ≤ τ + 0.05, RF ≤ 1.10 × the host combine's) and the
  same assignment on a second run;
- ``compressed_psum`` over 4 ranks: bit for bit against the reference's
  under ``shard_map``;
- the collectives: exact values, byte counts as documented.

Every spawn has its own timeout; a rank that raises fails the call
within it.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import CLUGPConfig, web_graph  # noqa: E402
from repro_torch.core import game  # noqa: E402
from repro_torch.core.partitioner import partition  # noqa: E402
from repro_torch.dist import collectives as coll  # noqa: E402
from repro_torch.dist.compress import compressed_psum  # noqa: E402
from repro_torch.dist.mesh import run_on_ranks  # noqa: E402
from repro_torch.launch.mesh import (make_graph_mesh,  # noqa: E402
                                     make_stream_mesh)
from repro_torch.session import GraphSession, SessionConfig  # noqa: E402

K, SEED, TIMEOUT = 8, 5, 120

REF_CODE = """
import numpy as np, jax, jax.numpy as jnp
from functools import partial
from jax.sharding import PartitionSpec as P
import repro.core.partitioner as part
from repro.core import CLUGPConfig, partition, web_graph
from repro.dist.compress import compressed_psum

g = web_graph(scale=10, edge_factor=6, seed=3)
caps = []
grow = part._grow_caps
def spy(c, **kw):
    out = grow(c, **kw)
    caps.append(out)
    return out
part._grow_caps = spy
out = {}
for n in (2, 4):
    out[f"off{n}"] = partition(g.src, g.dst, g.num_vertices,
                               CLUGPConfig(k=%(k)d, restream=1, game=False),
                               backend="sharded", nodes=n).assign
caps.clear()
r = partition(g.src, g.dst, g.num_vertices,
              CLUGPConfig(k=%(k)d, restream=1, kernel="scan", seed=%(seed)d),
              backend="sharded", nodes=4)
m_cap = caps[-1][0].m_cap
out["scan4"], out["scan4_rounds"] = r.assign, r.stats["game_rounds"]
out["m_cap"] = m_cap
key = jax.random.PRNGKey(%(seed)d)
out["starts"] = np.stack([np.asarray(jax.random.randint(
    jax.random.fold_in(key, i), (m_cap,), 0, %(k)d, dtype=jnp.int32))
    for i in range(4)])
x = np.random.default_rng(0).standard_normal((4, 257)).astype(np.float32)
out["cpsum_x"] = x
mesh = jax.make_mesh((4,), ("d",))
f = partial(jax.shard_map, mesh=mesh, in_specs=P("d"), out_specs=P("d"),
            check_vma=False)(lambda xl: compressed_psum(xl[0], "d")[None])
out["cpsum"] = np.asarray(f(jnp.asarray(x)))
np.savez(%(path)r, **out)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def g10():
    return web_graph(scale=10, edge_factor=6, seed=3)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    from conftest import run_multidevice
    path = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    out = run_multidevice(REF_CODE % {"k": K, "seed": SEED, "path": path},
                          n_devices=4, timeout=240)
    assert "REF_OK" in out
    return dict(np.load(path))


def _cpu_sharded(g, cfg, nodes, **kw):
    return partition(g.src, g.dst, g.num_vertices, cfg, backend="sharded",
                     nodes=nodes, device="cpu", **kw)


@pytest.mark.multidevice
@pytest.mark.parametrize("nodes", [2, 4])
def test_sharded_game_off_matches_reference_and_host_combine(
        multidevice, ref, g10, nodes):
    cfg = CLUGPConfig(k=K, restream=1, game=False)
    got = _cpu_sharded(g10, cfg, nodes)
    np.testing.assert_array_equal(got.assign, ref[f"off{nodes}"])
    host = partition(g10.src, g10.dst, g10.num_vertices, cfg, backend="np",
                     nodes=nodes)
    np.testing.assert_array_equal(got.assign, host.assign)
    st = got.stats
    assert st["backend"] == "sharded" and st["nodes"] == nodes
    assert st["mesh"] == {"axis": "stream", "ranks": nodes, "device": "cpu",
                          "transport": "gloo"}
    assert [n["node"] for n in st["per_node"]] == list(range(nodes))
    assert st["num_clusters"] == sum(n["clusters"] for n in st["per_node"])
    assert sum(n["edges"] for n in st["per_node"]) == g10.num_edges
    # the restream prior's count table crossed the ranks once (one pass)
    assert all(n["collectives"]["restream.counts"]["calls"] == 1
               for n in st["per_node"])


@pytest.mark.multidevice
def test_sharded_scan_game_with_reference_draws_matches_reference(
        multidevice, ref, g10):
    cfg = CLUGPConfig(k=K, restream=1, kernel="scan", seed=SEED)
    got = _cpu_sharded(g10, cfg, 4, assign0=list(ref["starts"]))
    assert got.stats["m_cap"] == int(ref["m_cap"])
    assert got.stats["game_rounds"] == int(ref["scan4_rounds"]) > 1
    np.testing.assert_array_equal(got.assign, ref["scan4"])
    assert {n["game_form"] for n in got.stats["per_node"]} == {"scan"}


@pytest.mark.parametrize("kernel", ["scan", "auto"])
def test_sharded_game_with_port_draws_meets_reference_gates(g10, kernel):
    """The port's rank-folded draws: the reference test's gates for the
    scan game (what the reference's ``auto`` plays off a TPU); the Jacobi
    CSR game (the port's ``auto``) is held to balance and to being the
    same partition on a second run.  RF of the Jacobi game varies with
    the draws over 2.61–3.01 at 4 ranks here (the reference's own Jacobi
    sharded game 2.63–2.93 over seeds 0–3), so 2 ranks are used."""
    nodes = 4 if kernel == "scan" else 2
    cfg = CLUGPConfig(k=K, restream=1, kernel=kernel)
    got = _cpu_sharded(g10, cfg, nodes)
    assert got.assign.shape == (g10.num_edges,)
    assert got.assign.min() >= 0 and got.assign.max() < K
    assert got.stats["balance"] <= cfg.tau + 0.05, got.stats["balance"]
    assert got.stats["game_rounds"] >= 1
    if kernel == "scan":
        host = partition(g10.src, g10.dst, g10.num_vertices, cfg,
                         backend="np", nodes=nodes)
        assert got.stats["rf"] <= host.stats["rf"] * 1.10, \
            (got.stats["rf"], host.stats["rf"])
    else:
        again = _cpu_sharded(g10, cfg, nodes)
        np.testing.assert_array_equal(got.assign, again.assign)
    form = "scan" if kernel == "scan" else "cuda"
    assert {n["game_form"] for n in got.stats["per_node"]} == {form}


def test_rank_draws_fold_only_under_a_mesh():
    """A rank's start lanes come from ``rank_seed(seed, rank)``: distinct
    per rank, and unbound runs keep the one-device draws."""
    starts = [game.start_assignment(64, K, game.rank_seed(3, r),
                                    torch.device("cpu")) for r in range(4)]
    for a in range(4):
        for b in range(a + 1, 4):
            assert not torch.equal(starts[a], starts[b])
    assert game._axis_seed(3, None) == 3
    assert game.rank_seed(3, 0) != 3


def _collectives_job(mesh):
    r, n = mesh.rank, mesh.size
    coll.reset_counts()
    lanes = (torch.arange(n * 3, dtype=torch.float32).view(n, 3)
             + 100 * r)
    out = {
        "a2a": coll.all_to_all(lanes, mesh, site="a2a"),
        "hop": coll.ring_hop(torch.tensor([r, 10 * r], dtype=torch.int16),
                             mesh, 1, site="hop"),
        "back": coll.ring_hop(torch.tensor([r]), mesh, -2, site="back"),
        "psum_f": coll.psum(torch.tensor([0.1 * (r + 1), 1.0]), mesh),
        "psum_i": coll.psum(torch.tensor([r, 1], dtype=torch.int32), mesh),
        "pmax": coll.pmax(torch.tensor(r), mesh),
        "pmin": coll.pmin(torch.tensor([r + 5]), mesh),
        "gather": coll.all_gather(torch.tensor([r, r], dtype=torch.int8),
                                  mesh, site="gather"),
        "root": coll.gather_to_root(torch.tensor([1.5 * r]), mesh,
                                    site="root"),
        "index": coll.axis_index(mesh),
    }
    out["counts"] = coll.gather_objects(coll.counts(), mesh)
    return out


def test_collectives_on_four_cpu_ranks():
    n = 4
    out = run_on_ranks(_collectives_job, make_graph_mesh(n, device="cpu"),
                       timeout=TIMEOUT)
    want = torch.stack([torch.arange(3, dtype=torch.float32) + 100 * p
                        for p in range(n)])
    assert torch.equal(out["a2a"], want)       # rank 0's lane from each p
    assert out["hop"].tolist() == [n - 1, 10 * (n - 1)]
    assert out["back"].tolist() == [2]         # rank 0 hears from 0 + 2
    parts = [torch.tensor([0.1 * (p + 1), 1.0]) for p in range(n)]
    assert torch.equal(out["psum_f"],
                       ((parts[0] + parts[1]) + parts[2]) + parts[3])
    assert out["psum_i"].tolist() == [6, 4]
    assert int(out["pmax"]) == 3 and out["pmin"].tolist() == [5]
    assert out["gather"].tolist() == [[p, p] for p in range(n)]
    assert out["root"].reshape(-1).tolist() == [0.0, 1.5, 3.0, 4.5]
    assert out["index"] == 0
    c0, c1 = out["counts"][0], out["counts"][1]
    assert c0["a2a"]["bytes"] == (n - 1) * 3 * 4       # self block stays
    assert c0["hop"]["bytes"] == 2 * 2
    assert c0["gather"]["bytes"] == (n - 1) * 2
    assert c0["root"]["bytes"] == 0 and c1["root"]["bytes"] == 4
    assert c0["psum"]["bytes"] == (n - 1) * 8 + 8      # gathered + reduced
    # the identities of an unbound axis
    x = torch.tensor([1.0, 2.0])
    for f in (coll.psum, coll.pmax, coll.pmin):
        assert f(x, None) is x
    assert coll.axis_index(None) == 0


def _raising_job(mesh, bad_rank):
    coll.psum(torch.ones(2), mesh)
    if mesh.rank == bad_rank:
        raise ValueError(f"rank {mesh.rank} refuses")
    coll.psum(torch.ones(2), mesh)       # its peers wait here
    return mesh.rank


def test_a_failing_rank_fails_the_call_within_its_timeout():
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 refuses"):
        run_on_ranks(_raising_job, make_graph_mesh(3, device="cpu"), 1,
                     timeout=60)
    assert time.monotonic() - t < 60


def _cpsum_job(mesh, x):
    return compressed_psum(torch.from_numpy(x[mesh.rank]), mesh)


@pytest.mark.multidevice
def test_compressed_psum_matches_reference(multidevice, ref):
    x = ref["cpsum_x"]
    got = run_on_ranks(_cpsum_job, make_graph_mesh(4, device="cpu"), x,
                       timeout=TIMEOUT)
    np.testing.assert_array_equal(got.numpy(), ref["cpsum"][0])
    rel = np.abs(got.numpy() - x.sum(0)).max() / np.abs(x.sum(0)).max()
    assert rel < 0.05


def test_session_and_launcher_run_the_sharded_backend(g10, capsys):
    """``SessionConfig(backend="sharded", nodes=2)`` partitions through
    the ranks (the same assignment as ``partition``), and the launcher's
    ``--backend sharded`` prints the ranks and their transport."""
    from repro_torch.launch import partition as launcher
    cfg = CLUGPConfig(k=4, restream=1, kernel="scan")
    sess = GraphSession(SessionConfig(clugp=cfg, backend="sharded", nodes=2),
                        device="cpu")
    sess.partition(g10.src, g10.dst, g10.num_vertices)
    want = _cpu_sharded(g10, cfg, 2)
    np.testing.assert_array_equal(sess.assign, want.assign)
    assert SessionConfig.from_json(sess.to_json()) == sess.cfg
    assert launcher.main(["--device", "cpu", "--scale", "9", "--k", "4",
                          "--backend", "sharded", "--nodes", "2"]) == 0
    out = capsys.readouterr().out
    assert "clugp-opt[sharded, restream=0]" in out
    assert "sharded: 2 ranks on cpu over gloo" in out
    with pytest.raises(ValueError, match="one device"):
        SessionConfig(clugp=cfg, backend="torch", nodes=2)


def test_meshes_name_their_transport():
    m = make_stream_mesh(3, device="cpu")
    assert (m.axis, m.size, m.transport, m.bound) == ("stream", 3, "gloo",
                                                      False)
    assert make_graph_mesh(2, device="cpu").describe() == {
        "axis": "parts", "ranks": 2, "device": "cpu", "transport": "gloo"}
    with pytest.raises(ValueError, match="bound"):
        run_on_ranks(_cpsum_job, make_graph_mesh(1, device="cpu")
                     .__class__("parts", 1, "cpu", "gloo", rank=0))
