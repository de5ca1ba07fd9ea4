"""The port's graph serving (``repro_torch.serve``, the serving entry
points of ``repro_torch.core.stages``, ``repro_torch.ckpt``,
``repro_torch.dist.ft`` and ``repro_torch.launch.serve_graph``) held
against the JAX package at scale 10, k = 4.

Both sides adopt the same assignment through ``with_partition``, so the
game (which differs between the packages, ROADMAP Queue 3) does not
enter.  The window assignment and the restream are exact on both sides
and must match bit for bit; the server's f32 replies (pagerank) are held
to rtol 1e-5, the integer ones exactly; early exits within ±1 iteration
at 2e-6, as in ``tests/test_torch_gas.py``."""
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.ckpt as jckpt  # noqa: E402
from repro.core import CLUGPConfig as JConfig  # noqa: E402
from repro.core import incremental_assign as j_incremental  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro.core import partition as j_partition  # noqa: E402
from repro.core import restream_assign as j_restream  # noqa: E402
from repro.core import stream_state as j_stream_state  # noqa: E402
from repro.core import web_graph  # noqa: E402
from repro.core.transform import majority_vertex_map_np  # noqa: E402
from repro.dist.ft import ServiceFT as JServiceFT  # noqa: E402
from repro.serve import GraphServer as JServer  # noqa: E402
from repro.session import GraphSession as JSession  # noqa: E402
from repro.session import SessionConfig as JSessionConfig  # noqa: E402
import repro_torch.ckpt as pckpt  # noqa: E402
from repro_torch.convert import config_from_reference  # noqa: E402
from repro_torch.core import CLUGPConfig  # noqa: E402
from repro_torch.core.stages import (incremental_assign,  # noqa: E402
                                     restream_assign, stream_state)
from repro_torch.core.transform import (host_exact_cap,  # noqa: E402
                                        majority_vertex_map)
from repro_torch.dist.ft import ServiceFT, StragglerWatch  # noqa: E402
from repro_torch.kernels.transform_scan import (  # noqa: E402
    transform_inputs, transform_scan_plain)
from repro_torch.launch import serve_graph  # noqa: E402
from repro_torch.serve import QUERY_KINDS, GraphServer  # noqa: E402
from repro_torch.session import GraphSession  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
K = 4
F32_TOL = 2e-6


@pytest.fixture(scope="module")
def graph():
    """A scale-10 web graph and the reference's CLUGP partition of it
    (the optimized profile: τ = 1.1, so partitions sit at the cap)."""
    g = web_graph(scale=10, seed=0)
    res = j_partition(g.src, g.dst, g.num_vertices,
                      JConfig.optimized(K, restream=1))
    return g, res.assign


def make_pair(graph, exchange="halo", iters=8, **kw):
    """The same assignment adopted by a reference and a port session,
    each behind its own server."""
    g, assign = graph
    jcfg = JSessionConfig(clugp=JConfig.optimized(K), iters=iters,
                          exchange=exchange)
    js = JSession(jcfg).with_partition(g.src, g.dst, g.num_vertices, assign)
    ps = GraphSession(config_from_reference(js.to_json()), device="cpu")
    ps.with_partition(g.src, g.dst, g.num_vertices, assign)
    return JServer(js.layout(), **kw), GraphServer(ps.layout(), **kw)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def _same_reply(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if np.issubdtype(got.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0.0)


# ----------------------------------------------------- incremental path

def _window(graph, case):
    """(new_src, new_dst, num_vertices, tau) of each window case."""
    g, assign = graph
    n, E = g.num_vertices, g.num_edges
    rng = np.random.default_rng(4)
    if case == "resident":
        w = 300
        return rng.integers(0, n, w), rng.integers(0, n, w), n, 1.1
    if case == "grows":              # endpoints past V: new vertices
        w = 400
        ws, wd = rng.integers(0, n + 60, w), rng.integers(0, n, w)
        return ws, wd, int(max(ws.max(), wd.max())) + 1, 1.1
    # "cap_rounding": a window after which τ·(E + W)/k lies just above an
    # integer that f32 rounds it down to, crowding partition 0 (both
    # endpoints of most edges among the vertices whose prior is 0) so
    # that it fills inside the window
    w = next(w for w in range(E // 4, E)
             if math.ceil(1.1 * (E + w) / K)
             != math.ceil(np.float32(1.1 * (E + w) / K)))
    zero = np.flatnonzero(majority_vertex_map_np(g.src, g.dst, assign, n,
                                                 K) == 0)
    crowd = rng.random(w) < 0.7
    ws = np.where(crowd, rng.choice(zero, w), rng.integers(0, n, w))
    wd = np.where(crowd, rng.choice(zero, w), rng.integers(0, n, w))
    return ws, wd, n, 1.1


@pytest.mark.parametrize("case", ["resident", "grows", "cap_rounding"])
def test_incremental_assign_matches_reference(graph, case):
    """The window's assignment on T (seeded loads, host-exact cap)
    against the reference's ``transform_np`` walk, bit for bit; the grown
    stream keeps the grown cap."""
    g, assign = graph
    ws, wd, nv, tau = _window(graph, case)
    want = j_incremental(g.src, g.dst, ws, wd, assign, nv,
                         JConfig(k=K, tau=tau))
    got = incremental_assign(g.src, g.dst, ws, wd, assign, nv,
                             CLUGPConfig(k=K, tau=tau), device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    loads = np.bincount(np.concatenate([assign, got]), minlength=K)
    assert loads.max() <= math.ceil(tau * (g.num_edges + ws.shape[0]) / K)
    if case == "cap_rounding":
        # the case bites: the same walk under the cap rounded to f32
        # assigns another window
        st = stream_state(g.src, g.dst, assign, nv, K, device="cpu")
        prior = majority_vertex_map(_t(g.src), _t(g.dst), _t(assign), nv, K)
        pu, pv, nm = transform_inputs(_t(ws).long(), _t(wd).long(), prior,
                                      st.deg, st.divided)
        cap = tau * (g.num_edges + ws.shape[0]) / K
        loads = np.bincount(assign, minlength=K)
        f32 = transform_scan_plain(pu, pv, nm, K, cap, loads)
        assert not np.array_equal(f32.numpy(), want)
        assert host_exact_cap(cap) == math.ceil(cap) != np.float32(cap)
        np.testing.assert_array_equal(
            transform_scan_plain(pu, pv, nm, K, host_exact_cap(cap),
                                 loads).numpy(), want)


@pytest.mark.parametrize("tau,passes", [(1.0, 1), (1.1, 2), (1.1, 3)])
def test_restream_assign_matches_reference(graph, tau, passes):
    """The restream's best assignment and RF trace against the
    reference's default ``HOST_STAGES`` restream, bit for bit; never
    worse than its input."""
    g, _ = graph
    n = g.num_vertices
    assign = np.random.default_rng(5).integers(0, K, g.num_edges) \
        .astype(np.int32)
    want, wtrace = j_restream(g.src, g.dst, assign, n, JConfig(k=K, tau=tau),
                              passes=passes)
    got, trace = restream_assign(g.src, g.dst, assign, n,
                                 CLUGPConfig(k=K, tau=tau), passes=passes,
                                 device="cpu")
    np.testing.assert_array_equal(got, want)
    assert trace == wtrace and len(trace) == passes
    rf0 = jmetrics.replication_factor(g.src, g.dst, assign, n, K)
    assert trace[0] == rf0
    assert jmetrics.replication_factor(g.src, g.dst, got, n, K) <= rf0


def test_served_restreams_of_a_drifted_partition_match_reference(
        monkeypatch):
    """The restreams a serving run fires at scale 16, k = 64: the
    reference's CLUGP partition (τ = 1.1) adopted by the port's server,
    then the ``[graph-serve]`` chip phase's traffic scaled to the stream
    (3 windows of 65,536 / 16 = 4,096 uniform arrivals in quarter-window
    chunks, watermark 1.02, 2 passes).  Each restream, on the drifted
    assignment the server hands it, equals the reference's default
    ``HOST_STAGES`` restream bit for bit, RF trace included.  Prints per
    restream whether the reference kept its input (``pytest -s``)."""
    from argparse import Namespace
    import repro_torch.serve as pserve
    from repro_torch.session import SessionConfig
    k, window = 64, 65536 >> 4
    g = web_graph(scale=16, edge_factor=8, seed=0)
    res = j_partition(g.src, g.dst, g.num_vertices,
                      JConfig.optimized(k, restream=1))
    sess = GraphSession(SessionConfig(clugp=CLUGPConfig.optimized(
        k, restream=1)), device="cpu")
    sess.with_partition(g.src, g.dst, g.num_vertices, res.assign)
    seen = []

    def both(src, dst, assign, nv, cfg, *, passes, device):
        got, trace = restream_assign(src, dst, assign, nv, cfg,
                                     passes=passes, device=device)
        want, wtrace = j_restream(src, dst, assign, nv,
                                  JConfig(k=cfg.k, tau=cfg.tau),
                                  passes=passes)
        np.testing.assert_array_equal(got, want)
        assert trace == wtrace and len(trace) == passes
        seen.append((trace, jmetrics.replication_factor(src, dst, want, nv,
                                                         cfg.k),
                     bool(np.array_equal(want, assign))))
        return got, trace

    monkeypatch.setattr(pserve, "restream_assign", both)
    srv = GraphServer(sess, window=window, rf_watermark=1.02,
                      restream_passes=2)
    serve_graph.drive_ingest(srv, Namespace(seed=0, window=window,
                                            ingest_windows=3))
    assert srv.stats["windows"] == 3
    assert len(seen) == srv.stats["restreams"] >= 1
    for trace, rf, kept in seen:
        assert rf <= trace[0]
        print(f"restream: RF before each pass {trace}, after {rf}, "
              f"{'kept its input' if kept else 'replaced its input'}")


def test_stream_state_matches_reference(graph):
    g, assign = graph
    want = j_stream_state(g.src, g.dst, assign, g.num_vertices + 5, K)
    got = stream_state(g.src, g.dst, assign, g.num_vertices + 5, K,
                       device="cpu")
    np.testing.assert_array_equal(got.deg.numpy(), want.deg)
    np.testing.assert_array_equal(got.divided.numpy(), want.divided)
    assert got.deg.dtype == torch.int32 and got.divided.dtype == torch.bool


# ------------------------------------------------------------- queries

@pytest.mark.parametrize("exchange", ["halo", "dense"])
def test_batched_queries_match_reference(graph, exchange):
    """One fused microbatch (pagerank, degree, cc scores and a full cc
    label vector) on both servers."""
    jsrv, psrv = make_pair(graph, exchange=exchange, max_batch=8)
    verts = np.random.default_rng(1).integers(0, graph[0].num_vertices, 16)
    replies = []
    for srv in (jsrv, psrv):
        tickets = [srv.submit("score", program=p, vertices=verts)
                   for p in ("pagerank", "degree", "cc")]
        tickets.append(srv.submit("label"))
        assert srv.serve_pending() == 4
        replies.append([srv.result(t).value for t in tickets])
    for want, got in zip(*replies):
        _same_reply(got, want)
    assert psrv.stats == jsrv.stats


def test_owner_and_neighbors_match_reference(graph):
    jsrv, psrv = make_pair(graph)
    out = []
    for srv in (jsrv, psrv):
        t1 = srv.submit("owner", vertices=[0, 7, 23, 500])
        t2 = srv.submit("neighbors", vertices=[0, 7])
        srv.serve_pending()
        out.append((srv.result(t1).value, srv.result(t2).value))
    (jown, jnb), (pown, pnb) = out
    np.testing.assert_array_equal(pown, jown)
    for a, b in zip(pnb, jnb):
        np.testing.assert_array_equal(a, b)
    g = graph[0]
    np.testing.assert_array_equal(
        pnb[0], np.unique(np.concatenate([g.dst[g.src == 0],
                                          g.src[g.dst == 0]])))


def test_fused_microbatch_and_value_cache(graph):
    _, srv = make_pair(graph, max_batch=16)
    calls = []
    inner = srv.sess.run_many

    def counting_run_many(progs, **kw):
        calls.append([p.name for p in progs])
        return inner(progs, **kw)

    srv.sess.run_many = counting_run_many
    # pagerank and degree share no cell (f32 against i32 sums); cc rides
    # the (min, i32) cell alone
    for p in ("pagerank", "degree", "cc", "pagerank", "degree"):
        srv.submit("score", program=p, vertices=[0])
    assert srv.step() == 5
    assert srv.stats["microbatches"] == 1
    assert sorted(len(c) for c in calls) == [1, 1, 1]
    for p in ("pagerank", "degree", "cc"):       # all cached now
        srv.submit("score", program=p, vertices=[1])
    calls.clear()
    srv.step()
    assert calls == []


def test_bad_requests_are_rejected(graph):
    _, srv = make_pair(graph)
    with pytest.raises(ValueError, match="unknown query kind"):
        srv.submit("foo")
    with pytest.raises(ValueError, match="need vertices"):
        srv.submit("owner")
    t = srv.submit("score", program="not-a-program")
    srv.step()
    assert "unknown program" in srv.result(t).error
    assert tuple(QUERY_KINDS) == ("score", "label", "neighbors", "owner")
    with pytest.raises(ValueError, match="mesh"):
        GraphServer(srv.sess, mesh=object())


# -------------------------------------------------------------- ingest

def _feed(srv, seed, chunks, size, n):
    rng = np.random.default_rng(seed)
    flushed = False
    for _ in range(chunks):
        flushed |= srv.ingest(rng.integers(0, n, size),
                              rng.integers(0, n, size))
    return flushed


def test_ingest_flush_and_watermark_match_reference(graph):
    """The same arrivals through both servers: the same windows, restreams,
    RF trace (to 1e-12), assignment and stats, and the grown graph
    serves."""
    kw = dict(window=400, rf_watermark=1.01, restream_passes=2)
    jsrv, psrv = make_pair(graph, **kw)
    n = graph[0].num_vertices
    for srv in (jsrv, psrv):
        assert _feed(srv, 6, 8, 110, n)
    assert psrv.stats == jsrv.stats
    assert psrv.stats["windows"] == 2 and psrv.stats["restreams"] >= 1
    assert [e for e, _ in psrv.rf_trace] == [e for e, _ in jsrv.rf_trace]
    np.testing.assert_allclose([v for _, v in psrv.rf_trace],
                               [v for _, v in jsrv.rf_trace], rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(psrv.sess.assign, jsrv.sess.assign)
    assert psrv.sess.partition_layout.num_edges == len(psrv.sess.edges[0])
    repaired = [v for e, v in psrv.rf_trace if e == "restream"]
    drifted = [v for e, v in psrv.rf_trace if e == "window"]
    assert repaired[-1] <= max(drifted) + 1e-12
    assert [s["event"] for s in psrv.swap_log] == \
        [e for e, _ in psrv.rf_trace[1:]]
    for swap in psrv.swap_log:     # the cap of the grown stream holds
        assert swap["max_load"] <= 1.1 * swap["edges"] / K + 1
    replies = []
    for srv in (jsrv, psrv):
        t = srv.submit("score", program="pagerank", vertices=[0, 3])
        srv.step()
        replies.append(srv.result(t).value)
    _same_reply(replies[1], replies[0])


def test_tol_server_warm_starts_after_swap(graph):
    """With ``tol`` the value caches seed the rerun after a swap: warm
    runs fewer iterations than cold, each within ±1 of the reference's."""
    kw = dict(window=400, rf_watermark=1.01, restream_passes=2,
              tol=F32_TOL, iters=60)
    jsrv, psrv = make_pair(graph, **kw)
    n = graph[0].num_vertices
    iters = []
    for srv in (jsrv, psrv):
        t = srv.submit("score", program="pagerank", vertices=[0])
        srv.step()
        assert srv.result(t).error is None
        first = max(srv.last_iters_run.values())
        _feed(srv, 6, 4, 110, n)
        assert srv.stats["restreams"] >= 1
        assert not srv._values and srv._warm
        srv.last_iters_run.clear()
        t = srv.submit("score", program="pagerank", vertices=[0, 1])
        srv.step()
        assert srv.result(t).error is None
        iters.append((first, max(srv.last_iters_run.values())))
    (jfirst, jwarm), (pfirst, pwarm) = iters
    assert abs(pfirst - jfirst) <= 1 and abs(pwarm - jwarm) <= 1
    cold, cold_iters = psrv.sess.run_many(
        ["pagerank"], iters=60, exchange="halo", tol=F32_TOL,
        init_values=[np.zeros(0)], return_iters=True)
    assert pwarm < cold_iters, (pwarm, cold_iters)
    np.testing.assert_allclose(psrv._values[("pagerank", "halo")], cold[0],
                               atol=1e-4)


def test_tol_server_cold_matches_direct_run(graph):
    """A tol server with nothing cached runs the cold path through the
    same loop: its replies equal a direct ``run_many`` with empty seeds."""
    _, srv = make_pair(graph, tol=1e-6, iters=40)
    verts = [0, 1, 2, 3]
    t = srv.submit("score", program="pagerank", vertices=verts)
    srv.step()
    direct, _ = srv.sess.run_many(
        ["pagerank"], iters=40, exchange="halo", tol=1e-6,
        init_values=[np.zeros(0)], return_iters=True)
    np.testing.assert_array_equal(srv.result(t).value, direct[0][verts])


def test_ingest_can_grow_the_vertex_set(graph):
    jsrv, psrv = make_pair(graph, window=50)
    n0 = psrv.sess.num_vertices
    owners = []
    for srv in (jsrv, psrv):
        srv.ingest(np.arange(n0, n0 + 50), np.zeros(50, dtype=np.int64))
        assert srv.sess.num_vertices == n0 + 50
        t = srv.submit("owner", vertices=[n0 + 10, n0 + 49, 0])
        srv.step()
        reply = srv.result(t)
        assert reply.error is None
        owners.append(reply.value)
    np.testing.assert_array_equal(owners[1], owners[0])
    np.testing.assert_array_equal(psrv.sess.assign, jsrv.sess.assign)


# ---------------------------------------------------------- preemption

def test_kill_and_resume_identical_partition(graph, tmp_path):
    _, srv = make_pair(graph, window=300, rf_watermark=1.01)
    rng = np.random.default_rng(7)
    n = graph[0].num_vertices
    srv.ingest(rng.integers(0, n, 300), rng.integers(0, n, 300))
    srv.ft = ServiceFT(tmp_path, async_checkpoint=True)
    srv.checkpoint()
    srv.ft.wait()
    blob, assign = srv.sess.to_json(), srv.sess.assign.copy()
    t = srv.submit("score", program="pagerank", vertices=[0, 1, 2])
    srv.step()
    want = srv.result(t).value
    del srv                                    # the "kill"
    srv2 = GraphServer.resume(ServiceFT(tmp_path), device="cpu")
    assert srv2.sess.to_json() == blob
    np.testing.assert_array_equal(srv2.sess.assign, assign)
    t2 = srv2.submit("score", program="pagerank", vertices=[0, 1, 2])
    srv2.step()
    np.testing.assert_array_equal(srv2.result(t2).value, want)


def test_resume_empty_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        GraphServer.resume(ServiceFT(tmp_path), device="cpu")


def test_snapshot_survives_graph_growth(graph, tmp_path):
    """Snapshots of two sizes in one directory: the latest wins."""
    _, srv = make_pair(graph, window=100)
    srv.ft = ServiceFT(tmp_path)
    srv.checkpoint()
    srv.ingest(np.zeros(100, np.int64), np.arange(1, 101, dtype=np.int64))
    srv.checkpoint()
    srv.ft.wait()
    assert pckpt.list_steps(tmp_path) == [0, 1]
    srv2 = GraphServer.resume(ServiceFT(tmp_path), device="cpu")
    assert len(srv2.sess.edges[0]) == len(srv.sess.edges[0])
    np.testing.assert_array_equal(srv2.sess.assign, srv.sess.assign)


def test_checkpoints_cross_between_the_packages(graph, tmp_path):
    """A snapshot the reference's ``ckpt.save`` wrote is read by the
    port's ``restore_raw`` with the same keys and arrays, and the other
    way round; a torn write is skipped."""
    jsrv, psrv = make_pair(graph)
    tree = jsrv.sess.snapshot()
    jckpt.save(tmp_path / "j", 3, tree, extra={"who": "reference"})
    flat, manifest = pckpt.restore_raw(tmp_path / "j", 3)
    assert sorted(flat) == ["['assign']", "['dst']", "['src']"]
    assert manifest["keys"] == sorted(flat)
    for key in tree:
        np.testing.assert_array_equal(flat[f"['{key}']"], tree[key])
    assert manifest["extra"] == {"who": "reference"}
    pckpt.save(tmp_path / "p", 5, psrv.sess.snapshot(), extra={"n": 1})
    (tmp_path / "p" / "step_00000009.tmp").mkdir()     # a killed writer
    assert pckpt.list_steps(tmp_path / "p") == [5]
    jflat, jman = jckpt.restore_raw(tmp_path / "p", 5)
    assert sorted(jflat) == sorted(flat) and jman["extra"] == {"n": 1}
    for key in tree:
        np.testing.assert_array_equal(jflat[f"['{key}']"], tree[key])
    # the reference's service reads the port's snapshot, and back
    flat2, extra2, step = JServiceFT(tmp_path / "p").restore_latest()
    assert step == 5 and sorted(flat2) == ["assign", "dst", "src"]
    flat3, _, step = ServiceFT(tmp_path / "j").restore_latest()
    assert step == 3 and sorted(flat3) == ["assign", "dst", "src"]


def test_straggler_watch_flags_slow_steps():
    w = StragglerWatch(factor=3.0, warmup=2)
    assert not w.observe(1.0) and not w.observe(1.0)
    assert w.observe(10.0) and w.last_median == 1.0
    assert not w.observe(1.5)
    assert w.flagged == 1
    assert not StragglerWatch(0.0).observe(1e9)


# ------------------------------------------------- device and launcher

def test_server_and_launcher_need_a_card_unless_told_otherwise(
        graph, tmp_path, monkeypatch):
    _, srv = make_pair(graph, window=100)
    srv.ft = ServiceFT(tmp_path)
    srv.checkpoint()
    srv.ft.wait()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GraphServer.resume(ServiceFT(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_graph.main(["--scale", "8", "--k", "4",
                          "--out", str(tmp_path / "o.json")])
    g, assign = graph
    with pytest.raises(RuntimeError, match="device='cpu'"):
        incremental_assign(g.src, g.dst, [0], [1], assign, g.num_vertices,
                           CLUGPConfig(k=K))


def test_launcher_smoke_on_cpu(tmp_path):
    """The launcher's ``--smoke --tol --ckpt-dir`` run on the CPU: reply
    checks, the restream gate, warm against cold, and a SIGKILL'd child
    resumed.  Windows of 256 arrivals keep the scale-10 graph's growth
    (3.8% a window) small enough for warm start to win."""
    out = tmp_path / "bench.json"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_graph",
         "--device", "cpu", "--scale", "10", "--k", "4", "--window", "256",
         "--iters", "100", "--smoke", "--tol", "1e-6",
         "--ckpt-dir", str(tmp_path / "ck"), "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "SIGKILL'd child resumed" in proc.stdout
    import json
    rows = json.loads(out.read_text())
    assert rows[0]["device"] == "cpu" and rows[0]["restreams"] >= 1
    cold, warm = rows[1:]
    assert warm["iters_run"] < cold["iters_run"]
