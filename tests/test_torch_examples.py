"""The examples' twins (``examples/*_torch.py``) run on the CPU, and the
comm table each prints equals the reference session's ``comm_bytes()``
on the same graph and partition, byte for byte.

Each graph twin runs in this process (``runpy``, ``--device cpu``) with
``GraphSession.comm_bytes`` watched: every table it returned is held
against ``repro.session.GraphSession(...).with_partition(...)
.comm_bytes()`` on that session's edges and assignment, and against the
numbers the twin printed.  The serving twin's greedy tokens equal those
``examples/serve_lm.py`` prints, on the reference launcher's own weights
(its ``init_params(cfg, key(seed))``, converted), and the training
twin's losses equal those ``examples/train_lm.py --tiny`` trains to on the
same weights within rtol 1e-5.
"""
import re
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.session import GraphSession  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _run(monkeypatch, capsys, name, *argv):
    """Run a twin; returns (its output lines, [(session, table)] of every
    ``comm_bytes()`` it called)."""
    tables = []
    plain = GraphSession.comm_bytes

    def watched(self, *a, **kw):
        out = plain(self, *a, **kw)
        if not a and not kw:
            tables.append((self, out))
        return out
    monkeypatch.setattr(GraphSession, "comm_bytes", watched)
    path = EXAMPLES / f"{name}_torch.py"
    monkeypatch.setattr(sys, "argv", [str(path), "--device", "cpu", *argv])
    runpy.run_path(str(path), run_name="__main__")
    return capsys.readouterr().out.splitlines(), tables


def _reference_table(sess):
    """The reference session's comm table on ``sess``'s graph and
    partition."""
    from repro.core import CLUGPConfig
    from repro.session import GraphSession as JSession
    src, dst = sess.edges
    ref = JSession(CLUGPConfig(k=sess.k)).with_partition(
        src, dst, sess.num_vertices, np.asarray(sess.assign))
    return ref, ref.comm_bytes()


def _ints(line):
    return [int(x) for x in re.findall(r"(?<![\d.])\d+(?![\d.])", line)]


def test_quickstart_twin(monkeypatch, capsys):
    lines, tables = _run(monkeypatch, capsys, "quickstart")
    assert len(tables) == 1
    sess, table = tables[0]
    _, want = _reference_table(sess)
    assert table == want
    line = [x for x in lines if x.startswith("mirror-sync comm/iter")][0]
    printed = dict((k, int(v)) for k, v in re.findall(r"(\w+)=(\d+)", line))
    assert printed == {k: want[k] for k in ("quantized", "halo",
                                            "dense_gather", "ideal",
                                            "allreduce")}
    # the GAS runs went through 8 ranks and agree with the oracles
    assert any(x.startswith("pagerank (8 ranks on cpu)") for x in lines)
    err = float(re.search(r"= ([\d.e+-]+)", [
        x for x in lines if x.startswith("pagerank")][0]).group(1))
    assert err < 1e-6
    assert "label match vs oracle = 100.0%" in "\n".join(lines)


def test_partition_compare_twin(monkeypatch, capsys):
    ks = (4, 16)
    lines, tables = _run(monkeypatch, capsys, "partition_compare",
                         "--scale", "10", "--ks", *map(str, ks))
    rows = [x for x in lines if re.match(r"(clugp|clugp-opt|hashing|dbh|"
                                         r"greedy|hdrf|mint) ", x)]
    assert len(rows) == len(tables) == 7 * len(ks)
    for row, (sess, table) in zip(rows, tables):
        _, want = _reference_table(sess)
        assert table == want, row
        assert _ints(row)[-3:] == [want["dense_gather"], want["halo"],
                                   want["ideal"]], row
        assert _ints(row)[0] == sess.k


def test_distributed_pagerank_twin(monkeypatch, capsys):
    lines, tables = _run(monkeypatch, capsys, "distributed_pagerank")
    rows = [x for x in lines if x.startswith(("clugp ", "hashing "))]
    assert len(rows) == len(tables) == 2
    for row, (sess, table) in zip(rows, tables):
        ref, want = _reference_table(sess)
        assert table == want, row
        assert _ints(row) == [ref.partition_layout.mirrors_total,
                              want["ideal"], want["quantized"],
                              want["halo"], want["dense_gather"]], row
    text = "\n".join(lines)
    assert "label match=100.0%" in text
    it = int(re.search(r"\((\d+) of 60 capped iters\)", text).group(1))
    assert it < 60


def test_serve_lm_twin(monkeypatch, capsys):
    """``serve_lm_torch.py`` on the CPU, the launcher's weights replaced
    by the reference launcher's seed-0 draws (converted): the same
    sample of greedy tokens as ``examples/serve_lm.py`` prints."""
    import jax
    from repro import configs as jconfigs
    from repro.models import lm as JLM
    from repro_torch import configs
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.launch import serve
    monkeypatch.setattr(sys, "argv", ["serve_lm"])
    runpy.run_path(str(EXAMPLES / "serve_lm.py"), run_name="__main__")
    want = [x for x in capsys.readouterr().out.splitlines()
            if x.startswith("sample:")]
    jcfg = jconfigs.get_config("qwen2-7b").reduced()
    params = lm_params_from_reference(jax.tree_util.tree_map(
        np.asarray, JLM.init_params(jcfg, jax.random.key(0))),
        configs.get_config("qwen2-7b").reduced())
    monkeypatch.setattr(serve, "init_params", lambda *a, **k: params)
    path = EXAMPLES / "serve_lm_torch.py"
    monkeypatch.setattr(sys, "argv", [str(path), "--device", "cpu"])
    runpy.run_path(str(path), run_name="__main__")
    lines = capsys.readouterr().out.splitlines()
    assert any(x.startswith("arch=qwen2-7b batch=4 40 steps")
               and x.endswith("on cpu") for x in lines), lines
    assert len(want) == 1
    assert [x for x in lines if x.startswith("sample:")] == want


def _capture(module, monkeypatch, losses):
    """Record the losses of ``module.ft_run`` (a launcher's run)."""
    run = module.ft_run

    def watched(*a, **k):
        out = run(*a, **k)
        losses.extend(float(x) for x in out[2])
        return out
    monkeypatch.setattr(module, "ft_run", watched)


def test_train_lm_twin(monkeypatch, capsys, tmp_path):
    """``train_lm_torch.py --tiny`` on the CPU, the launcher's weights
    replaced by the reference launcher's seed-0 draws (converted): its
    losses equal those of ``examples/train_lm.py --tiny`` on the same run
    (the data and the steps are the same by construction), within rtol
    1e-5, the tolerance ``tests/test_torch_train.py`` (``LOSS_RTOL``)
    holds the launcher's ``ft.run`` to the reference's by.  Each run's
    checkpoints go under ``tmp_path``."""
    import jax
    from repro import configs as jconfigs
    from repro.launch import train as jtrain
    from repro.models import lm as JLM
    from repro_torch import configs
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.launch import train as ttrain
    steps = "6"
    want, got = [], []
    _capture(jtrain, monkeypatch, want)
    main = jtrain.main

    def redirected():       # the reference example's fixed /tmp directory
        i = sys.argv.index("--ckpt-dir")
        sys.argv[i + 1] = str(tmp_path / "reference")
        return main()
    monkeypatch.setattr(jtrain, "main", redirected)
    monkeypatch.setattr(sys, "argv", ["train_lm.py", "--tiny", "--steps",
                                      steps])
    runpy.run_path(str(EXAMPLES / "train_lm.py"), run_name="__main__")

    jcfg = jconfigs.get_config("stablelm-1.6b").reduced()
    params = lm_params_from_reference(jax.tree_util.tree_map(
        np.asarray, JLM.init_params(jcfg, jax.random.key(0))),
        configs.get_config("stablelm-1.6b").reduced())
    monkeypatch.setattr(ttrain, "init_params", lambda *a, **k: params)
    _capture(ttrain, monkeypatch, got)
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    path = EXAMPLES / "train_lm_torch.py"
    monkeypatch.setattr(sys, "argv", [str(path), "--tiny", "--steps", steps,
                                      "--device", "cpu"])
    runpy.run_path(str(path), run_name="__main__")
    out = capsys.readouterr().out
    assert f"done: {steps} steps" in out
    assert (tmp_path / "repro_torch_train_lm_tiny").is_dir()
    assert len(got) == len(want) == int(steps)
    np.testing.assert_allclose(got, want, rtol=1e-5)
