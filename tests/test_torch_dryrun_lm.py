"""The dry-run's LM cells (``repro_torch.launch.dryrun``'s LM half) on the
CPU: a rank's program on the meta device under ``collectives.dry`` against
the same program on real ranks, the probe against the full-depth cell,
and the flop count against a closed form.

- **Dry equals real.**  In one spawn of 8 gloo ranks on
  ``make_test_mesh(2, 4)`` (``SINGLE_POD_RULES``, mp 4), at reduced sizes
  (``SIZES``), every rank runs ``build_cell``'s step of each case on its
  own tensors (drawn from one seed on every rank; the inputs zeros), then
  the dry mode runs the same cell as that rank's coordinates of the mesh
  spec on the meta device: the collectives' bytes, calls and ops by site
  (``by_site``) and the bytes of each argument group a rank holds must
  be equal, exactly.  The cases: prefill and decode for one model a
  family (qwen2, llama4-scout, deepseek-v3, mamba2, jamba, seamless,
  pixtral; llama4-scout, deepseek-v3 and jamba with data-axis weight
  sharding, as their published sizes serve, qwen2 both ways) and the
  ZeRO-3 train step for stablelm.  qwen2's prefill with the weights cut
  over "data" gives the tensor-parallel one's logits bit for bit (the
  gathers are exact).
- **The probe** (``run_probe_cell``): its totals of flops, bytes and
  collective bytes equal the full-depth cell's (``run_cell``) exactly,
  for a dense arch and an MoE arch.
- **Flops.**  A reduced qwen2 prefill on a one-rank mesh counts the
  closed form of its products (``test_flops_of_a_prefill_are_its_closed_
  form``), K4's plain twin's masked scores included.
- **The dry mode itself**: meta shapes and the byte rules of psum,
  all-gather and reduce-scatter on a simulated rank, counts kept apart
  from the process's, refusals outside it; K4 on meta tensors takes the
  plain twin both ways and launches nothing.

A spawned rank imports this module to find its job: it imports no JAX.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.dist import collectives as coll  # noqa: E402
from repro_torch.dist.mesh import as_axis, make_mesh, run_on_ranks  # noqa: E402
from repro_torch.dist.sharding import SINGLE_POD_RULES, use_rules  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402

TIMEOUT = 300
MP = 4
# (global batch, positions): a prefill of a multiple of the reduced SSD
# chunk (16), a decode step over a cache of 32 rows (8 a model rank)
SIZES = {"prefill_32k": {"global_batch": 4, "seq_len": 32},
         "decode_32k": {"global_batch": 4, "seq_len": 32},
         "train_4k": {"global_batch": 4, "seq_len": 32}}
LOSS_CHUNK = 16
# (case, arch, shape, zero)
CASES = [("qwen2_prefill", "qwen2_7b", "prefill_32k", False),
         ("qwen2_prefill_zero", "qwen2_7b", "prefill_32k", True),
         ("qwen2_decode", "qwen2_7b", "decode_32k", False)]
for _arch, _zero in (("llama4_scout_17b_a16e", True),
                     ("deepseek_v3_671b", True), ("mamba2_130m", False),
                     ("jamba_1_5_large_398b", True),
                     ("seamless_m4t_large_v2", False),
                     ("pixtral_12b", False)):
    CASES += [(f"{_arch.split('_')[0]}_{kind}", _arch, f"{kind}_32k", _zero)
              for kind in ("prefill", "decode")]
CASES.append(("stablelm_train", "stablelm_1_6b", "train_4k", True))
NAMES = [c[0] for c in CASES]


def _cell_kw(shape, zero):
    return dict(mp=MP, multi_pod=False, loss_chunk=LOSS_CHUNK, zero=zero,
                sizes=SIZES[shape])


def _dry_real_job(mesh, spec, cases):
    """Each case on this rank, real then dry: (by_site, held) of both."""
    out = {}
    with use_rules(SINGLE_POD_RULES, mesh):
        for name, arch, shape, zero in cases:
            cfg = configs.get_config(arch).reduced()
            fn, args, held = D.build_cell(cfg, shape, mesh, SINGLE_POD_RULES,
                                          **_cell_kw(shape, zero))
            coll.reset_counts()
            res = fn(*args)
            real = D.by_site(coll.counts())
            if shape == "prefill_32k" and arch == "qwen2_7b":
                out[name, "logits"] = res
            dry = D.dry_cell(cfg, shape, spec, SINGLE_POD_RULES,
                             coords=mesh.coords, **_cell_kw(shape, zero))
            out[name] = {"real": (real, held),
                         "dry": (dry["by_site"], dry["memory"]["arguments"])}
    return coll.gather_objects(out, mesh)


@pytest.fixture(scope="module")
def ranks():
    spec = make_test_mesh(2, 4, device="cpu")
    return run_on_ranks(_dry_real_job, spec, spec, CASES, timeout=TIMEOUT)


@pytest.mark.parametrize("name", NAMES)
def test_dry_run_equals_the_real_ranks(ranks, name):
    """Every rank: the dry mode's bytes, calls and ops by site and its
    argument bytes equal the real run's; the case called collectives."""
    for r, rank in enumerate(ranks):
        real, dry = rank[name]["real"], rank[name]["dry"]
        assert real[0], (name, r)
        assert dry[0] == real[0], (name, r)
        assert dry[1] == real[1], (name, r)


def test_zero_serving_gives_the_tensor_parallel_logits(ranks):
    """qwen2's prefill with its weights also cut over "data" (gathered
    before each layer) gives the tensor-parallel logits bit for bit, and
    the gathers are the sites that differ."""
    for rank in ranks:
        assert torch.equal(rank["qwen2_prefill_zero", "logits"],
                           rank["qwen2_prefill", "logits"])
        plain = set(rank["qwen2_prefill"]["real"][0])
        zero = set(rank["qwen2_prefill_zero"]["real"][0])
        assert zero - plain == {"zero.gather"}


@pytest.mark.parametrize("arch,shape", [("stablelm_1_6b", "decode_32k"),
                                        ("llama4_scout_17b_a16e",
                                         "decode_32k")])
def test_probe_totals_equal_the_full_cell(tmp_path, arch, shape):
    full = D.run_cell(arch, shape, "single", tmp_path)
    probe = D.run_probe_cell(arch, shape, tmp_path)
    assert full["status"] == probe["status"] == "ok"
    assert probe["totals"] == D._probe_numbers(full)
    assert (tmp_path / f"{arch}__{shape}__probe.json").exists()


def test_flops_of_a_prefill_are_its_closed_form():
    """A reduced qwen2 prefill of B × S tokens on one rank: per layer the
    q, k, v, o and FFN products, the scores and the probabilities times
    the values over every KV row (the plain twin computes the masked
    scores too), then the head at the last position; 2 flops a
    multiply-add."""
    cfg = configs.get_config("qwen2_7b").reduced()
    B, S = 2, 48
    mesh = make_mesh({"data": 1, "model": 1}, device="cpu")
    rec = D.dry_cell(cfg, "prefill_32k", mesh, SINGLE_POD_RULES, mp=1,
                     multi_pod=False, zero=False,
                     sizes={"global_batch": B, "seq_len": S})
    d, hd, H, Hkv, F = (cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads,
                        cfg.d_ff)
    layer = (2 * B * S * d * (H * hd + 2 * Hkv * hd)     # q, k, v
             + 2 * 2 * B * H * S * S * hd                # q·kᵀ, p·v
             + 2 * B * S * H * hd * d                    # o
             + 3 * 2 * B * S * d * F)                    # gate, up, down
    assert rec["flops"] == cfg.n_layers * layer + 2 * B * d * cfg.padded_vocab
    assert rec["collective_bytes"]["total"] == 0


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_meter_counts_the_live_storages_and_the_ops_bytes(device):
    """``Meter`` over a known run: ``a`` (4,000 B) made, ``b`` (2,000 B)
    made from a view of it, ``a`` freed, a view of ``b``, then ``c``
    (6,000 B) as the sum of a temporary (6,000 B) and a view of the
    argument.  The live storages peak while the temporary and ``c`` are
    both alive, 2,000 + 6,000 + 6,000 = 14,000 B (a finalizer that fired
    at once would read 6,000, one that never fired 18,000), and 8,000
    stay; the argument is not counted.  ``bytes_accessed`` adds the
    operands and results of every op that is not a view: 4,000 (a),
    2,000 + 2,000 (the product), 6,000 (the temporary) and 6,000 + 4 +
    6,000 (the sum)."""
    x = torch.empty(100, device=device)

    def run(x):
        a = torch.empty(1000, device=device)
        b = a[:500] * 2
        del a
        v = b.view(10, 50)
        c = torch.empty(1500, device=device) + x[:1]
        return v, c
    meter = D.Meter(keep=(x,))
    with meter:
        v, c = run(x)
    assert meter.temp_bytes == 14_000
    assert meter.now == 8_000
    assert meter.bytes_accessed == 4_000 + 4_000 + 6_000 + 12_004
    assert D.nbytes((v, [c], {"x": x})) == 2_000 + 6_000 + 400


def test_dry_mode_counts_apart_and_moves_nothing():
    """Inside ``collectives.dry`` a rank of the spec is bound with no
    group: every primitive returns meta tensors of the real call's shape
    and counts the real call's bytes (a float psum (n − 1)× its payload,
    an all-gather the same, a reduce-scatter's all-to-all the lanes for
    the other ranks) in a set of the thread's own; ``axis_index`` is the
    rank's coordinate; object calls refuse; outside it the dry mesh
    refuses and the process's counts are untouched."""
    spec = make_test_mesh(2, 4, device="cpu")
    coll.reset_counts()
    with coll.dry(spec, {"data": 1, "model": 2}) as dm:
        assert dm.rank == 6 and dm.coords == {"data": 1, "model": 2}
        model = as_axis(dm, "model")
        assert coll.axis_index(model) == 2 and model.size == 4
        x = torch.empty(3, 5, device="meta")
        summed = coll.psum(x, model, site="s")
        parts = coll.all_gather(x.to(torch.bfloat16), model, site="g")
        mine = coll.reduce_scatter(torch.empty(8, 2, device="meta"), model,
                                   site="r")
        got = coll.counts()
        with pytest.raises(RuntimeError, match="Python objects"):
            coll.gather_objects(1, model)
    assert summed.is_meta and summed.shape == (3, 5)
    assert parts.shape == (4, 3, 5) and parts.dtype == torch.bfloat16
    assert mine.shape == (2, 2)
    assert {s: (c["bytes"], c["ops"]) for s, c in got.items()} == {
        "s": (3 * 15 * 4, {"psum": 1}), "g": (3 * 15 * 2, {"all_gather": 1}),
        "r": (3 * 4 * 4, {"reduce_scatter": 1})}
    assert coll.counts() == {}
    with pytest.raises(RuntimeError, match="only inside"):
        coll.psum(x, model, site="s")


def test_k4_on_meta_takes_the_plain_twin(monkeypatch):
    """Meta tensors run K4's plain twin, forward and backward, and launch
    nothing."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as K4

    def launched(*a, **k):
        raise AssertionError("a meta tensor launched a kernel")
    monkeypatch.setattr(_build, "launch", launched)
    q = torch.empty(2, 4, 64, 32, device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    k, v = (torch.empty(2, 2, 64, 32, device="meta", dtype=torch.bfloat16,
                        requires_grad=True) for _ in range(2))
    o = K4.flash_attention(q, k, v)
    assert o.is_meta and o.shape == (2, 4, 64, 32)
    grads = torch.autograd.grad(o.float().sum(), (q, k, v))
    assert [tuple(g.shape) for g in grads] == [(2, 4, 64, 32),
                                               (2, 2, 64, 32),
                                               (2, 2, 64, 32)]
    with torch.no_grad():
        assert K4.flash_attention(q, k, v, causal=False).is_meta
