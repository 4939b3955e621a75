"""The PE + attention ops fed their keys by id (``KeyRows``: each valid
slot's key is a row of a node table, which the kernels read in place)
against the same ops fed the dense [B, C, O] table ``gather_rows_valid``
gathers from that node table, on the CPU through the plain versions and
the ops' autograd (``test_torch_pe_attention_tiles.py`` holds the
kernels' tile mirrors fed by id); the table's gradient, summed into its
rows with the dead slots dropped whatever their ids; the wrappers' checks
of the table and the ids; and the model's fused route, which feeds the
ops by id, against that route fed the gathered table. No JAX here, so the
card runs the ``cuda`` test too.

A gather is a copy, so everything is held bit for bit (``torch.equal``):
out, m and l, and every gradient, the table's included. Cases: both
context tables, float32 and bfloat16 keys, dead slots' ids the pad id N
with no pad row or real rows; the table's gradient through both branches
of ``ops/gather.py:_rows_sum`` (``index_add_`` and, from 65,536 rows, the
scatter). On the card (``cuda`` marker) the kernels fed by id are held to
the kernels fed the gathered table: m and l bit for bit; out and the
gradients, which the kernels and the scatter sum with f32 atomics in an
order that changes from run to run, within CARD_TOL of their largest
magnitude (bf16 gradients within a bf16 ulp of it: a reordered f32 sum
may round the other way).
"""
import pytest
import torch

from lpformer_tpu_torch.data.synthetic import synthetic_dataset
from lpformer_tpu_torch.models import link_transformer as tlt
from lpformer_tpu_torch.models.config import LPFormerConfig
from lpformer_tpu_torch.ops import gather, masking
from lpformer_tpu_torch.ops import pe_attention as tpa
from lpformer_tpu_torch.ops import pe_attention_mixed as tpam
from lpformer_tpu_torch.ops.pe_attention_mixed import KeyRows
from lpformer_tpu_torch.train import optim
from lpformer_tpu_torch.train import step as tstep
from lpformer_tpu_torch.utils import measure

N, O = 40, 16                   # rows and width of the node table
DIFF = ("q", "w1", "b1", "g", "b", "w2f", "cbias", "att", "bias")
CPU = torch.device("cpu")
CARD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8}


def _inputs(table, bf16, dead, b=8, seed=0, o=O, dh=16, dev=CPU):
    """(the op's arguments but the keys, node table [N, o], ids [B, C]):
    ``measure``'s draws (front-compacted rows, the collab-like spread),
    the valid slots' ids drawn over the table's rows and the dead slots'
    the pad id N ("pad id") or rows of the table ("real rows")."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    if table == "combined":
        a = measure.kernel_inputs(dev, dtype, seed=seed, b=b, c=24, o=o,
                                  dh=dh, k=3)
    else:
        a = measure.classic_kernel_inputs(dev, dtype, seed=seed, b=b,
                                          widths=(8, 8, 8), o=o, dh=dh)
    del a["keys"]
    g = torch.Generator().manual_seed(seed + 1)
    tab = (torch.randn(N, o, generator=g) * 0.5).to(dtype).to(dev)
    ids = torch.randint(0, N, a["valid"].shape, generator=g,
                        dtype=torch.int32).to(dev)
    if dead == "pad id":
        ids = torch.where(a["valid"], ids, N)
    assert int(a["valid"].sum()) > 0 and bool((~a["valid"]).any())
    return a, tab, ids


def _gathered(tab, ids, valid):
    """The dense route's key table: the node table with a zero pad row,
    gathered by the ids."""
    return gather.gather_rows_valid(
        torch.cat([tab, tab.new_zeros((1, tab.shape[1]))]), ids, valid)


def _op(table):
    return (tpam.fused_pe_link_attention_mixed if table == "combined"
            else tpa.fused_pe_link_attention)


def _run(table, a, keys_of):
    """(out, m, l) and the gradients of sum(out * r) (r drawn once) for
    the node table and every float input, with keys = keys_of(table)."""
    tab = a["table"].clone().requires_grad_(True)
    d = {n: (v.clone().requires_grad_(True) if n in DIFF else v)
         for n, v in a.items() if n != "table"}
    out = _op(table)(keys=keys_of(tab), **d)
    r = torch.randn(out[0].shape, generator=torch.Generator().manual_seed(
        5)).to(tab.device)
    grads = torch.autograd.grad((out[0] * r).sum(),
                                [tab] + [d[n] for n in DIFF])
    return out, grads


def _hold_by_id(table, a, tab, ids):
    """The op fed KeyRows(tab, ids) against the op fed the gathered
    table: bit for bit on the CPU, as the module's docstring says on the
    card."""
    a = dict(a, table=tab)
    got = _run(table, a, lambda t: KeyRows(t, ids))
    want = _run(table, a, lambda t: _gathered(t, ids, a["valid"]))
    exact = tab.device.type == "cpu"
    for name, x, y in zip(("out", "m", "l"), got[0], want[0]):
        assert torch.equal(x, y) or (name == "out" and not exact and float(
            (x - y).abs().max()) <= CARD_TOL[torch.float32] * max(
                1.0, float(y.abs().max()))), name
    for name, x, y in zip(("table",) + DIFF, got[1], want[1]):
        assert x.dtype == y.dtype, name
        assert torch.equal(x, y) or (not exact and float(
            (x.float() - y.float()).abs().max()) <= CARD_TOL[x.dtype] * float(
                y.float().abs().max())), name
    assert got[1][0].shape == tab.shape
    assert bool(got[1][0].abs().sum() > 0)


@pytest.mark.parametrize("dead", ["pad id", "real rows"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("table", ["combined", "classic"])
def test_op_by_id_matches_the_gathered_table(table, bf16, dead):
    """Forward and gradients, the table's summed by ``index_add_``."""
    _hold_by_id(table, *_inputs(table, bf16, dead))


@pytest.mark.parametrize("table", ["combined", "classic"])
def test_op_by_id_matches_the_gathered_table_through_the_scatter(table):
    """B C = 65,544 rows: the table's gradient goes through
    ``scatter_rows_add``, which drops the dead rows (ids N, out of
    range) by the live mask."""
    a, tab, ids = _inputs(table, False, "pad id", b=2731, o=4, dh=4)
    assert ids.numel() >= gather._SCATTER_MIN_ROWS
    _hold_by_id(table, a, tab, ids)


@pytest.mark.cuda
@pytest.mark.parametrize("o,dh", [(16, 16), (70, 36), (256, 256)])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("table", ["combined", "classic"])
def test_kernels_by_id_match_the_gathered_table_on_card(table, bf16, o, dh):
    """The CUDA kernels, forward and backward, fed by id (dead ids N, no
    pad row) against the same kernels fed the gathered table; O = 70 reads
    the key rows element by element, the others 16 bytes at a time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a, tab, ids = _inputs(table, bf16, "pad id", b=64, o=o, dh=dh,
                          dev=torch.device("cuda"))
    launches = _op(table).launches
    _hold_by_id(table, a, tab, ids)
    assert _op(table).launches == launches + 2


# (what is wrong, how it is made, the error): the wrappers' checks of the
# keys by id
KEY_ROW_CHECKS = [
    ("int64 ids", lambda t, i: (t, i.long()), TypeError),
    ("ids of another shape", lambda t, i: (t, i[:, :-1].contiguous()),
     ValueError),
    ("strided ids", lambda t, i: (t, i.t().contiguous().t()), ValueError),
    ("a table of no rows", lambda t, i: (t[:0], i), ValueError),
    ("a 3-d table", lambda t, i: (t[None], i), ValueError),
    ("a table of another dtype", lambda t, i: (t.double(), i), TypeError),
]


@pytest.mark.parametrize("case,bad,err", KEY_ROW_CHECKS,
                         ids=[c[0] for c in KEY_ROW_CHECKS])
@pytest.mark.parametrize("table", ["combined", "classic"])
def test_key_rows_checks(table, case, bad, err):
    """What the CUDA wrappers refuse of the keys by id before a launch
    (the checks do not depend on the device, so CPU tensors exercise
    them)."""
    a, tab, ids = _inputs(table, False, "pad id")
    a.pop("class_widths", None)
    check = tpam._check if table == "combined" else tpa._check
    check(KeyRows(tab, ids), **a)
    with pytest.raises(err):
        check(KeyRows(*bad(tab, ids)), **a)


@pytest.mark.parametrize("rows", [64, 70_000])
def test_rows_sum_drops_dead_rows_of_any_id(rows):
    """The key table's gradient sum on both branches (``index_add_`` below
    65,536 rows, the scatter from there): the live rows summed into their
    ids, the dead ones dropped whatever their ids (the pad id N, past the
    table, or a real row)."""
    g = torch.Generator().manual_seed(rows)
    ids = torch.randint(0, N, (rows,), generator=g, dtype=torch.int32)
    live = torch.rand(rows, generator=g) < 0.3
    ids = torch.where(live | (torch.arange(rows) % 2 == 0), ids, N)
    ct = torch.randn(rows, O, generator=g) * live[:, None]
    got = gather._rows_sum(ids.reshape(-1, 2), ct.reshape(-1, 2, O), N,
                           live.reshape(-1, 2))
    want = torch.zeros(N, O).index_add_(0, ids[live].long(), ct[live])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


KW = dict(seed=0, num_nodes=80, num_train=300, num_eval=24, feat_dim=12,
          eps=1e-3)
TABLES = {"combined": dict(budget_combined=32),
          "classic": dict(budget_combined=None, budget_cn=16,
                          budget_onehop=32, budget_non1hop=32)}


@pytest.fixture(scope="module")
def dataset():
    return synthetic_dataset(**KW, device="cpu")


def _step(ds, cfg, params):
    """Eval h of a batch of links, then one training step's loss and
    gradients (dropout off, negatives fixed)."""
    links = torch.as_tensor(ds.valid_pos[:16])
    with torch.no_grad():
        h = tlt.forward(params, cfg, ds.graph, links[:, 0], links[:, 1])
    pos = torch.as_tensor(ds.train_pos[:48])
    neg = torch.randint(0, KW["num_nodes"], (2, 48),
                        generator=torch.Generator().manual_seed(2))
    w = torch.ones(48)
    mr = masking.batch_mask_ranks(ds.graph.adj_rows, pos[:, 0], pos[:, 1],
                                  ds.mask_mult_device, weight=w)
    loss = tstep.loss_fn(params, cfg, ds.graph, pos[:, 0], pos[:, 1],
                         neg[0], neg[1], w, mr, None)
    return h, loss, torch.autograd.grad(loss, optim.tree_leaves(params))


@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("table", ["combined", "classic"])
def test_fused_route_reads_keys_by_id(dataset, monkeypatch, table,
                                      matmul_dtype):
    """The fused route hands its op the projected node table and the
    context ids, and gathers nothing; its h, loss and every gradient leaf
    equal the same route fed the gathered table (``_node_keys``, the
    dense route's keys), bit for bit."""
    cfg = LPFormerConfig(dim=16, gnn_layers=1, thresh_cn=0.0,
                         thresh_1hop=1e-3, thresh_non1hop=1e-3, dropout=0.0,
                         gnn_drop=0.0, att_drop=0.0, feat_drop=0.0,
                         pred_drop=0.0, matmul_dtype=matmul_dtype,
                         **TABLES[table])
    params = tlt.init_lpformer(torch.Generator().manual_seed(3), cfg, 12,
                               device="cpu")
    for x in optim.tree_leaves(params):
        x.requires_grad_(True)
    name = ("fused_pe_link_attention_mixed" if table == "combined"
            else "fused_pe_link_attention")
    seen, gathers = [], []
    real_op, real_gather = getattr(tlt, name), tlt.gather_rows_valid

    def op(keys, *a, **kw):
        seen.append(keys)
        return real_op(keys, *a, **kw)

    def counted(*a):
        gathers.append(1)
        return real_gather(*a)

    monkeypatch.setattr(tlt, name, op)
    monkeypatch.setattr(tlt, "gather_rows_valid", counted)
    got = _step(dataset, cfg, params)
    assert seen and not gathers
    for keys in seen:
        assert isinstance(keys, KeyRows)
        assert keys.table.shape == (KW["num_nodes"], cfg.dim)
        assert keys.table.dtype == (torch.bfloat16 if matmul_dtype ==
                                    "bfloat16" else torch.float32)
    monkeypatch.setattr(tlt, "_node_key_rows", tlt._node_keys)
    want = _step(dataset, cfg, params)
    assert gathers
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for x, y in zip(got[2], want[2]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
def test_recorded_inputs_keep_keys_by_id(dataset, matmul_dtype):
    """``measure.recording_kernel_inputs`` records the combined op's keys
    as the ``KeyRows`` the fused route passed, so a replay launches what
    the step launched; the plain versions, ``in_link_chunks`` (whole and
    cut into links) and ``mixed_bwd_f64`` give on them exactly what they
    give on the gathered table."""
    cfg = LPFormerConfig(dim=16, gnn_layers=1, thresh_cn=0.0,
                         thresh_1hop=1e-3, thresh_non1hop=1e-3, dropout=0.0,
                         gnn_drop=0.0, att_drop=0.0, feat_drop=0.0,
                         pred_drop=0.0, matmul_dtype=matmul_dtype,
                         **TABLES["combined"])
    params = tlt.init_lpformer(torch.Generator().manual_seed(3), cfg, 12,
                               device="cpu")
    for x in optim.tree_leaves(params):
        x.requires_grad_(True)
    with measure.recording_kernel_inputs() as rec:
        _step(dataset, cfg, params)
    assert rec["fwd"] and len(rec["bwd"]) == 2
    plain = (tpam.fused_pe_link_attention_mixed_plain,
             tpam.fused_pe_link_attention_mixed_bwd_plain)
    for a, fn, n_per_link in ([(a, plain[0], 3) for a in rec["fwd"]]
                              + [(a, plain[1], 2) for a in rec["bwd"]]):
        keys = a["keys"]
        assert isinstance(keys, KeyRows) and not keys.table.requires_grad
        dense = dict(a, keys=tpam.dense_keys(keys, a["valid"]))
        for step in (None, 5):
            got = measure.in_link_chunks(fn, a, n_per_link, step)
            want = measure.in_link_chunks(fn, dense, n_per_link, step)
            for x, y in zip(got, want):
                assert torch.equal(x, y)
    for a in rec["bwd"]:
        dense = dict(a, keys=tpam.dense_keys(a["keys"], a["valid"]))
        for x, y in zip(measure.mixed_bwd_f64(**a),
                        measure.mixed_bwd_f64(**dense)):
            assert torch.equal(x, y)
