"""The port's fused one-hot lookup (``ops/lookup.py:fused_lookup``) and the
opt-in lookup route of ``ops/search.py`` (``LPFORMER_FUSED_LOOKUP=1``)
against the JAX package's (``lpformer_tpu.ops.pallas.lookup.fused_lookup``
and ``lpformer_tpu.ops.search.fused_row_member_values``, Pallas in
interpret mode on the CPU).

Everything here is exact: int32 sums with wraparound, f32 values riding
their bit patterns. On CPU tensors ``fused_lookup`` runs its plain
version; the route itself is on only for CUDA tensors, so the route
tests switch it on for CPU tensors by patching the gate and count the
calls that took it. The CUDA kernel is held to the plain version on the
card (the ``cuda``-marked test here, and chip_smoke.py at the
context-extraction shapes).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpformer_tpu.data.synthetic import synthetic_dataset as jax_synthetic
from lpformer_tpu.ops import masking as jmask
from lpformer_tpu.ops import search as jsearch
from lpformer_tpu.ops.pallas import lookup as jlookup
from lpformer_tpu_torch.data.synthetic import synthetic_dataset
from lpformer_tpu_torch.ops import context as tctx
from lpformer_tpu_torch.ops import lookup as tlookup
from lpformer_tpu_torch.ops import masking as tmask
from lpformer_tpu_torch.ops import search as tsearch

N = 50          # real ids 0..N-1, pad id N
# (B, K, Q, L): small rows; K past one 128-lane tile; more lanes than the
# kernel sums per pass
SHAPES = [(6, 9, 12, 1), (5, 130, 17, 2), (4, 33, 40, 5)]


def _rows(rng, b, k):
    """Sorted unique real ids per row, padded with N (at least 2 pads in
    most rows, so a pad query sums several entries)."""
    rows = np.full((b, k), N, np.int32)
    for i in range(b):
        m = int(rng.integers(0, min(k, N) + 1))
        rows[i, :m] = np.sort(rng.choice(N, m, replace=False))
    return rows


def _case(b, k, q, n_l, seed):
    rng = np.random.default_rng(seed)
    rows = _rows(rng, b, k)
    queries = rng.integers(0, N + 1, (b, q)).astype(np.int32)   # incl. pads
    queries[0, 0] = N
    # full-range lanes, so the pad queries' sums wrap around
    lanes = rng.integers(-2 ** 31, 2 ** 31, (b, n_l, k),
                         dtype=np.int64).astype(np.int32)
    lanes[0, 0, -3:] = 2 ** 31 - 1          # a sure wraparound
    return rows, queries, lanes


@pytest.mark.parametrize("b,k,q,n_l", SHAPES)
def test_plain_matches_pallas_bit_for_bit(b, k, q, n_l):
    rows, queries, lanes = _case(b, k, q, n_l, seed=b * k)
    want = np.asarray(jlookup.fused_lookup(
        jnp.asarray(rows), jnp.asarray(queries), jnp.asarray(lanes),
        interpret=True))
    got = tlookup.fused_lookup(torch.as_tensor(rows), torch.as_tensor(queries),
                               torch.as_tensor(lanes))
    assert got.dtype == torch.int32 and got.shape == (b, n_l, q)
    np.testing.assert_array_equal(got.numpy(), want)
    if k >= 9 and (rows[0] == N).sum() >= 3:
        # the pad query of row 0 wrapped around
        assert got[0, 0, 0] == np.int32(np.int64(lanes[0, 0][rows[0] == N]
                                                 .astype(np.int64).sum())
                                        .astype(np.int32))


@pytest.mark.parametrize("b,k,q,n_l", SHAPES)
def test_bound_counts_the_matches_of_its_inputs(b, k, q, n_l):
    """lookup_bound_ms counts one add per lane for each entry that matches
    a distinct query value of its row (equal queries, the pads among them,
    share one sum), not one for every (b, q, k)."""
    from lpformer_tpu_torch.utils import measure

    rows, queries, lanes = _case(b, k, q, n_l, seed=b * k)
    want = sum(int((rows[i] == v).sum()) for i in range(b)
               for v in np.unique(queries[i]))
    assert want < int((queries[:, :, None] == rows[:, None, :]).sum())
    r, qq = torch.as_tensor(rows), torch.as_tensor(queries)
    assert measure.lookup_matches(r, qq) == want
    ops = b * q * k + n_l * want
    nbytes = 4 * (b * k + b * q + b * n_l * k + b * n_l * q)
    ms, by = measure.lookup_bound_ms(r, qq, torch.as_tensor(lanes))
    assert ms == pytest.approx(1e3 * max(ops / measure.F32_FLOPS,
                                         nbytes / measure.HBM_BYTES_PER_S))
    assert by == ("bytes" if nbytes / measure.HBM_BYTES_PER_S
                  >= ops / measure.F32_FLOPS else "operations")


def test_wrap_int32():
    x = torch.tensor([0, 2 ** 31 - 1, 2 ** 31, 2 ** 32 + 5, -1, -2 ** 31 - 1],
                     dtype=torch.int64)
    want = x.numpy().astype(np.int32)       # numpy wraps modulo 2^32
    np.testing.assert_array_equal(tlookup.wrap_int32(x).numpy(), want)


def _values(rng, rows):
    """A f32 array (0 on the pads, as PaddedRows keeps them), an int array
    and a bool array over the rows."""
    pad = rows == N
    f = np.where(pad, 0, rng.random(rows.shape)).astype(np.float32)
    i = np.where(pad, 0, rng.integers(0, 2 ** 30, rows.shape)).astype(
        np.int32)
    return f, i, ~pad & (rng.random(rows.shape) < 0.5)


def test_fused_row_member_values_matches_jax():
    """The port's fused route equals the JAX package's on real queries,
    for f32, int and bool value arrays, with and without defaults."""
    rng = np.random.default_rng(2)
    rows = _rows(rng, 7, 40)
    queries = rng.integers(0, N, (7, 23)).astype(np.int32)      # real ids
    vals = _values(rng, rows)
    for defaults in ((), (-1.0, -7, None)):
        jf, jv = jsearch.fused_row_member_values(
            jnp.asarray(rows), jnp.asarray(queries),
            [jnp.asarray(v) for v in vals], defaults, interpret=True)
        tf, tv = tsearch.fused_row_member_values(
            torch.as_tensor(rows), torch.as_tensor(queries),
            [torch.as_tensor(v) for v in vals], defaults)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        for x, y in zip(tv, jv):
            assert x.numpy().dtype == np.asarray(y).dtype
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_both_routes_agree_on_real_queries():
    """Bit for bit between the fused route and the searchsorted route,
    wherever a query is a real id."""
    rng = np.random.default_rng(3)
    rows = torch.as_tensor(_rows(rng, 9, 30))
    queries = torch.as_tensor(rng.integers(0, N, (9, 31)).astype(np.int32))
    vals = [torch.as_tensor(v) for v in _values(rng, rows.numpy())]
    for defaults in ((), (-1.0, -7, None)):
        f1, v1 = tsearch.fused_row_member_values(rows, queries, vals,
                                                 defaults)
        f2, v2 = tsearch.row_member_values(rows, queries, vals, defaults)
        assert torch.equal(f1, f2)
        for x, y in zip(v1, v2):
            assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.fixture
def fused_route(monkeypatch):
    """Turn the fused route on for CPU tensors; yields the list of the
    calls that took it."""
    calls = []
    real = tsearch.fused_row_member_values

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(tsearch, "fused_lookup_enabled", lambda rows: True)
    monkeypatch.setattr(tsearch, "fused_row_member_values", counted)
    return calls


def test_gate_needs_the_variable_and_a_cuda_tensor(monkeypatch):
    rows = torch.zeros((2, 3), dtype=torch.int32)
    monkeypatch.delenv("LPFORMER_FUSED_LOOKUP", raising=False)
    assert not tsearch.fused_lookup_enabled(rows)
    monkeypatch.setenv("LPFORMER_FUSED_LOOKUP", "1")
    assert not tsearch.fused_lookup_enabled(rows)     # a CPU tensor
    meta = torch.empty((2, 3), dtype=torch.int32, device="meta")
    assert not tsearch.fused_lookup_enabled(meta)


KW = dict(seed=0, num_nodes=80, num_train=300, num_eval=24, feat_dim=4,
          eps=1e-3)
FIELDS = ("ids", "cls", "valid", "counts", "overflow", "src_ppr", "tgt_ppr")


@pytest.fixture(scope="module")
def both():
    return jax_synthetic(**KW), synthetic_dataset(**KW, device="cpu")


def _tables(td, links, cfg, train):
    src, tgt = (torch.as_tensor(links[:, i]) for i in (0, 1))
    mr = None
    if train:
        w = torch.ones(len(links))
        mr = tmask.batch_mask_ranks(td.graph.adj_rows, src, tgt,
                                    td.mask_mult_device, weight=w)
    return tctx.extract_context(td.graph.adj_rows, td.graph.ppr_rows, src,
                                tgt, cfg, mask_ranks=mr, train=train)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("kw", [
    dict(budget_combined=96), dict(budget_combined=4),
    dict(budget_cn=48, budget_onehop=96, budget_non1hop=96),
])
def test_extract_context_identical_on_both_routes(both, fused_route, kw,
                                                  train):
    """Eval-mode and train-mode (batch masking) context tables, combined
    and classic, are the same on both routes; and they equal the JAX
    package's on its default route."""
    jd, td = both
    cfg = tctx.ContextConfig.from_thresholds(
        thresh_cn=0.0, thresh_1hop=1e-3, thresh_non1hop=1e-3, **kw)
    links = np.concatenate([jd.train_pos[:40], jd.valid_neg, [[5, 5]]])
    fused = _tables(td, links, cfg, train)
    # extraction in mask mode "all": 6 lookups; batch masking: 2 more
    assert len(fused_route) == 6 + 2 * train
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsearch, "fused_lookup_enabled", lambda rows: False)
        default = _tables(td, links, cfg, train)
    assert len(fused_route) == 6 + 2 * train
    for f in FIELDS:
        assert torch.equal(getattr(fused, f), getattr(default, f)), f
    if not train:
        from lpformer_tpu.ops import context as jctx
        jcfg = jctx.ContextConfig.from_thresholds(
            thresh_cn=0.0, thresh_1hop=1e-3, thresh_non1hop=1e-3, **kw)
        j = jctx.extract_context(
            jd.graph.adj_rows, jd.graph.ppr_rows, jnp.asarray(links[:, 0]),
            jnp.asarray(links[:, 1]), jcfg, train=False)
        for f in FIELDS:
            np.testing.assert_array_equal(
                np.asarray(getattr(j, f)), getattr(fused, f).numpy(),
                err_msg=f)
    else:
        # the masked ranks themselves, on both routes, as the JAX package's
        src, tgt = (torch.as_tensor(links[:, i]) for i in (0, 1))
        w = torch.ones(len(links))
        got = tmask.batch_mask_ranks(td.graph.adj_rows, src, tgt,
                                     td.mask_mult_device, weight=w)
        want = jmask.batch_mask_ranks(
            jd.graph.adj_rows, jnp.asarray(links[:, 0]),
            jnp.asarray(links[:, 1]), jd.mask_mult_device,
            weight=jnp.ones(len(links)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrapper_runs_plain_on_cpu_tensors():
    rows, queries, lanes = (torch.as_tensor(x)
                            for x in _case(4, 33, 40, 5, seed=0))
    before = tlookup.fused_lookup.launches
    got = tlookup.fused_lookup(rows, queries, lanes)
    assert torch.equal(got, tlookup.fused_lookup_plain(rows, queries, lanes))
    assert tlookup.fused_lookup.launches == before
    assert tlookup._LIB is None


@pytest.mark.parametrize("name,bad,err", [
    ("rows", lambda t: t.long(), TypeError),
    ("lanes", lambda t: t[:, 0], ValueError),
    ("queries", lambda t: t[:-1], ValueError),
    ("lanes", lambda t: t.transpose(1, 2).contiguous().transpose(1, 2),
     ValueError),
])
def test_kernel_input_checks(name, bad, err):
    a = dict(zip(("rows", "queries", "lanes"),
                 (torch.as_tensor(x) for x in _case(4, 33, 40, 5, seed=0))))
    tlookup._check(**a)
    a[name] = bad(a[name])
    with pytest.raises(err):
        tlookup._check(**a)


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,q,n_l", SHAPES + [(4096, 256, 256, 2),
                                                (4096, 2000, 3, 6)])
def test_kernel_matches_plain_on_card(b, k, q, n_l):
    """Bit for bit, pads and wraparound included; the last shape runs past
    the kernel's 1024-entry staging chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(b + k)
    rows = np.sort(rng.integers(0, 4 * k, (b, k)), axis=1).astype(np.int32)
    queries = rng.integers(0, 4 * k, (b, q)).astype(np.int32)
    lanes = rng.integers(-2 ** 31, 2 ** 31, (b, n_l, k),
                         dtype=np.int64).astype(np.int32)
    t = [torch.as_tensor(x).cuda() for x in (rows, queries, lanes)]
    before = tlookup.fused_lookup.launches
    got = tlookup.fused_lookup(*t)
    torch.cuda.synchronize()
    assert tlookup.fused_lookup.launches == before + 1
    assert torch.equal(got, tlookup.fused_lookup_plain(*t))
