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
import zlib

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


# ---- the kernel's hash tables, mirrored on the CPU --------------------------

I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1
EMPTY = np.uint64(2 ** 64 - 1)


def _bucket(ids, log2h):
    """The kernel's multiplicative hash of int32 ids (numpy arrays)."""
    x = ids.astype(np.int64).astype(np.uint64) & np.uint64(0xFFFFFFFF)
    x = (x * np.uint64(tlookup.HASH_MULT)) & np.uint64(0xFFFFFFFF)
    return (x >> np.uint64(32 - log2h)).astype(np.int64)


def mirror_hash_lookup(rows, queries, lanes):
    """csrc/fused_lookup.cu in numpy, pass for pass as ``hash_plan`` cuts
    it: per row and chunk of queries, a table of 2^log2h 64-bit keys (the
    id zero-extended, all ones empty) filled with the queries by linear
    probing from the multiplicative hash (a repeated query finds its
    slot); lanes_per_pass lanes at a time, every entry probes the table
    and an entry that finds its id adds its lanes into that slot in
    uint32 (repeated entries sum); each query then reads its slot.
    Returns (out int32 [B, L, Q], the longest probe run)."""
    b, k = rows.shape
    q, n_l = queries.shape[1], lanes.shape[1]
    chunk, log2h, per_pass, _ = tlookup.hash_plan(k, q, n_l)
    h = 1 << log2h
    out = np.zeros((b, n_l, q), np.int32)
    longest = 0

    def keys_of(ids):
        return ids.astype(np.int64).astype(np.uint64) & np.uint64(0xFFFFFFFF)

    def probe(keys, key, s, claim):
        nonlocal longest
        run = 0
        while keys[s] != key and keys[s] != EMPTY:
            s, run = (s + 1) % h, run + 1
        longest = max(longest, run)
        if keys[s] == EMPTY:
            if not claim:
                return -1
            keys[s] = key
        return s

    for i in range(b):
        e_keys, e_buckets = keys_of(rows[i]), _bucket(rows[i], log2h)
        for q0 in range(0, q, chunk):
            ids = queries[i, q0:q0 + chunk]
            keys = np.full(h, EMPTY, np.uint64)
            q_slots = [probe(keys, kk, s, True)
                       for kk, s in zip(keys_of(ids), _bucket(ids, log2h))]
            e_slots = [probe(keys, kk, s, False)
                       for kk, s in zip(e_keys, e_buckets)]
            for l0 in range(0, n_l, per_pass):
                nl = min(per_pass, n_l - l0)
                sums = np.zeros((nl, h), np.uint32)
                vals = lanes[i, l0:l0 + nl].view(np.uint32)
                for j, s in enumerate(e_slots):
                    if s >= 0:
                        sums[:, s] += vals[:, j]
                out[i, l0:l0 + nl, q0:q0 + chunk] = sums[:, q_slots].view(
                    np.int32)
    return out, longest


def _full_lanes(rng, b, n_l, k):
    return rng.integers(I32_MIN, I32_MAX + 1, (b, n_l, k),
                        dtype=np.int64).astype(np.int32)


def _colliding_ids(log2h, count, start=-3000):
    """``count`` distinct int32 ids that all hash to one bucket."""
    cand = np.arange(start, start + ((2 * count + 16) << log2h),
                     dtype=np.int64)
    hit = cand[_bucket(cand.astype(np.int32), log2h) == 0][:count]
    assert len(hit) == count
    return hit.astype(np.int32)


def _hash_case(name):
    """(rows, queries, lanes) of one named case: all int32."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "repeats_and_pad_runs":
        rows = rng.integers(0, 12, (5, 40)).astype(np.int32)
        rows[:, 25:] = N                      # a pad run
        rows[1] = 7                           # one id over the whole row
        queries = rng.integers(0, 14, (5, 30)).astype(np.int32)
        queries[:, :3] = N
        return rows, queries, _full_lanes(rng, 5, 3, 40)
    if name == "one_bucket":
        k = 40
        log2h = tlookup.hash_plan(k, 24, 2)[1]
        ids = _colliding_ids(log2h, k + 12)
        rows = np.stack([rng.permutation(ids[:k]) for _ in range(3)])
        queries = np.stack([rng.choice(ids, 24, replace=False)
                            for _ in range(3)])
        return rows, queries.astype(np.int32), _full_lanes(rng, 3, 2, k)
    if name == "extreme_ids":
        special = np.array([I32_MIN, I32_MAX, -1, -2, 0, N], np.int32)
        rows = np.concatenate([np.repeat(special, 3)[None].repeat(4, 0),
                               rng.integers(0, N, (4, 14))], 1).astype(
            np.int32)
        for r in rows:
            rng.shuffle(r)
        queries = np.concatenate([special[None].repeat(4, 0),
                                  rng.integers(-3, N + 2, (4, 10))], 1)
        return rows, queries.astype(np.int32), _full_lanes(rng, 4, 2, 32)
    if name == "wrapping_sums":
        rows = np.full((3, 20), 9, np.int32)
        rows[:, 10:] = N
        queries = np.array([[9, N, 1, 9]] * 3, np.int32)
        lanes = np.full((3, 2, 20), I32_MAX, np.int32)
        lanes[:, 1] = I32_MIN
        return rows, queries, lanes
    if name == "q1":
        rows = _rows(rng, 6, 70)
        for r in rows:
            rng.shuffle(r)
        queries = rows[:, 3:4].copy()
        queries[0, 0] = N + 3                     # absent
        return rows, queries, _full_lanes(rng, 6, 2, 70)
    if name.startswith("q_"):     # q_one_chunk, q_chunk_plus_1, ...
        n_l = 6 if name == "q_chunks_l6" else 2
        q = {"q_one_chunk": tlookup.MAX_CHUNK,
             "q_chunk_plus_1": tlookup.MAX_CHUNK + 1,
             "q_several_chunks": 3 * tlookup.MAX_CHUNK - 5,
             "q_chunks_l6": 1500}[name]
        rows = rng.integers(-5, 400, (2, 300)).astype(np.int32)
        queries = rng.integers(-5, 400, (2, q)).astype(np.int32)
        return rows, queries, _full_lanes(rng, 2, n_l, 300)
    if name == "k_long":          # many entries stream past a few queries
        rows = rng.integers(-5, 5000, (2, 3000)).astype(np.int32)
        queries = np.concatenate([rows[:, ::97], rng.integers(
            -5, 5000, (2, 20))], 1).astype(np.int32)
        return rows, queries, _full_lanes(rng, 2, 3, 3000)
    if name.startswith("lanes_"):
        n_l = int(name.split("_")[1])
        rows = rng.integers(0, 30, (4, 23)).astype(np.int32)
        queries = rng.integers(-1, 32, (4, 19)).astype(np.int32)
        return rows, queries, _full_lanes(rng, 4, n_l, 23)
    if name == "b0":
        return (np.zeros((0, 7), np.int32), np.zeros((0, 5), np.int32),
                np.zeros((0, 2, 7), np.int32))
    if name == "q0":
        return (rng.integers(0, 9, (3, 7)).astype(np.int32),
                np.zeros((3, 0), np.int32), _full_lanes(rng, 3, 2, 7))
    raise KeyError(name)


HASH_CASES = (["repeats_and_pad_runs", "one_bucket", "extreme_ids",
               "wrapping_sums", "q1", "q_one_chunk", "q_chunk_plus_1",
               "q_several_chunks", "q_chunks_l6", "k_long"]
              + [f"lanes_{n}" for n in range(1, 7)] + ["b0", "q0"])


@pytest.mark.parametrize("name", HASH_CASES)
def test_hash_mirror_matches_plain_and_pallas(name):
    """The kernel's algorithm (a hash table of each row's queries per
    chunk, every entry probing it, repeats summed in their slot in uint32)
    gives fused_lookup_plain's bits and
    the JAX kernel's (interpret mode; it takes no B = 0 or Q = 0 call, so
    those two cases hold to the plain version and the shape alone)."""
    rows, queries, lanes = _hash_case(name)
    b, k = rows.shape
    q, n_l = queries.shape[1], lanes.shape[1]
    got, longest = mirror_hash_lookup(rows, queries, lanes)
    plain = tlookup.fused_lookup_plain(torch.as_tensor(rows),
                                       torch.as_tensor(queries),
                                       torch.as_tensor(lanes)).numpy()
    assert got.shape == plain.shape == (b, n_l, q)
    np.testing.assert_array_equal(got, plain)
    if b and q:
        want = np.asarray(jlookup.fused_lookup(
            jnp.asarray(rows), jnp.asarray(queries), jnp.asarray(lanes),
            interpret=True))
        np.testing.assert_array_equal(got, want)
    chunk = tlookup.hash_plan(k, q, n_l)[0]
    if name == "one_bucket":
        assert longest >= 23                   # 24 queries in one run
    if name == "q_one_chunk":
        assert chunk == q
    if name in ("q_chunk_plus_1", "q_several_chunks", "q_chunks_l6"):
        assert -(-q // chunk) == {"q_chunk_plus_1": 2, "q_several_chunks": 3,
                                  "q_chunks_l6": 2}[name]
    if name == "wrapping_sums":                # 10 x INT32_MAX wraps
        assert got[0, 0, 0] == np.int32(np.int64(10 * I32_MAX)
                                        .astype(np.int32))


@pytest.mark.parametrize("k,q,n_l", [(1, 1, 1), (9, 12, 1), (256, 256, 2),
                                     (256, 1, 2), (20, 1500, 6),
                                     (4, 600, 8), (4096, 4096, 20),
                                     (7, 0, 2)])
def test_hash_plan_fits_the_block(k, q, n_l):
    """Every plan fits 48 KB of shared memory a block, keeps the table at
    most half full, cuts Q only into 16-byte aligned chunks, and passes
    the lanes at most MAX_LANES at a time."""
    chunk, log2h, per_pass, rpb = tlookup.hash_plan(k, q, n_l)
    assert 1 <= chunk <= max(1, min(q, tlookup.MAX_CHUNK))
    assert (1 << log2h) >= 2 * chunk and (1 << (log2h - 1)) < 2 * chunk \
        or log2h == 1
    assert chunk == max(q, 1) or chunk % 4 == 0
    assert per_pass == min(n_l, tlookup.MAX_LANES)
    assert rpb in (1, 2, 4, 8)
    assert rpb * (1 << log2h) * (8 + 4 * per_pass) <= tlookup.SMEM_BYTES


def test_kernel_source_shares_the_plan_constants():
    """The CUDA source's hash and limits are those the mirror and
    hash_plan use."""
    import os

    from lpformer_tpu_torch.ops._cuda import CSRC

    src = open(os.path.join(CSRC, "fused_lookup.cu")).read()
    assert f"kHashMult = 0x{tlookup.HASH_MULT:08X}u;" in src
    assert f"kSmemBytes = {tlookup.SMEM_BYTES // 1024} * 1024;" in src
    assert f"kThreads = {tlookup.THREADS};" in src
    assert f"kMaxLanes = {tlookup.MAX_LANES};" in src


def _card_case(name):
    """Inputs of the card test: the CPU cases, the earlier random shapes
    (sorted rows), unsorted rows with repeats, and the main-path shapes."""
    if name in HASH_CASES:
        return _hash_case(name)
    b, k, q, n_l = {"s9": (6, 9, 12, 1), "s130": (5, 130, 17, 2),
                    "s33": (4, 33, 40, 5), "main": (4096, 256, 256, 2),
                    "wide": (4096, 2000, 3, 6), "unsorted": (512, 300, 77, 3),
                    "masking_q1": (4096, 256, 1, 2)}[name]
    rng = np.random.default_rng(b + k)
    rows = rng.integers(0, 4 * k, (b, k)).astype(np.int32)
    if name != "unsorted":
        rows = np.sort(rows, axis=1)
    queries = rng.integers(0, 4 * k, (b, q)).astype(np.int32)
    return rows, queries, _full_lanes(rng, b, n_l, k)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["s9", "s130", "s33", "main", "wide",
                                  "unsorted", "masking_q1"] + HASH_CASES)
def test_kernel_matches_plain_on_card(name):
    """Bit for bit, pads, repeats and wraparound included; "wide" runs
    several chunks of the row, "unsorted" draws rows in no order with
    repeats, "masking_q1" is ops/masking.py's one query a row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    t = [torch.as_tensor(x).cuda() for x in _card_case(name)]
    before = tlookup.fused_lookup.launches
    got = tlookup.fused_lookup(*t)
    torch.cuda.synchronize()
    assert tlookup.fused_lookup.launches == before + 1
    assert torch.equal(got, tlookup.fused_lookup_plain(*t))
