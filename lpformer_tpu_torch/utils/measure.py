"""Measuring helpers for the card: CUDA-event timing, the kernels' test
inputs at the main-path shape, and their roofline bounds.

Used by chip_smoke.py, ``python -m lpformer_tpu_torch.profile_eval`` and
``python -m lpformer_tpu_torch.profile_train``.
"""
from __future__ import annotations

import contextlib
import inspect
import statistics
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12

# the main-path shape of the fused PE+attention kernel (collab-like)
B, C, O, DH, K = 4096, 128, 128, 128, 3
# the classic table's class blocks at the collab-like per-class budgets
CLASSIC_WIDTHS = (64, 128, 128)
# rows of the context-key table the scatter-add sums into (50,000 nodes
# and the zero pad row)
N_ROWS = 50_001
# the shape of the bench's per-link attention A/B (bench.py:824-871) on the
# collab-like preset: keys [B, C, 2 dim], O = dim, 80% of the slots valid
AB_DK = 2 * O
# the largest [B, C, width] f32 intermediate a PE+attention op's plain
# version takes at once on the card (plain_links)
PLAIN_ELEMS = B * sum(CLASSIC_WIDTHS) * O
# the PE+attention ops' inputs that hold one row per link
PER_LINK = ("keys", "ps", "pt", "valid", "ecls", "q", "m", "l", "g_out",
            "delta")


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them (a card
    set below its maximum limit runs slower under load)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, per: int = 1, warmup: int = 2) -> float:
    """Median over ``reps`` of the CUDA-event time of ``per`` back-to-back
    calls of ``fn``, divided by ``per``. With ``per`` > 1 the host's
    per-call overhead overlaps the device work of the previous call, so a
    kernel shorter than its launch overhead reads as the overhead."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(per):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / per)
    return statistics.median(times)


def trace_device(fn, top: int = 12):
    """Run ``fn`` once under torch.profiler and return (wall ms, device
    busy ms, the ``top`` device kernels as (ms, count, name)). Busy is the
    sum of the CUDA kernels' self time (device rows only: a CPU op's row
    repeats its kernels' time); the profiler's own host overhead is inside
    the wall time, so 1 - busy / wall, the idle share, is an upper bound."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    rows.sort(key=lambda e: -e.self_device_time_total)
    return wall_ms, busy_ms, [(e.self_device_time_total / 1e3, e.count, e.key)
                              for e in rows[:top]]


def print_wrapper_trace(label, fn, card, calls: int = 10) -> None:
    """Trace ``calls`` calls of a kernel wrapper ``fn`` (after one warm-up
    call) and print its device busy time per call and every device kernel
    it launches (its compaction's ops, its memsets, its own kernels), per
    call."""
    fn()
    wall_ms, busy_ms, rows = trace_device(
        lambda: [fn() for _ in range(calls)], top=40)
    print(f"{label} (traced, {calls} calls): device busy "
          f"{busy_ms / calls:.4f} ms/call, wall {wall_ms / calls:.4f} "
          f"ms/call [{card}]")
    for ms, count, name in rows:
        print(f"  {ms / calls:9.4f} ms/call  {count / calls:4.1f}x/call  "
              f"{name[:100]}")


def collab_link_counts(g, b, c):
    """Valid slots per link for a front-compacted row of width c, drawn
    with a realistic spread on the generator's device: 10% of the links
    empty, 80% with 1-8 valid slots, 7% with 9-64 and 3% full."""
    d = dict(generator=g, device=g.device)
    u = torch.rand(b, **d)
    return torch.where(
        u < 0.1, 0, torch.where(
            u < 0.9, torch.randint(1, 9, (b,), **d), torch.where(
                u < 0.97, torch.randint(9, 65, (b,), **d),
                torch.full((b,), c, device=g.device))))


def full_link_counts(g, b, c):
    """Every slot of every link valid: the densest draw, all tiles full."""
    return torch.full((b,), c, device=g.device)


def ddi_link_counts(g, b, c):
    """Valid slots per link at the ddi-like preset's density on the
    combined table of 128 (mean 44.17, p50 36, p99 95; PERF.md section 4),
    drawn on the generator's device: 68% of the links with 8-48 valid
    slots and 32% with 55-95 (mean ~42.6, p50 37, p99 94 at B = 4096);
    the caller clamps them to the row's width c."""
    d = dict(generator=g, device=g.device)
    u = torch.rand(b, **d)
    return torch.where(u < 0.68, torch.randint(8, 49, (b,), **d),
                       torch.randint(55, 96, (b,), **d))


# Valid slots per link on the citation2-like preset's combined table of 96
# (presets.py), quantiles at 0, 5, ..., 100% of one batch of 32768 train
# positives in train mode (masked, attention subsampling): mean 3.87 (a
# batch of the eval sweep's random negative targets: mean 0.25); chip_smoke
# prints both (PERF.md section 4)
CITATION2_COUNT_QUANTILES = (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 2,
                             3, 4, 8, 22, 91)


def citation2_link_counts(g, b, c):
    """Valid slots per link at the citation2-like preset's density, drawn
    on the generator's device from the piecewise-linear inverse of the
    measured distribution (CITATION2_COUNT_QUANTILES; mean ~4.4, the
    straight line from the 95% to the 100% point fattens the tail); the
    caller clamps them to the row's width c."""
    q = torch.tensor(CITATION2_COUNT_QUANTILES, dtype=torch.float32,
                     device=g.device)
    u = torch.rand(b, generator=g, device=g.device) * (len(q) - 1)
    i = u.floor().long().clamp(max=len(q) - 2)
    return (q[i] + (u - i) * (q[i + 1] - q[i])).round().int()


def citation2_like_dataset(device, seed=0):
    """The citation2-like preset's synthetic dataset (presets.py) as the
    citation2 sweep takes it: valid_neg and test_neg replaced by 1000
    negative target ids per positive from a numpy generator of ``seed``,
    and named so that run_eval takes test_citation2 (as
    tests/test_eval_flows.py:68-82 builds its citation2 dataset)."""
    import numpy as np

    from lpformer_tpu_torch.data.synthetic import synthetic_dataset
    from lpformer_tpu_torch.presets import CITATION2_LIKE_DATA

    ds = synthetic_dataset(**CITATION2_LIKE_DATA, device=device)
    rng = np.random.default_rng(seed)
    ds.valid_neg = rng.integers(0, ds.num_nodes, (len(ds.valid_pos), 1000))
    ds.test_neg = rng.integers(0, ds.num_nodes, (len(ds.test_pos), 1000))
    ds.name = "synthetic-citation2-like"
    return ds


# uniform negative pairs each of the ppa-like sweep's valid and test splits
# takes: ogbl-ppa's 3,000,000 shared test negatives, cut to a third to keep
# chip_smoke.py's clock
PPA_LIKE_NEGATIVES = 1_000_000


def ppa_like_dataset(device, seed=0, data=None, negatives=PPA_LIKE_NEGATIVES):
    """The ppa-like preset's synthetic dataset (presets.py; ``data``
    replaces its settings) as the ogbl-ppa sweep takes it: valid_neg and
    test_neg replaced by ``negatives`` uniform node pairs each from a
    numpy generator of ``seed``, named so that run_eval takes
    test_standard, with Hits@100 (cli/run.py:default_metric's ogbl-ppa
    metric) as the dataset's metric."""
    import numpy as np

    from lpformer_tpu_torch.data.synthetic import synthetic_dataset
    from lpformer_tpu_torch.presets import PPA_LIKE_DATA

    ds = synthetic_dataset(**(data or PPA_LIKE_DATA), metric="Hits@100",
                           device=device)
    rng = np.random.default_rng(seed)
    ds.valid_neg = rng.integers(0, ds.num_nodes, (negatives, 2))
    ds.test_neg = rng.integers(0, ds.num_nodes, (negatives, 2))
    ds.name = "synthetic-ppa-like"
    return ds


def _weights(g, valid, b, c, o, dh, k, dtype, ecls):
    """Keys, PPR values, q and K classes' weights around ``valid``, and
    with ``ecls`` a class per valid slot, mixed; drawn on the generator's
    device."""
    d = dict(generator=g, device=g.device)
    r = lambda *s: torch.randn(*s, **d)  # noqa: E731
    a = dict(
        keys=r(b, c, o) * 0.5,
        ps=torch.rand(b, c, **d) * 0.05 * valid,
        pt=torch.rand(b, c, **d) * 0.05 * valid,
        valid=valid,
        **({"ecls": (torch.randint(0, k, (b, c), **d)
                     * valid).int()} if ecls else {}),
        q=r(b, o), w1=r(k, 2, dh), b1=r(k, dh) * 0.1,
        g=1 + 0.1 * r(k, dh), b=0.1 * r(k, dh),
        w2f=r(k, dh, o) / dh ** 0.5, cbias=0.1 * r(k, o),
        att=0.1 * r(1, o), bias=0.1 * r(o),
    )
    a["keys"], a["w2f"] = a["keys"].to(dtype), a["w2f"].to(dtype)
    return a


def kernel_inputs(dev, dtype, seed=0, b=B, c=C, o=O, dh=DH, k=K,
                  counts=collab_link_counts):
    """Inputs of fused_pe_link_attention_mixed, drawn on ``dev`` (the wide
    shapes' inputs take seconds to draw on the host): each link's row
    front-compacted with ``counts``' spread (the collab-like one by
    default, or ``ddi_link_counts``), classes mixed per slot."""
    g = torch.Generator(device=dev).manual_seed(seed)
    valid = (torch.arange(c, device=dev)[None, :]
             < counts(g, b, c).clamp(max=c)[:, None])
    return _weights(g, valid, b, c, o, dh, k, dtype, ecls=True)


def classic_kernel_inputs(dev, dtype, seed=0, b=B, widths=CLASSIC_WIDTHS,
                          o=O, dh=DH):
    """Inputs of fused_pe_link_attention (the classic table, with
    ``class_widths``), drawn on ``dev``: each class block of each link
    front-compacted, its count drawn with ``collab_link_counts``' spread
    for that block's width."""
    g = torch.Generator(device=dev).manual_seed(seed)
    valid = torch.cat([
        torch.arange(w, device=dev)[None, :]
        < collab_link_counts(g, b, w).clamp(max=w)[:, None]
        for w in widths], dim=1)
    a = _weights(g, valid, b, sum(widths), o, dh, len(widths), dtype,
                 ecls=False)
    a["class_widths"] = tuple(widths)
    return a


def key_rows_inputs(a, n, seed=2):
    """The keys of the PE+attention inputs ``a`` (either table) by id, on
    a's device: (``KeyRows`` of a node table [n, O] drawn from ``seed`` in
    a's key dtype and ids [B, C] int32, the valid slots' rows uniform over
    the table's and the dead slots' the pad id n, outside it; the same
    keys gathered into a dense [B, C, O] table, as the dense route
    gathers them: ``gather_rows_valid`` over the table and a zero pad row
    n)."""
    from lpformer_tpu_torch.ops.gather import gather_rows_valid
    from lpformer_tpu_torch.ops.pe_attention_mixed import KeyRows

    valid = a["valid"]
    dev, dtype, o = valid.device, a["keys"].dtype, a["keys"].shape[-1]
    g = torch.Generator(device=dev).manual_seed(seed)
    table = (0.5 * torch.randn(n, o, generator=g, device=dev)).to(dtype)
    ids = torch.randint(0, n, valid.shape, generator=g, device=dev,
                        dtype=torch.int32)
    ids = torch.where(valid, ids, n)
    padded = torch.cat([table, table.new_zeros((1, o))])
    return KeyRows(table, ids), gather_rows_valid(padded, ids, valid)


def kernel_bound_ms(a):
    """Least time for fused_pe_link_attention_mixed on the inputs ``a``:
    the larger of the bytes it must move over HBM bandwidth and its
    operations over the peak rate. Counted for the valid slots only (a dead
    slot's key row, ps, pt and class need not be read): the valid mask, q,
    the weights and the outputs once; per valid slot its key row, ps, pt
    and class; per valid slot 2*dh*O flops for the W2f product (at the
    bf16 tensor rate when the weights are bf16) and ~(12*dh + 8*O) f32
    flops for the rest. Returns (ms, "bytes" or "operations", valid
    slots)."""
    return _fwd_bound(a, slot_bytes=12)


def classic_bound_ms(a):
    """``kernel_bound_ms`` for fused_pe_link_attention on the classic
    table (``classic_kernel_inputs``): the same count without the class
    bytes, which the classic table does not have (a slot's class is its
    column's block)."""
    return _fwd_bound(a, slot_bytes=8)


def _fwd_bound(a, slot_bytes):
    b, c, o = a["keys"].shape
    k, _, dh = a["w1"].shape
    nv = int(a["valid"].sum())
    kb = a["keys"].element_size()
    nbytes = (b * c + 4 * b * o + nv * (o * kb + slot_bytes)
              + 4 * k * dh * 5 + kb * k * dh * o + 4 * (k * o + 2 * o)
              + 4 * b * o + 8 * b)
    return _bound(nbytes, nv * 2 * dh * o, nv * (12 * dh + 8 * o), kb) + (
        nv,)


def _bound(nbytes, mm_flops, f32_flops, kb):
    """(ms, "bytes" or "operations"): the larger of the bytes over HBM
    bandwidth and the operations over their peak rates (matrix products at
    the bf16 tensor rate when their inputs are bf16)."""
    mm_rate = BF16_TENSOR_FLOPS if kb == 2 else F32_FLOPS
    t_ops = mm_flops / mm_rate + f32_flops / F32_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def plain_links(a):
    """Links per call of a PE+attention op's plain version on the inputs
    ``a``, so that its [links, C, max(O, dh)] f32 intermediates stay within
    those of the collab-like classic shape (B = 4096, C = 320, O = dh =
    128), which the card holds; wider shapes run in several calls."""
    b, c, o = a["keys"].shape
    dh = a["w1"].shape[-1]
    return max(1, min(b, PLAIN_ELEMS // (c * max(o, dh))))


def in_link_chunks(fn, a, n_per_link, step=None):
    """``fn(**a)`` in chunks of ``step`` (default ``plain_links(a)``) links:
    the inputs named in PER_LINK are cut along their first axis and the
    rest passed whole; of the results, the first ``n_per_link`` (one row
    per link) are concatenated and the others (sums over links) added. One
    call when the shape fits."""
    b, step = a["keys"].shape[0], step or plain_links(a)
    if step >= b:
        return fn(**a)
    parts = [fn(**{n: _links(v, lo, lo + step) if n in PER_LINK else v
                   for n, v in a.items()}) for lo in range(0, b, step)]
    return tuple(torch.cat(xs) if i < n_per_link else torch.stack(xs).sum(0)
                 for i, xs in enumerate(zip(*parts)))


def _links(v, lo, hi):
    """Links [lo, hi) of a per-link input: its rows, or a ``KeyRows``'
    ids' rows over the whole table."""
    from lpformer_tpu_torch.ops.pe_attention_mixed import KeyRows

    if isinstance(v, KeyRows):
        return KeyRows(v.table, v.ids[lo:hi])
    return v[lo:hi]


def bwd_inputs(a, seed=1):
    """The backward's further inputs for the forward inputs ``a`` (of
    either table): a cotangent g_out [B, O] drawn on a's device from
    ``seed`` and the forward's m, l and delta = g_out . (out - bias), from
    the plain forward there (in chunks of links where the shape is
    wide)."""
    from lpformer_tpu_torch.ops.pe_attention import (
        fused_pe_link_attention_plain,
    )
    from lpformer_tpu_torch.ops.pe_attention_mixed import (
        fused_pe_link_attention_mixed_plain,
    )

    plain = (fused_pe_link_attention_plain if "class_widths" in a
             else fused_pe_link_attention_mixed_plain)
    out, m, l = in_link_chunks(plain, a, 3)
    g = torch.Generator(device=out.device).manual_seed(seed)
    g_out = 0.1 * torch.randn(out.shape, generator=g, device=out.device)
    delta = (g_out * (out - a["bias"])).sum(-1)
    fwd = {k: v for k, v in a.items() if k != "bias"}
    return dict(fwd, m=m, l=l, g_out=g_out, delta=delta)


def classic_bwd_f64(keys, ps, pt, valid, q, w1, b1, g, b, w2f, cbias, att,
                    m, l, g_out, delta, class_widths):
    """The weight grads of ``fused_pe_link_attention_bwd_plain`` (dw1cat,
    dg, db, dw2, dcb) from its own f32 per-slot terms, each sum over slots
    taken in f64, then the same five sums of the terms' magnitudes: a
    witness of the exact sums and of how far any order of f32 additions
    may move them (a chain of n additions errs by at most n 2^-24 of the
    magnitudes' sum). All ten in f64."""
    from lpformer_tpu_torch.ops import pe_attention as pa
    from lpformer_tpu_torch.ops.pe_attention_mixed import (
        attend_backward, ln_backward,
    )

    k_n, _, dh = w1.shape
    o = keys.shape[-1]
    blocks = pa._pe_blocks(ps, pt, w1, b1, g, b, w2f, class_widths)
    xj = pa._keys_xj(keys, cbias, blocks, class_widths)
    dxj, _, _ = attend_backward(xj, valid, q, att, m, l, g_out, delta)
    dxc = dxj.to(w2f.dtype).float()
    f64 = dict(dtype=torch.float64, device=keys.device)
    shapes = ((3 * k_n, dh), (k_n, dh), (k_n, dh), (k_n, dh, o), (k_n, o))
    out = [torch.zeros(s, **f64) for s in shapes + shapes]

    def add(i, k, terms):
        """out[i][k] += sum over slots of the terms, and out[i + 5][k] of
        their magnitudes (terms: f32 [B, w, n] tensors, one per addend)."""
        out[i][k] = sum(t.double().sum((0, 1)) for t in terms)
        out[i + 5][k] = sum(t.double().abs().sum((0, 1)) for t in terms)

    for (k, cols), (dirs, _, _) in zip(pa._blocks(class_widths), blocks):
        (xa, ra, ya, ha), (xb, rb, yb, hb) = dirs
        dx = dxc[:, cols].reshape(-1, o).double()
        add(4, k, (dxj[:, cols],))
        out[3][k] = (ha.reshape(-1, dh).double().T @ dx
                     + hb.reshape(-1, dh).double().T @ dx)
        out[8][k] = (ha.reshape(-1, dh).double().abs().T @ dx.abs()
                     + hb.reshape(-1, dh).double().abs().T @ dx.abs())
        dhh = (dxc[:, cols].reshape(-1, o) @ w2f[k].float().T).reshape(
            ha.shape)
        dya, dyb = dhh * (ya > 0), dhh * (yb > 0)
        add(1, k, (dya * xa, dyb * xb))
        add(2, k, (dya, dyb))
        dpa = ln_backward(dya, xa, ra, g[k])
        dpb = ln_backward(dyb, xb, rb, g[k])
        p0, p1 = ps[:, cols, None], pt[:, cols, None]
        w1s = torch.zeros((3, dh), **f64), torch.zeros((3, dh), **f64)
        for j, terms in enumerate(((p0 * dpa, p1 * dpb), (p1 * dpa, p0 * dpb),
                                   (dpa, dpb))):
            w1s[0][j] = sum(t.double().sum((0, 1)) for t in terms)
            w1s[1][j] = sum(t.double().abs().sum((0, 1)) for t in terms)
        for j in range(3):
            out[0][j * k_n + k] = w1s[0][j]
            out[5][j * k_n + k] = w1s[1][j]
    return tuple(out)


def mixed_bwd_f64(keys, ps, pt, valid, ecls, q, w1, b1, g, b, w2f, cbias,
                  att, m, l, g_out, delta):
    """``classic_bwd_f64`` for ``fused_pe_link_attention_mixed_bwd_plain``
    on the combined table: the per-class sums over slots (dw1cat, dg, db,
    dcb) of its own f32 per-slot terms, each taken in f64, then the same
    four sums of the terms' magnitudes. All eight in f64."""
    from lpformer_tpu_torch.ops.pe_attention_mixed import (
        attend_backward, dense_keys, ln_affine, ln_backward,
    )

    keys = dense_keys(keys, valid)
    k_n, _, dh = w1.shape
    o = keys.shape[-1]
    e = ecls.long()
    w1s, b1s, gs, bs = w1[e], b1[e], g[e], b[e]

    def direction(x0, x1):
        xhat, r, y = ln_affine(x0, x1, w1s[..., 0, :], w1s[..., 1, :], b1s,
                               gs, bs)
        return xhat, r, y, torch.relu(y).to(w2f.dtype).float()

    (xa, ra, ya, ha), (xb, rb, yb, hb) = direction(ps, pt), direction(pt, ps)
    del w1s, b1s, gs, bs
    w2 = w2f.float()
    sels = [e == k for k in range(k_n)]
    pe_a = torch.zeros(keys.shape, dtype=torch.float32, device=keys.device)
    pe_b = torch.zeros_like(pe_a)
    for k, sel in enumerate(sels):
        pe_a[sel] = ha[sel] @ w2[k]
        pe_b[sel] = hb[sel] @ w2[k]
    # xj summed in the plain forward's order
    xj = keys.float() + pe_a + pe_b + cbias[e]
    del pe_a, pe_b
    dxj, _, _ = attend_backward(xj, valid, q, att, m, l, g_out, delta)
    del xj
    f64 = dict(dtype=torch.float64, device=keys.device)
    shapes = ((3 * k_n, dh), (k_n, dh), (k_n, dh), (k_n, o))
    out = [torch.zeros(s, **f64) for s in shapes + shapes]

    def add(i, k, terms):
        """out[i][k] += the sum over the class's slots of the terms, and
        out[i + 4][k] of their magnitudes (terms: f32 [n, W] tensors)."""
        out[i][k] = sum(t.double().sum(0) for t in terms)
        out[i + 4][k] = sum(t.double().abs().sum(0) for t in terms)

    for k, sel in enumerate(sels):
        add(3, k, (dxj[sel],))
        dhh = dxj[sel].to(w2f.dtype).float() @ w2[k].T
        xa_k, xb_k = xa[sel], xb[sel]
        dya, dyb = dhh * (ya[sel] > 0), dhh * (yb[sel] > 0)
        add(1, k, (dya * xa_k, dyb * xb_k))
        add(2, k, (dya, dyb))
        dpa = ln_backward(dya, xa_k, ra[sel], g[k])
        dpb = ln_backward(dyb, xb_k, rb[sel], g[k])
        p0, p1 = ps[sel][:, None], pt[sel][:, None]
        for j, terms in enumerate(((p0 * dpa, p1 * dpb), (p1 * dpa, p0 * dpb),
                                   (dpa, dpb))):
            out[0][j * k_n + k] = sum(t.double().sum(0) for t in terms)
            out[4][j * k_n + k] = sum(t.double().abs().sum(0) for t in terms)
    return tuple(out)


# Most dkeys elements past the tolerance that kink_exempt recomputes; more
# than a handful is not the kink
KINK_MAX = 1024


def kink_exempt(a, got, want, tol):
    """A PE+attention backward's dkeys ``got`` (either table) against its
    plain version's ``want`` on the inputs ``a`` (``bwd_inputs``), with the
    elements at the leaky ReLU's kink set aside. dkeys carries the slope
    lrelu'(xj q), 1 or 0.2, so where xj q lies within the rounding of xj
    of 0 the two sides may take different slopes (xj summed in another
    order in f32, or a flipped bf16 rounding of h upstream) and that one
    element differs by 0.8 of its slope term. Each element past tol * max
    |want| is recomputed in f64 (h rounded to W2f's type, as both sides
    round it): it is at the kink when |xj q| is within the bound on that
    rounding (f32: (2 dh + 2) 2^-24, bf16: 2^-8, times |q| and the sum of
    xj's terms' magnitudes) and ``got`` equals the element under one of
    the two slopes within tol * max |want|. Returns (``got`` with each
    kink element replaced by ``want``'s, the number of them); other
    elements stay as they are, for the caller's check to catch."""
    err = (got.float() - want.float()).abs()
    lim = tol * float(want.float().abs().max())
    idx = (err > lim).flatten().nonzero().flatten()
    if idx.numel() == 0 or idx.numel() > KINK_MAX:
        return got, 0
    _, c, o = a["keys"].shape
    dh = a["w1"].shape[-1]
    lb, lc, lo = idx // (c * o), idx // o % c, idx % o
    if "ecls" in a:
        e = a["ecls"][lb, lc].long().clamp(0, a["w1"].shape[0] - 1)
    else:  # the classic table: a slot's class is its column's block
        e = torch.repeat_interleave(
            torch.arange(len(a["class_widths"]), device=idx.device),
            torch.tensor(a["class_widths"], device=idx.device))[lc]
    f = {n: a[n].double()[e] for n in ("w1", "b1", "g", "b", "cbias")}
    w2 = a["w2f"].double()[e]                               # [n, dh, O]
    x0, x1 = a["ps"][lb, lc].double(), a["pt"][lb, lc].double()

    def hidden(u, v):
        pre = (u[:, None] * f["w1"][:, 0] + v[:, None] * f["w1"][:, 1]
               + f["b1"])
        xc = pre - pre.mean(-1, keepdim=True)
        y = (xc / torch.sqrt((xc * xc).mean(-1, keepdim=True) + 1e-5)
             * f["g"] + f["b"])
        return torch.relu(y).to(a["w2f"].dtype).double()

    ha, hb = hidden(x0, x1), hidden(x1, x0)
    keys = a["keys"][lb, lc].double()                       # [n, O]
    xj = (keys + torch.einsum("nd,ndo->no", ha, w2)
          + torch.einsum("nd,ndo->no", hb, w2) + f["cbias"])
    q = a["q"][lb].double()
    att = a["att"].double().reshape(1, -1)
    pre = xj * q
    s = (torch.where(pre >= 0, pre, 0.2 * pre) * att).sum(-1)
    alpha = (torch.exp(s - a["m"][lb].double())
             / a["l"][lb].double().clamp_min(1e-16))
    g_out = a["g_out"][lb].double()
    dlog = alpha * ((g_out * xj).sum(-1) - a["delta"][lb].double())
    rows = torch.arange(idx.numel(), device=got.device)
    qo = q[rows, lo]
    term = dlog * att[0, lo] * qo
    base = alpha * g_out[rows, lo]
    mag = (keys[rows, lo].abs() + torch.einsum(
        "nd,nd->n", ha.abs() + hb.abs(), w2[rows, :, lo].abs())
        + f["cbias"][rows, lo].abs())
    u = 2.0 ** -8 if a["w2f"].dtype == torch.bfloat16 else (
        (2 * dh + 2) * 2.0 ** -24)
    g_el = got.flatten()[idx].double()
    kink = ((pre[rows, lo].abs() <= u * mag * qo.abs())
            & (torch.minimum((g_el - base - term).abs(),
                             (g_el - base - 0.2 * term).abs()) <= lim))
    out = got.flatten().clone()
    out[idx[kink]] = want.flatten()[idx[kink]].to(got.dtype)
    return out.view_as(got), int(kink.sum())


def bwd_bound_ms(a):
    """Least time for fused_pe_link_attention_mixed_bwd on the inputs ``a``
    (``bwd_inputs``): bytes of the valid mask, q, g_out, m, l, delta and
    the weights once, per valid slot its key row, ps, pt and class, and
    the outputs once: all of dkeys [B, C, O] (dead slots are zero rows),
    dq and the weight grads. Operations per valid slot: three dh x O
    products (the W2f product of the recomputed forward, dh = dxjc
    W2f^T and the dw2 outer product) at the tensor rate of the weights'
    dtype, and ~(40 dh + 30 O) f32 operations for the rest. Returns (ms,
    "bytes" or "operations", valid slots)."""
    return _bwd_bound(a, slot_bytes=12)


def classic_bwd_bound_ms(a):
    """``bwd_bound_ms`` for fused_pe_link_attention_bwd on the classic
    table: the same count without the class bytes; all of dkeys [B, C, O]
    is written once."""
    return _bwd_bound(a, slot_bytes=8)


def _bwd_bound(a, slot_bytes):
    b, c, o = a["keys"].shape
    k, _, dh = a["w1"].shape
    nv = int(a["valid"].sum())
    kb = a["keys"].element_size()
    inputs = (b * c + 2 * 4 * b * o + 3 * 4 * b + nv * (o * kb + slot_bytes)
              + 4 * k * dh * 5 + kb * k * dh * o + 4 * (k * o + o))
    outputs = (b * c * o * kb + 4 * b * o + 4 * k * dh * 5
               + 4 * k * dh * o + 4 * (k * o + o))
    return _bound(inputs + outputs, nv * 3 * 2 * dh * o,
                  nv * (40 * dh + 30 * o), kb) + (nv,)


@contextlib.contextmanager
def recording_kernel_inputs():
    """Inside the block, the model's combined-table op and the context-key
    row sums' scatter append every call's inputs to the lists yielded as
    ``fwd``, ``bwd`` and ``scatter``: the op's forward inputs and its
    backward wrapper's (m, l, the cotangent g_out and delta included), by
    name, detached, the keys in the form the model passed them (the fused
    route's ``KeyRows``); the scatter's (ids, ct, n, live)
    as the key table's gradient passes them (``ops/gather.py:_rows_sum``).
    So a training step run inside gives the kernels' inputs at the tables
    a batch really extracts. The calls still run the real wrappers."""
    from lpformer_tpu_torch.models import link_transformer as lt
    from lpformer_tpu_torch.ops import gather
    from lpformer_tpu_torch.ops import pe_attention_mixed as pam

    rec = {"fwd": [], "bwd": [], "scatter": []}
    fwd_names = list(inspect.signature(
        pam.fused_pe_link_attention_mixed_plain).parameters)
    bwd_names = list(inspect.signature(
        pam.fused_pe_link_attention_mixed_bwd_plain).parameters)
    real_op, real_rows_sum = lt.fused_pe_link_attention_mixed, \
        gather._rows_sum

    def detached(x):
        table, ids = pam.key_parts(x)
        return x.detach() if ids is None else pam.KeyRows(table.detach(),
                                                          ids)

    def named(names, args):
        return {n: detached(x) for n, x in zip(names, args)}

    def bwd(*args):
        rec["bwd"].append(named(bwd_names, args))
        return pam.fused_pe_link_attention_mixed_bwd(*args)

    def op(keys, *args):
        rec["fwd"].append(named(fwd_names, (keys, *args)))
        return pam.MixedOp.apply(pam._fwd, bwd, *pam.key_parts(keys), *args)

    def rows_sum(ids, ct, n, valid):
        if ids.numel() >= gather._SCATTER_MIN_ROWS:    # the scatter's route
            rec["scatter"].append((
                ids.to(torch.int32).contiguous(), ct.detach().contiguous(), n,
                None if valid is None else valid.contiguous()))
        return real_rows_sum(ids, ct, n, valid)

    lt.fused_pe_link_attention_mixed = op
    gather._rows_sum = rows_sum
    try:
        yield rec
    finally:
        lt.fused_pe_link_attention_mixed = real_op
        gather._rows_sum = real_rows_sum


def scatter_inputs(dev, seed=0, b=B, c=C, d=O, n=N_ROWS,
                   counts=collab_link_counts):
    """Inputs of scatter_rows_add at the main-path shape: the [B, C]
    context-key cotangent in bf16, live where kernel_inputs' validity is
    (front-compacted with ``counts``' spread, ~8% of the slots with the
    collab-like default), ids of the live rows drawn with
    weight rank^-0.8 over the n - 1 real rows (the synthetic graph's
    degree law, so hub rows take many adds), dead rows on the pad row
    n - 1 with zero cotangents. Returns (ids [B, C] int32, ct [B, C, d]
    bf16, n, live [B, C] bool)."""
    import numpy as np

    live = kernel_inputs("cpu", torch.float32, seed=seed, b=b, c=c, o=4,
                         dh=4, k=1, counts=counts)["valid"]
    rng = np.random.default_rng(seed)
    w = np.arange(1, n, dtype=np.float64) ** -0.8
    ids = rng.choice(n - 1, size=(b, c), p=w / w.sum()).astype(np.int32)
    ids = torch.where(live, torch.as_tensor(ids), n - 1).to(torch.int32)
    g = torch.Generator().manual_seed(seed)
    ct = (torch.randn(b, c, d, generator=g) * live[..., None]).to(
        torch.bfloat16)
    return ids.to(dev), ct.to(dev), n, live.to(dev)


def scatter_bound_ms(ids, ct, n, live):
    """Least time for scatter_rows_add: the ids and live mask of every row,
    the ct row of every live row and the [n, D] f32 output once; one f32
    add per live element. Returns (ms, "bytes" or "operations", live
    rows)."""
    d = ct.shape[-1]
    nl = int(live.sum())
    nbytes = 5 * ids.numel() + nl * d * ct.element_size() + 4 * n * d
    return _bound(nbytes, 0, nl * d, 4) + (nl,)


def link_attention_inputs(dev, dtype, seed=0, b=B, c=C, dk=AB_DK, o=O):
    """Inputs of fused_link_attention at the bench's A/B shape, drawn on
    ``dev``: keys and q standard normal (the A/B's draws), valid =
    rng(0).random((B, C)) > 0.2 as the A/B has it, glorot-scaled W_r,
    small biases and att; keys and W_r in ``dtype``."""
    import numpy as np

    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    return dict(
        keys=r(b, c, dk).to(dtype), q=r(b, o),
        valid=torch.as_tensor(np.random.default_rng(seed).random((b, c))
                              > 0.2).to(dev),
        w=(r(dk, o) * (2.0 / (dk + o)) ** 0.5).to(dtype),
        r_bias=0.1 * r(o), att=0.1 * r(1, o), bias=0.1 * r(o),
    )


def link_attention_bwd_inputs(a, seed=1):
    """The backward's further inputs for the attention inputs ``a``: a
    cotangent g_out drawn from ``seed`` and the plain forward's m, l and
    delta = g_out . (out - bias)."""
    from lpformer_tpu_torch.ops.attention import fused_link_attention_plain

    out, m, l = fused_link_attention_plain(**a)
    g = torch.Generator(device=out.device).manual_seed(seed)
    g_out = 0.1 * torch.randn(out.shape, generator=g, device=out.device)
    delta = (g_out * (out - a["bias"])).sum(-1)
    fwd = {k: v for k, v in a.items() if k != "bias"}
    return dict(fwd, m=m, l=l, g_out=g_out, delta=delta)


def link_attention_bound_ms(a):
    """Least time for the per-link attention forward on the inputs ``a``
    (``link_attention_inputs``): bytes of the valid mask, q, W_r, the
    vectors and the outputs once, and of each valid slot's key row (a dead
    slot's row need not be read); per valid slot one Dk x O product at the
    tensor rate of the keys' dtype and ~8 O f32 operations. Returns (ms,
    "bytes" or "operations", valid slots)."""
    b, c, dk = a["keys"].shape
    o = a["w"].shape[1]
    nv = int(a["valid"].sum())
    kb = a["keys"].element_size()
    nbytes = (b * c + 4 * b * o + nv * dk * kb + kb * dk * o + 4 * 3 * o
              + 4 * b * o + 8 * b)
    return _bound(nbytes, nv * 2 * dk * o, nv * 8 * o, kb) + (nv,)


def link_attention_bwd_bound_ms(a):
    """Least time for the per-link attention backward on the inputs ``a``
    (``link_attention_inputs`` plus g_out, m, l, delta): the forward's
    inputs, g_out, m, l and delta read once (valid slots' key rows only);
    all of dkeys [B, C, Dk] written once (dead rows are zeros), dq, dW and
    the vectors' grads; per valid slot three Dk x O products (the
    recomputed xj, dkeys and dW) and ~20 O f32 operations."""
    b, c, dk = a["keys"].shape
    o = a["w"].shape[1]
    nv = int(a["valid"].sum())
    kb = a["keys"].element_size()
    inputs = (b * c + 2 * 4 * b * o + 3 * 4 * b + nv * dk * kb
              + kb * dk * o + 4 * 2 * o)
    outputs = b * c * dk * kb + 4 * b * o + 4 * dk * o + 4 * 2 * o
    return _bound(inputs + outputs, nv * 3 * 2 * dk * o, nv * 20 * o,
                  kb) + (nv,)


def lookup_matches(rows, queries):
    """The entries that fused_lookup's sums must add per lane: for each
    distinct query value of a row (equal queries share one sum), the
    row's entries equal to it. A real id matches at most one entry (a
    row's ids are unique); the pad id matches every pad entry of its row,
    once for all of the row's pad queries."""
    srt = rows.sort(dim=1).values.contiguous()
    q = queries.to(srt.dtype).sort(dim=1).values.contiguous()
    hits = torch.searchsorted(srt, q, right=True) - torch.searchsorted(srt, q)
    first = torch.ones_like(q, dtype=torch.bool)
    first[:, 1:] = q[:, 1:] != q[:, :-1]
    return int((hits * first).sum())


def lookup_bound_ms(rows, queries, lanes):
    """Least time for fused_lookup: rows, queries and lanes read once and
    the [B, L, Q] output written once, all int32; B*Q*K compares and one
    add per lane for each entry the sums need (``lookup_matches``),
    counted at the card's non-tensor peak (the f32 rate, an upper bound on
    its int32 rate). Returns (ms, "bytes" or "operations")."""
    b, k = rows.shape
    q, n_l = queries.shape[1], lanes.shape[1]
    nbytes = 4 * (b * k + b * q + b * n_l * k + b * n_l * q)
    return _bound(nbytes, 0,
                  b * q * k + n_l * lookup_matches(rows, queries), 4)
