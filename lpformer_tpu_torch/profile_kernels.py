"""The scatter-add, the fused lookup and the per-link attention pair on
the card, each against its yardsticks, in CUDA-event time and in traced
device time.

    python -m lpformer_tpu_torch.profile_kernels [--link | --kinks]

(``--link``: the per-link attention pair alone; ``--kinks``: item 4
alone.)

1. ``ops/scatter.py:scatter_rows_add`` on chip_smoke.py's main-path inputs
   (``measure.scatter_inputs``: [4096, 128] bf16 cotangent rows, ~8% live,
   ids of the live rows by rank^-0.8 over 50,000 rows) and on a uniform
   draw of the same live rows: the wrapper's event time per call; its
   traced device time per call, the zeroing of the [n, D] output apart
   from the kernel; the bound; and two ``index_add_`` yardsticks, over all
   rows (dead ones on the pad row) and over the live rows compacted
   beforehand; then the kernel alone on both draws, on an output held in
   L2 and on one flushed from it.
2. ``ops/lookup.py:fused_lookup`` at B 4096, K = Q = 256, L = 2 (rows of
   sorted real ids padded with the pad id, half the queries from their
   row) and at ops/masking.py's one query a row: event time and traced
   kernel time, the bound, and the searchsorted route
   (``ops/search.py:row_member_values``) on the same rows and queries.
3. ``ops/attention.py``'s per-link attention pair at the bench's A/B shape
   (``measure.link_attention_inputs``: B 4096, C 128, Dk 256, O 128, 80%
   valid) in f32 and bf16: the forward and backward wrappers' event and
   traced times (the backward's main kernel, its dW kernel and the
   zeroing of its summed outputs apart) beside their bounds, and the
   bench's A/B arms, the op and the torch composition (``att_composition``,
   a yardstick the port never calls), forward and forward + backward,
   traced.

4. With ``--kinks``, ``ops/pe_attention_mixed.py``'s forward and backward
   at the citation2-like widths (B 32768, C 96, O = dh = 64, K 3) with the
   collab-like spread and with every slot valid, f32 and bf16: each
   output's error against the plain version, beside the plain version's
   own against itself with every valid slot's PPR values one ulp up (how
   far a rounding-level change moves each output: the ReLU's and the leaky
   ReLU's slopes flip where their inputs lie within rounding of 0), and
   dkeys once more with its elements at the leaky ReLU's kink held to an
   f64 witness (``measure.kink_exempt``). A measurement: nothing is held
   to a bound.

Items 1-3 hold each result to its plain version first (the lookup bit for
bit).
The script calls only functions that earlier trees of the port have too,
so a copy of this file in such a tree's package measures that tree's
kernels. Needs a CUDA card.
"""
from __future__ import annotations

import os
import sys

import torch

from lpformer_tpu_torch import resolve_device
from lpformer_tpu_torch.ops import lookup, scatter, search
from lpformer_tpu_torch.utils import measure
from lpformer_tpu_torch.utils.measure import card_line, time_ms, trace_device

# Scatter kernel vs plain: f32 sums in another order; an element's error is
# at most (k - 1) 2^-24 sum|terms| for k terms, and the hub rows here take
# thousands, so max |err| is held to 1e-4 of the largest row abs-sum.
SCATTER_TOL = 1e-4
# Per-link attention kernels vs plain: the forward's max |err| on out, m
# and l; the backward's max |err| / max |plain| per output. f32: summation
# order only; bf16: a last-bit difference before a bf16 rounding (xj's
# products in another order, dxj) flips it (2^-8 relative).
LINK_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 2e-2)}


def traced_ms(fn, calls: int = 20, tries: int = 3):
    """Device time per call of ``fn`` from a profiler trace of ``calls``
    calls after one warm-up: (busy ms, [(ms, launches, kernel name)]),
    every device row per call, most time first. The profiler now and then
    records no device activity at all; such a trace is taken again, and
    ``tries`` empty ones raise."""
    fn()
    for _ in range(tries):
        _, busy, rows = trace_device(lambda: [fn() for _ in range(calls)],
                                     top=40)
        if rows:
            return busy / calls, [(ms / calls, count / calls, name)
                                  for ms, count, name in rows]
    raise RuntimeError(f"{tries} traces recorded no device time")


def split_scatter_trace(rows):
    """(kernel ms, zeroing ms) of a traced scatter_rows_add call: the
    scatter kernel's rows, and every other row (the output's zeroing)."""
    kernel = sum(ms for ms, _, name in rows if "scatter_rows_add" in name)
    return kernel, sum(ms for ms, _, name in rows
                       if "scatter_rows_add" not in name)


def uniform_ids(ids, n, live, seed=1):
    """``ids`` with the live rows' ids redrawn uniformly over the n - 1 real
    rows (the dead rows stay on the pad row n - 1)."""
    g = torch.Generator(device=ids.device).manual_seed(seed)
    u = torch.randint(0, n - 1, ids.shape, generator=g, device=ids.device,
                      dtype=torch.int32)
    return torch.where(live, u, ids)


def scatter_report(card, label, ids, ct, n, live, log=print):
    """Check, time and trace one scatter input; log one line and return
    its numbers: err and scale (max |kernel - plain| and the largest row
    abs-sum), ms (event), busy / kernel_ms / zero_ms (traced), all_ms and
    live_ms (the two index_add_ yardsticks), bound and bound_by."""
    got = scatter.scatter_rows_add(ids, ct, n, live)
    want = scatter.scatter_rows_add_plain(ids, ct, n, live)
    scale = float(scatter.scatter_rows_add_plain(ids, ct.float().abs(), n,
                                                 live).max())
    err = float((got - want).abs().max())
    if err > SCATTER_TOL * scale or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"scatter {label}: err {err} > {SCATTER_TOL} x "
                             f"{scale}")
    ms = time_ms(lambda: scatter.scatter_rows_add(ids, ct, n, live), 10,
                 per=10)
    busy, rows = traced_ms(lambda: scatter.scatter_rows_add(ids, ct, n, live))
    kernel_ms, zero_ms = split_scatter_trace(rows)
    d = ct.shape[-1]
    flat_ids, flat_ct = ids.reshape(-1).long(), ct.reshape(-1, d)
    all_ms = time_ms(lambda: torch.zeros((n, d), device=ct.device).index_add_(
        0, flat_ids, flat_ct.float()), 10, per=10)
    keep = live.reshape(-1)
    live_ids, live_ct = flat_ids[keep], flat_ct[keep].float()
    live_ms = time_ms(lambda: torch.zeros((n, d), device=ct.device)
                      .index_add_(0, live_ids, live_ct), 10, per=10)
    bound, bound_by, nl = measure.scatter_bound_ms(ids, ct, n, live)
    hub = int(torch.bincount(live_ids, minlength=n).max())
    log(f"scatter {label}: {nl} live rows of {ids.numel()} (busiest id "
        f"{hub} rows), max abs err {err:.3e} (tol {SCATTER_TOL} x max row "
        f"abs-sum {scale:.1f}); event {ms:.4f} ms/call; traced {busy:.4f} "
        f"ms/call = kernel {kernel_ms:.4f} + zeroing {zero_ms:.4f}; bound "
        f"{bound:.5f} ms ({bound_by}); index_add_ all rows {all_ms:.4f}, "
        f"live rows {live_ms:.4f}  [{card}]")
    for t, count, name in rows:
        log(f"  {t:9.4f} ms/call  {count:4.1f}x/call  {name[:90]}")
    return dict(err=err, scale=scale, ms=ms, busy=busy, kernel_ms=kernel_ms,
                zero_ms=zero_ms, all_ms=all_ms, live_ms=live_ms, bound=bound,
                bound_by=bound_by)


def scatter_kernel_alone(card, label, ids, ct, n, live):
    """The scatter kernel's traced time without the wrapper's zeroing, on
    an output that the previous launch left in L2 (launch after launch)
    and on one evicted from L2 first (a 128 MB buffer zeroed between
    launches): how much of the kernel is the output's trip to device
    memory. Calls the library's C entry directly (the wrapper's
    arguments)."""
    lib = scatter._load()
    d = ct.shape[-1]
    out = torch.zeros((n, d), dtype=torch.float32, device=ct.device)
    flush = torch.empty(32 << 20, dtype=torch.float32, device=ct.device)

    def launch():
        err = lib.scatter_rows_add(
            ids.data_ptr(), ct.data_ptr(), live.data_ptr(), out.data_ptr(),
            ids.numel(), d, n, int(ct.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"scatter_rows_add launch failed: {err}")

    def kernel_ms(rows):
        return split_scatter_trace(rows)[0]

    hot = kernel_ms(traced_ms(launch)[1])
    cold = kernel_ms(traced_ms(lambda: (flush.zero_(), launch()))[1])
    print(f"scatter kernel alone, {label}: {hot:.4f} ms/call with the output "
          f"in L2, {cold:.4f} after L2 was flushed  [{card}]")


def att_composition(keys, q, valid, w, r_bias, att, bias):
    """The other arm of the bench's attention A/B (bench.py:834-842): the
    per-link attention as a composition of torch ops, which materialises
    xj [B, C, O]. A yardstick only; the port never calls it."""
    xj = torch.matmul(keys, w).float() + r_bias
    z = torch.nn.functional.leaky_relu(xj * q[:, None, :], 0.2)
    logits = (z * att.reshape(1, 1, -1)).sum(-1)
    masked = torch.where(valid, logits, -1e30)
    m = masked.amax(1, keepdim=True).clamp_min(-5e29)
    ex = torch.exp(masked - m) * valid
    alpha = ex / ex.sum(1, keepdim=True).clamp_min(1e-16)
    return (alpha[..., None] * xj).sum(1) + bias


def ab_arms(a):
    """The A/B's forward and forward + backward (sum(out^2), grads of keys
    and q, as bench.py:850-856) of the op and of the composition, on the
    inputs ``a`` of ``link_attention_inputs``."""
    from lpformer_tpu_torch.ops.attention import fused_link_attention

    rest = (a["valid"], a["w"], a["r_bias"], a["att"], a["bias"])

    def fwd(impl):
        return lambda: impl(a["keys"], a["q"], *rest)

    def fwd_bwd(impl):
        def run():
            k = a["keys"].detach().requires_grad_(True)
            qq = a["q"].detach().requires_grad_(True)
            out = impl(k, qq, *rest)
            return (out,) + torch.autograd.grad((out ** 2).sum(), (k, qq))
        return run

    return {"op": (fwd(fused_link_attention), fwd_bwd(fused_link_attention)),
            "composition": (fwd(att_composition), fwd_bwd(att_composition))}


def link_attention_report(card, dev, dtype):
    """The per-link attention pair (``ops/attention.py``) at the bench's
    A/B shape (``measure.link_attention_inputs``) in ``dtype``: each
    kernel held to its plain version, then the forward wrapper's and the
    backward wrapper's event and traced times (the backward's main kernel,
    its dW kernel and the output zeroing apart), their bounds, and the
    A/B's two arms, the op and the torch composition, forward and forward
    + backward, traced; print the lines."""
    from lpformer_tpu_torch.ops import attention as at

    a = measure.link_attention_inputs(dev, dtype)
    tol_f, tol_b = LINK_TOL[dtype]
    got, want = at._fwd(**a), at.fused_link_attention_plain(**a)
    err = max(float((x - y).abs().max()) for x, y in zip(got, want))
    b = measure.link_attention_bwd_inputs(a)
    got_b = at.fused_link_attention_bwd(**b)
    want_b = at.fused_link_attention_bwd_plain(**b)
    berrs = {n: float((x.float() - y.float()).abs().max()
                      / y.float().abs().max().clamp_min(1e-30))
             for n, x, y in zip(("dkeys", "dq", "dw", "dr_bias", "datt"),
                                got_b, want_b)}
    berr = max(berrs.values())
    if err > tol_f or berr > tol_b:
        raise AssertionError(f"link attention {dtype}: forward max abs err "
                             f"{err} (tol {tol_f}), backward max rel err "
                             f"{berrs} (tol {tol_b})")
    del got, want, got_b, want_b
    label = str(dtype)[6:]
    fwd_ms = time_ms(lambda: at._fwd(**a), 10, per=20)
    fwd_tr, _ = traced_ms(lambda: at._fwd(**a))
    bwd_ms = time_ms(lambda: at.fused_link_attention_bwd(**b), 10, per=10)
    bwd_tr, rows = traced_ms(lambda: at.fused_link_attention_bwd(**b))
    main_ms = sum(ms for ms, _, n in rows if "link_attention_bwd_kernel" in n)
    dw_ms = sum(ms for ms, _, n in rows if "link_attention_dw_kernel" in n)
    fb, fb_by, nv = measure.link_attention_bound_ms(a)
    bb, bb_by, _ = measure.link_attention_bwd_bound_ms(b)
    print(f"link attention {label} (B={a['keys'].shape[0]} "
          f"C={a['keys'].shape[1]} Dk={a['keys'].shape[2]} "
          f"O={a['w'].shape[1]}, {nv} valid slots): forward max abs err "
          f"{err:.3e}, backward max rel err {berr:.3e}; forward event "
          f"{fwd_ms:.4f} ms, traced {fwd_tr:.4f}, bound {fb:.5f} ({fb_by}); "
          f"backward event {bwd_ms:.4f} ms, traced {bwd_tr:.4f} = main "
          f"{main_ms:.4f} + dW {dw_ms:.4f} + zeroing "
          f"{bwd_tr - main_ms - dw_ms:.4f}, bound {bb:.5f} ({bb_by})  "
          f"[{card}]")
    for arm, (fwd, fwd_bwd) in ab_arms(a).items():
        f_tr, _ = traced_ms(fwd, calls=10)
        fb_tr, _ = traced_ms(fwd_bwd, calls=10)
        print(f"  A/B {label} {arm}: forward traced {f_tr:.4f} ms, forward "
              f"+ backward traced {fb_tr:.4f} ms")


def lookup_inputs(dev, b=4096, k=256, q=256, n_l=2, n=50_000, seed=0):
    """Rows of sorted real ids below n, a random count of them per row and
    the pad id n after; queries half from their row, half uniform over
    [0, n]; lane 0..L-2 random int32 values, the last lane ones (as
    search.fused_row_member_values packs a membership). Returns rows,
    queries, lanes (int32) and the value arrays of the search route."""
    g = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(generator=g, device=dev)
    rows = torch.randint(0, n, (b, k), dtype=torch.int32, **kw).sort(1).values
    m = torch.randint(0, k + 1, (b, 1), **kw)
    rows = torch.where(torch.arange(k, device=dev) < m, rows, n).to(
        torch.int32).contiguous()
    from_row = rows.gather(1, torch.randint(0, k, (b, q), **kw))
    anywhere = torch.randint(0, n + 1, (b, q), dtype=torch.int32, **kw)
    queries = torch.where(torch.rand((b, q), **kw) < 0.5, from_row,
                          anywhere).contiguous()
    vals = [torch.randint(-2 ** 31, 2 ** 31 - 1, (b, k), dtype=torch.int32,
                          **kw) for _ in range(n_l - 1)]
    lanes = torch.stack(vals + [torch.ones_like(rows)], 1).contiguous()
    return rows, queries, lanes, vals


def lookup_report(card, label, rows, queries, lanes, vals):
    """Check, time and trace the lookup at one shape beside the
    searchsorted route; print one line."""
    got = lookup.fused_lookup(rows, queries, lanes)
    if not torch.equal(got, lookup.fused_lookup_plain(rows, queries, lanes)):
        raise AssertionError(f"fused lookup {label} differs from plain")
    ms = time_ms(lambda: lookup.fused_lookup(rows, queries, lanes), 10,
                 per=20)
    busy, _ = traced_ms(lambda: lookup.fused_lookup(rows, queries, lanes))

    def route():
        return search.row_member_values(rows, queries, vals)

    route_ms = time_ms(route, 10, per=20)
    route_busy, _ = traced_ms(route)
    bound, bound_by = measure.lookup_bound_ms(rows, queries, lanes)
    b, k = rows.shape
    print(f"lookup {label} B={b} K={k} Q={queries.shape[1]} "
          f"L={lanes.shape[1]}: bit-exact; kernel event {ms:.4f} ms, traced "
          f"{busy:.4f}; searchsorted route event {route_ms:.4f}, traced "
          f"{route_busy:.4f}; bound {bound:.5f} ms ({bound_by})  [{card}]")


BWD_NAMES = ("dkeys", "dq", "dw1cat", "dg", "db", "dw2", "dcb", "datt")


def _rel(x, y):
    """(max |x - y| / max |y|, mean |x - y| / mean |y|) in f32."""
    d, w = (x.float() - y.float()).abs(), y.float().abs()
    return (float(d.max() / w.max().clamp_min(1e-30)),
            float(d.mean() / w.mean().clamp_min(1e-30)))


def _fwd_errs(x, y):
    """max |err| of out and m, max |err| and max relative err of l (as
    chip_smoke.py's forward check: over max(|l|, 1))."""
    dl = (x[2] - y[2]).abs()
    return (f"out {float((x[0] - y[0]).abs().max()):.3e}, m "
            f"{float((x[1] - y[1]).abs().max()):.3e}, l {float(dl.max()):.3e}"
            f" (rel {float((dl / y[2].abs().clamp_min(1.0)).max()):.3e})")


def kink_report(card, dev):
    """Item 4 of the module's docstring."""
    from lpformer_tpu_torch.ops import pe_attention_mixed as pam

    fwd_plain = pam.fused_pe_link_attention_mixed_plain
    bwd_plain = pam.fused_pe_link_attention_mixed_bwd_plain
    draws = (("collab-like spread", measure.collab_link_counts),
             ("every slot valid", measure.full_link_counts))
    for label, counts in draws:
        for dtype in (torch.float32, torch.bfloat16):
            a = measure.kernel_inputs(dev, dtype, b=32768, c=96, o=64, dh=64,
                                      counts=counts)
            up = torch.tensor(float("inf"), device=dev)
            nudged = {n: torch.where(a["valid"], torch.nextafter(a[n], up),
                                     a[n]) for n in ("ps", "pt")}
            head = (f"kinks {str(dtype)[6:]} {label} (B=32768 C=96 O=64 "
                    f"dh=64, {int(a['valid'].sum())} valid slots)")
            got = pam.fused_pe_link_attention_mixed(**a)
            want = measure.in_link_chunks(fwd_plain, a, 3)
            moved = measure.in_link_chunks(fwd_plain, dict(a, **nudged), 3)
            print(f"{head} forward: kernel vs plain {_fwd_errs(got, want)}; "
                  f"plain one ulp up vs plain {_fwd_errs(moved, want)}")
            del got, moved
            a = measure.bwd_inputs(a)
            got = pam.fused_pe_link_attention_mixed_bwd(**a)
            want = measure.in_link_chunks(bwd_plain, a, 2)
            moved = measure.in_link_chunks(bwd_plain, dict(a, **nudged), 2)
            tol = 1e-4 if dtype == torch.float32 else 2e-2
            dkeys, n_kink = measure.kink_exempt(a, got[0], want[0], tol)
            fmt = lambda xs: ", ".join(  # noqa: E731
                f"{n} {r[0]:.2e}/{r[1]:.2e}" for n, r in zip(
                    BWD_NAMES, (_rel(x, y) for x, y in zip(xs, want))))
            print(f"{head} backward (max/mean rel err): kernel vs plain "
                  f"{fmt(got)}; plain one ulp up vs plain {fmt(moved)}; "
                  f"kernel dkeys with {n_kink} elements at the kink held to "
                  f"the f64 witness (past {tol} of max |dkeys| before) "
                  f"{_rel(dkeys, want[0])[0]:.2e}/"
                  f"{_rel(dkeys, want[0])[1]:.2e}  [{card}]", flush=True)
            del a, got, want, moved, dkeys
            torch.cuda.empty_cache()


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    dev = resolve_device()
    card = card_line()
    if "--link" in args:        # the per-link attention pair alone
        for dtype in (torch.float32, torch.bfloat16):
            link_attention_report(card, dev, dtype)
        return
    if "--kinks" in args:
        kink_report(card, dev)
        return
    os.environ.pop("LPFORMER_FUSED_LOOKUP", None)   # the search route below
    ids, ct, n, live = measure.scatter_inputs(dev)
    draws = (("rank^-0.8 ids", ids), ("uniform ids", uniform_ids(ids, n, live)))
    for label, i in draws:
        scatter_report(card, label, i, ct, n, live)
    for label, i in draws:
        scatter_kernel_alone(card, label, i, ct, n, live)
    rows, queries, lanes, vals = lookup_inputs(dev)
    lookup_report(card, "main", rows, queries, lanes, vals)
    lookup_report(card, "one query a row", rows, queries[:, :1].contiguous(),
                  lanes, vals)
    for dtype in (torch.float32, torch.bfloat16):
        link_attention_report(card, dev, dtype)


if __name__ == "__main__":
    main()
