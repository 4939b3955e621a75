"""The scatter-add and the fused lookup on the card, each against its
yardsticks, in CUDA-event time and in traced device time.

    python -m lpformer_tpu_torch.profile_kernels

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

Each result is first held to its plain version (the lookup bit for bit).
The script calls only functions that earlier trees of the port have too,
so a copy of this file in such a tree's package measures that tree's
kernels. Needs a CUDA card.
"""
from __future__ import annotations

import os

import torch

from lpformer_tpu_torch import resolve_device
from lpformer_tpu_torch.ops import lookup, scatter, search
from lpformer_tpu_torch.utils import measure
from lpformer_tpu_torch.utils.measure import card_line, time_ms, trace_device

# Scatter kernel vs plain: f32 sums in another order; an element's error is
# at most (k - 1) 2^-24 sum|terms| for k terms, and the hub rows here take
# thousands, so max |err| is held to 1e-4 of the largest row abs-sum.
SCATTER_TOL = 1e-4


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


def main() -> None:
    dev = resolve_device()
    card = card_line()
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


if __name__ == "__main__":
    main()
