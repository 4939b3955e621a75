"""A torch mirror of the per-link attention's chunk kernels
(``csrc/link_attention_tiles.cuh`` with ``csrc/link_attention_fwd.cu`` and
``csrc/link_attention_bwd.cu``), held to the port's plain versions
(``ops/attention.py:fused_link_attention_plain`` and ``_bwd_plain``) and,
through them, to the JAX package's Pallas op in interpret mode.

The mirror runs the kernels' algorithm on the CPU: each link's list of
valid columns, chunks of ts rows zero-padded (rows past the count, Dk and
O padded to 16), X = K W_r per chunk, the online softmax carried across a
link's chunks, the backward's per-chunk dxj rounded to the keys' type
before both products, dkeys written for the valid rows and zeros for the
dead ones, and dW as a split-K sum: blocks of links, each queueing its
links' valid slots and taking them 64 at a time. The kernels take chunks
of 128 rows, or of 64 where the wide tiles do not fit in shared memory
(``link_layout``); the mirror runs both.

Inputs: six links with a random 85% of slots valid, none, exactly ts,
exactly one, all, and ts + 1 (clamped to C); C of 150 and 300 (three and
five chunks of 64 for the full link, two and three of 128), Dk and O of
no multiple of 16.

Tolerances as ``tests/test_torch_attention.py``: f32 rtol 1e-4 / atol
1e-5 (summation order only); bf16 keys rtol 2e-2 / atol 2e-3 (a last-bit
difference before the dxj rounding flips it).
"""
import numpy as np
import pytest
import torch

from test_torch_attention import DIFF, TOL, _cot, _jax, _torch

from lpformer_tpu_torch.ops import attention as tatt

TS = (64, 128)   # rows of a chunk (link_attention_tiles.cuh: LinkSmem.ts)
DW_SLOTS = 64    # slots the dW kernel takes at a time (kDwSlots)
NEG = -1e30
# (C, Dk, O): three and five chunks for the full link, one chunk and a part
SHAPES = [(150, 20, 12), (300, 24, 36), (70, 33, 17)]


def _pad16(n):
    return (n + 15) // 16 * 16


def _inputs(c, dk, o, seed, ts):
    rng = np.random.default_rng(seed)
    valid = np.zeros((6, c), bool)
    valid[0] = rng.random(c) < 0.85
    for b, count in ((2, ts), (3, 1), (4, c), (5, ts + 1)):
        valid[b, rng.permutation(c)[:min(count, c)]] = True
    return dict(
        keys=rng.standard_normal((6, c, dk)).astype(np.float32),
        q=rng.standard_normal((6, o)).astype(np.float32),
        valid=valid,
        w_r=(rng.standard_normal((dk, o)) / dk ** 0.5).astype(np.float32),
        r_bias=(0.1 * rng.standard_normal(o)).astype(np.float32),
        att=(0.3 * rng.standard_normal((1, o))).astype(np.float32),
        bias=(0.1 * rng.standard_normal(o)).astype(np.float32),
    )


def _args(a, bf16):
    """The kernels' arguments (keys, q, valid, w, r_bias, att, bias) as
    ``prepare`` gives them."""
    t = {n: torch.as_tensor(v) for n, v in a.items()}
    return tatt.prepare(t["keys"].to(torch.bfloat16) if bf16 else t["keys"],
                        t["q"], t["valid"], t["w_r"], t["r_bias"], t["att"],
                        t["bias"])


def _padded_w(w):
    dk, o = w.shape
    wp = torch.zeros(_pad16(dk), _pad16(o))
    wp[:dk, :o] = w.float()
    return wp


def _chunk_xj(keys_b, cols, wp, r_bias, q_b, att, ts):
    """The chunk prologue: key rows [ts, pad16(Dk)] (zeros past the count
    and past Dk), X = K W_r, xj = X + r_bias over the n rows, and their
    logits."""
    n, dk = len(cols), keys_b.shape[-1]
    o = r_bias.shape[0]
    k = torch.zeros(ts, wp.shape[0])
    k[:n, :dk] = keys_b[cols].float()
    x = (k @ wp)[:n, :o] + r_bias
    pre = x * q_b
    s = (att.reshape(-1) * torch.where(pre >= 0, pre, 0.2 * pre)).sum(-1)
    return x, s


def _chunks(valid_b, ts):
    cols = torch.nonzero(valid_b).flatten()
    return [cols[i:i + ts] for i in range(0, len(cols), ts)]


def mirror_fwd(keys, q, valid, w, r_bias, att, bias, ts):
    """The forward kernel's algorithm: (out [B, O], m [B], l [B])."""
    wp = _padded_w(w)
    outs, ms, ls = [], [], []
    for b in range(keys.shape[0]):
        m, l = torch.tensor(NEG / 2), torch.tensor(0.0)
        acc = torch.zeros(w.shape[1])
        for cols in _chunks(valid[b], ts):
            x, s = _chunk_xj(keys[b], cols, wp, r_bias, q[b], att, ts)
            m1 = torch.maximum(m, s.max())
            corr = torch.exp(m - m1)
            e = torch.exp(s - m1)
            l = l * corr + e.sum()
            acc = acc * corr + e @ x
            m = m1
        outs.append(acc / torch.clamp(l, min=1e-16) + bias)
        ms.append(m)
        ls.append(l)
    return torch.stack(outs), torch.stack(ms), torch.stack(ls)


def mirror_bwd(keys, q, valid, w, r_bias, att, m, l, g_out, delta, ts,
               links_per_block=2):
    """The backward kernels' algorithm: (dkeys in the keys' type, dq, dw,
    dr_bias, datt [1, O]); dW split over blocks of ``links_per_block``
    links."""
    bsz, c, dk = keys.shape
    o = w.shape[1]
    kdt = keys.dtype
    wp = _padded_w(w)
    dkeys = torch.full(keys.shape, float("nan")).to(kdt)
    dxc = torch.zeros((bsz, c, o), dtype=kdt)      # the kernel's scratch
    dq = torch.zeros(bsz, o)
    datt = torch.zeros(o)
    drb = torch.zeros(o)
    for b in range(bsz):
        dkeys[b, ~valid[b]] = 0
        for cols in _chunks(valid[b], ts):
            x, s = _chunk_xj(keys[b], cols, wp, r_bias, q[b], att, ts)
            alpha = torch.exp(s - m[b]) / torch.clamp(l[b], min=1e-16)
            dlog = alpha * (x @ g_out[b] - delta[b])
            pre = x * q[b]
            dpre = (dlog[:, None] * att.reshape(-1)
                    * torch.where(pre >= 0, 1.0, 0.2))
            dxj = alpha[:, None] * g_out[b] + dpre * q[b]
            dq[b] += (dpre * x).sum(0)
            datt += (dlog[:, None] * torch.where(pre >= 0, pre, 0.2 * pre)
                     ).sum(0)
            drb += dxj.sum(0)
            dxjc = dxj.to(kdt)
            d = torch.zeros(ts, wp.shape[1])
            d[:len(cols), :o] = dxjc.float()
            dkeys[b, cols] = (d @ wp.T)[:len(cols), :dk].to(kdt)
            dxc[b, cols] = dxjc
    dw = torch.zeros(dk, o)
    for b0 in range(0, bsz, links_per_block):
        part = torch.zeros(dk, o)
        queue = []
        for b in range(b0, min(bsz, b0 + links_per_block)):
            queue += [(b, int(cc)) for cc in torch.nonzero(valid[b])]
            while len(queue) >= DW_SLOTS:
                part += _dw_batch(keys, dxc, queue[:DW_SLOTS])
                queue = queue[DW_SLOTS:]
        if queue:
            part += _dw_batch(keys, dxc, queue)
        dw += part
    return dkeys, dq, dw, drb, datt.reshape(1, o)


def _dw_batch(keys, dxc, slots):
    """keys^T dxjc over a batch of at most DW_SLOTS slots, zero-padded."""
    k = torch.zeros(DW_SLOTS, keys.shape[-1])
    d = torch.zeros(DW_SLOTS, dxc.shape[-1])
    for r, (b, c) in enumerate(slots):
        k[r] = keys[b, c].float()
        d[r] = dxc[b, c].float()
    return k.T @ d


def _bwd_args(args, seed):
    keys, q, valid, w, r_bias, att, bias = args
    out, m, l = tatt.fused_link_attention_plain(*args)
    g_out = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        out.shape).astype(np.float32))
    delta = (g_out * (out - bias)).sum(-1)
    return (keys, q, valid, w, r_bias, att, m, l, g_out, delta)


@pytest.mark.parametrize("ts", TS)
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("c,dk,o", SHAPES)
def test_mirror_forward_matches_plain(c, dk, o, bf16, ts):
    args = _args(_inputs(c, dk, o, seed=c, ts=ts), bf16)
    got = mirror_fwd(*args, ts)
    want = tatt.fused_link_attention_plain(*args)
    for name, x, y in zip(("out", "m", "l"), got, want):
        torch.testing.assert_close(x, y, msg=name, **TOL[bf16])
    # a link with no valid slot: the bias, m = -5e29, l = 0
    assert torch.equal(got[0][1], args[6])
    assert got[1][1] == torch.tensor(NEG / 2) and float(got[2][1]) == 0.0


@pytest.mark.parametrize("ts", TS)
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("c,dk,o", SHAPES)
def test_mirror_backward_matches_plain(c, dk, o, bf16, ts):
    args = _args(_inputs(c, dk, o, seed=c + 1, ts=ts), bf16)
    bargs = _bwd_args(args, seed=c)
    want = tatt.fused_link_attention_bwd_plain(*bargs)
    for per in (1, 4):
        got = mirror_bwd(*bargs, ts, links_per_block=per)
        for name, x, y in zip(("dkeys", "dq", "dw", "dr_bias", "datt"), got,
                              want):
            assert x.dtype == y.dtype, name
            torch.testing.assert_close(x.float(), y.float(), msg=name,
                                       **TOL[bf16])
        # every dead slot's dkeys row is written, as zeros
        assert not got[0][~args[2]].float().any()


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("c,dk,o", SHAPES)
def test_plain_matches_pallas_on_chunk_cases(c, dk, o, bf16):
    """The plain versions, which the mirror and the card kernels are held
    to, against the JAX Pallas op on the chunk cases (interpret mode)."""
    a = _inputs(c, dk, o, seed=c + 2, ts=64)
    g_out = _cot(a, c)
    jo, jg = _jax(a, g_out, bf16)
    to, tg = _torch(a, g_out, bf16)
    np.testing.assert_allclose(to, jo, **TOL[bf16])
    for n in DIFF:
        np.testing.assert_allclose(tg[n], jg[n], err_msg=n, **TOL[bf16])
