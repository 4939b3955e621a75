"""The port's fused PE + attention op over the classic class-blocked table
against the JAX package's Pallas kernel pair
(``lpformer_tpu.ops.pallas.pe_attention``, interpret mode on the CPU).

On CPU tensors the port's op runs its plain forward and plain backward, so
these tests hold the plain versions to the TPU kernels, and the plain
backward to autograd through the plain forward at widths no TPU tile
divides (12 / 40 / 20, which the JAX package routes to its XLA path); the
CUDA kernels are held to the plain versions on the card
(``test_kernels_match_plain_on_card`` here, and chip_smoke.py at the
main-path shape).

Tolerances. float32: the two sides differ only in summation order: rtol
1e-4 / atol 1e-5. bf16 keys and W2f: both sides round the hidden
activation and the key cotangent to bf16 at the same points, but a
last-bit difference in an f32 value just before a rounding flips it (2^-8
relative), and a flipped dxjc enters dW2f and the LayerNorm grads: rtol
2e-2 / atol 2e-3 on the output and every grad. That bound also covers the
one deliberate difference: the JAX backward rounds each C-tile's bf16
dW2f before summing a class's tiles, the port sums a class in f32 and
rounds once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pe_attention_mixed_bwd import (
    assert_close_card, assert_close_scaled,
)

from lpformer_tpu.ops.pallas import pe_attention as jpa
from lpformer_tpu_torch.ops import pe_attention as tpa
from lpformer_tpu_torch.ops import pe_attention_mixed as tpam
from lpformer_tpu_torch.utils import measure

B, O, DH = 8, 16, 16
ALIGNED = (16, 32, 32)      # one 16-slot TPU tile divides every width
MISALIGNED = (12, 40, 20)
# (O, dh) beyond the main path's 128: a dim-256 layer; the first layer of
# trans_layers=2 at dim 128; widths of no power of two, the last with a
# ragged 4-column group (O % 4 != 0)
WIDTHS = [(256, 256), (256, 128), (72, 40), (70, 36)]
DIFF = ("keys", "q", "w1", "b1", "g", "b", "w2f", "cbias", "att", "bias")
ORDER = ("keys", "ps", "pt", "valid", "q", "w1", "b1", "g", "b", "w2f",
         "cbias", "att", "bias")


def _inputs(widths, seed, bf16=False, o=O, dh=DH):
    """Random validity (not a prefix of each block), with one empty link
    and one full link; O = o output columns, dh = dh hidden units."""
    rng = np.random.default_rng(seed)
    k, c = len(widths), sum(widths)
    valid = rng.random((B, c)) < 0.4
    valid[1] = False
    valid[4] = True
    a = dict(
        keys=rng.standard_normal((B, c, o)).astype(np.float32) * 0.5,
        ps=(rng.random((B, c)) * 0.1).astype(np.float32) * valid,
        pt=(rng.random((B, c)) * 0.1).astype(np.float32) * valid,
        valid=valid,
        q=rng.standard_normal((B, o)).astype(np.float32),
        w1=rng.standard_normal((k, 2, dh)).astype(np.float32),
        b1=rng.standard_normal((k, dh)).astype(np.float32) * 0.1,
        g=(1 + 0.1 * rng.standard_normal((k, dh))).astype(np.float32),
        b=(0.1 * rng.standard_normal((k, dh))).astype(np.float32),
        w2f=(rng.standard_normal((k, dh, o)) / dh ** 0.5).astype(np.float32),
        cbias=(0.1 * rng.standard_normal((k, o))).astype(np.float32),
        att=rng.standard_normal((1, o)).astype(np.float32) * 0.3,
        bias=(0.1 * rng.standard_normal(o)).astype(np.float32),
    )
    if bf16:  # round once, so both sides see the same values
        for n in ("keys", "w2f"):
            a[n] = np.array(jnp.asarray(a[n], jnp.bfloat16).astype(jnp.float32))
    return a


def _torch_args(a, bf16=False):
    t = {n: torch.as_tensor(v) for n, v in a.items()}
    if bf16:
        t["keys"] = t["keys"].to(torch.bfloat16)
        t["w2f"] = t["w2f"].to(torch.bfloat16)
    return t


def _tiles(widths):
    ct = jpa.pe_attention_tile(widths, min_tile=8)
    assert ct > 0
    return ct, tuple(k for k, w in enumerate(widths) for _ in range(w // ct))


def _jax_fwd(a, widths, bf16=False):
    """JAX out, m and l: the public entry's argument preparation, then the
    forward pallas_call (the public entry returns out only)."""
    kdt = jnp.bfloat16 if bf16 else jnp.float32
    ct, tiles = _tiles(widths)
    sel = jnp.asarray(tiles)
    tile = lambda x: jnp.asarray(x, jnp.float32).reshape(  # noqa: E731
        B, -1, ct).swapaxes(0, 1)
    j = {n: jnp.asarray(v) for n, v in a.items()}
    out, m, l = jpa._fwd_call(
        j["keys"].astype(kdt), tile(a["ps"]), tile(a["pt"]),
        tile(a["valid"]), j["q"], j["w1"][sel], j["b1"][sel][:, None],
        j["g"][sel][:, None], j["b"][sel][:, None],
        j["w2f"][sel].astype(kdt), j["cbias"][sel][:, None], j["att"],
        j["bias"], B, ct, True)
    public = jpa.fused_pe_link_attention(
        j["keys"].astype(kdt), *(j[n] for n in ORDER[1:9]),
        j["w2f"].astype(kdt), j["cbias"], j["att"], j["bias"], c_tile=ct,
        tile_classes=tiles, interpret=True)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(public))
    return np.asarray(out), np.asarray(m)[:, 0], np.asarray(l)[:, 0]


def _cot(seed, o=O):
    return np.random.default_rng(100 + seed).standard_normal(
        (B, o)).astype(np.float32)


def _jax_grads(a, widths, g_out, bf16=False):
    kdt = jnp.bfloat16 if bf16 else jnp.float32
    ct, tiles = _tiles(widths)
    fixed = {n: jnp.asarray(a[n]) for n in ("ps", "pt", "valid")}

    def f(*diff):
        kw = dict(zip(DIFF, diff), **fixed)
        return jpa.fused_pe_link_attention(
            *(kw[n] for n in ORDER), c_tile=ct, tile_classes=tiles,
            interpret=True)

    prim = [jnp.asarray(a[n], kdt if n in ("keys", "w2f") else jnp.float32)
            for n in DIFF]
    out, vjp = jax.vjp(f, *prim)
    grads = vjp(jnp.asarray(g_out))
    return np.asarray(out), {n: np.asarray(v.astype(jnp.float32))
                             for n, v in zip(DIFF, grads)}


def _torch_grads(a, widths, g_out, bf16=False, op=None):
    t = _torch_args(a, bf16=bf16)
    for n in DIFF:
        t[n].requires_grad_(True)
    out, _, _ = (op or tpa.fused_pe_link_attention)(
        *(t[n] for n in ORDER), class_widths=widths)
    out.backward(torch.as_tensor(g_out))
    return out.detach().numpy(), {n: t[n].grad for n in DIFF}


@pytest.mark.parametrize("widths", [ALIGNED, (48,)])
def test_plain_matches_pallas_f32(widths):
    a = _inputs(widths, seed=len(widths))
    jo, jm, jl = _jax_fwd(a, widths)
    to, tm, tl = tpa.fused_pe_link_attention_plain(**_torch_args(a),
                                                   class_widths=widths)
    np.testing.assert_allclose(to.numpy(), jo, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tm.numpy(), jm, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-4, atol=1e-5)
    # the empty link gets exactly the bias and the initial statistics
    np.testing.assert_array_equal(to[1].numpy(), a["bias"])
    assert tm[1] == -5e29 and tl[1] == 0


def test_plain_matches_pallas_bf16():
    a = _inputs(ALIGNED, seed=7, bf16=True)
    jo, jm, jl = _jax_fwd(a, ALIGNED, bf16=True)
    to, tm, tl = tpa.fused_pe_link_attention_plain(
        **_torch_args(a, bf16=True), class_widths=ALIGNED)
    np.testing.assert_allclose(to.numpy(), jo, rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(tm.numpy(), jm, rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("widths", [ALIGNED, (48,)])
def test_grads_match_pallas_vjp_f32(widths):
    a = _inputs(widths, seed=3 + len(widths))
    g_out = _cot(len(widths))
    jo, jg = _jax_grads(a, widths, g_out)
    to, tg = _torch_grads(a, widths, g_out)
    np.testing.assert_allclose(to, jo, rtol=1e-4, atol=1e-5)
    for n in DIFF:
        assert tg[n].dtype == torch.float32
        np.testing.assert_allclose(tg[n].numpy(), jg[n], rtol=1e-4,
                                   atol=1e-5, err_msg=n)


def test_grads_match_pallas_vjp_bf16():
    a = _inputs(ALIGNED, seed=11, bf16=True)
    g_out = _cot(11)
    _, jg = _jax_grads(a, ALIGNED, g_out, bf16=True)
    _, tg = _torch_grads(a, ALIGNED, g_out, bf16=True)
    for n in DIFF:
        # the grads of bf16 inputs are bf16, as dw2.astype(w2.dtype)
        want_dtype = torch.bfloat16 if n in ("keys", "w2f") else torch.float32
        assert tg[n].dtype == want_dtype, n
        np.testing.assert_allclose(tg[n].float().numpy(), jg[n], rtol=2e-2,
                                   atol=2e-3, err_msg=n)


@pytest.mark.parametrize("o,dh", WIDTHS)
def test_plain_matches_pallas_at_widths(o, dh):
    """Any O and dh, forward and every grad, f32: rtol 1e-4 / atol 1e-5 of
    each output's scale (``assert_close_scaled``)."""
    a = _inputs(ALIGNED, seed=o + dh, o=o, dh=dh)
    jo, jm, jl = _jax_fwd(a, ALIGNED)
    to, tm, tl = tpa.fused_pe_link_attention_plain(**_torch_args(a),
                                                   class_widths=ALIGNED)
    np.testing.assert_allclose(to.numpy(), jo, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tm.numpy(), jm, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-4, atol=1e-5)
    g_out = _cot(o, o=o)
    jo, jg = _jax_grads(a, ALIGNED, g_out)
    to, tg = _torch_grads(a, ALIGNED, g_out)
    assert_close_scaled(to, jo, 1e-4, 1e-5)
    for n in DIFF:
        assert_close_scaled(tg[n].numpy(), jg[n], 1e-4, 1e-5, n)


@pytest.mark.parametrize("widths", [MISALIGNED, (0, 40, 20)])
def test_plain_bwd_matches_autograd_at_any_widths(widths):
    """In f32 the hand-written backward equals autograd through the plain
    forward's torch ops, at widths no TPU tile divides and with an empty
    class block; dead slots get zero dkeys."""
    a = _inputs(widths, seed=4)
    g_out = _cot(4)
    _, ours = _torch_grads(a, widths, g_out)
    _, auto = _torch_grads(
        a, widths, g_out,
        op=lambda *t, class_widths: tpa.fused_pe_link_attention_plain(
            *t, class_widths))
    for n in DIFF:
        torch.testing.assert_close(ours[n], auto[n], rtol=1e-4, atol=1e-5,
                                   msg=n)
    assert bool((ours["keys"][~torch.as_tensor(a["valid"])] == 0).all())


def test_plain_matches_mixed_op_on_block_classes():
    """The classic op equals the combined table's op fed the same slots
    with each slot's class spelled out, forward and every grad."""
    a = _inputs(MISALIGNED, seed=9)
    ecls = torch.as_tensor(np.repeat(np.arange(3), MISALIGNED)).int()
    g_out = _cot(9)
    to, tg = _torch_grads(a, MISALIGNED, g_out)

    def mixed(keys, ps, pt, valid, *rest, class_widths):
        return tpam.fused_pe_link_attention_mixed(
            keys, ps, pt, valid, ecls.expand(B, -1).contiguous(), *rest)

    mo, mg = _torch_grads(a, MISALIGNED, g_out, op=mixed)
    np.testing.assert_allclose(to, mo, rtol=1e-5, atol=1e-6)
    for n in DIFF:
        torch.testing.assert_close(tg[n], mg[n], rtol=1e-4, atol=1e-5, msg=n)


def test_wrappers_run_plain_on_cpu_tensors():
    """No build and no launch for CPU tensors: the results are the plain
    versions', and the module imports and runs without nvcc."""
    t = _torch_args(_inputs(MISALIGNED, seed=0))
    before = (tpa.fused_pe_link_attention.launches,
              tpa.fused_pe_link_attention_bwd.launches)
    got = tpa.fused_pe_link_attention(**t, class_widths=MISALIGNED)
    out, m, l = tpa.fused_pe_link_attention_plain(**t,
                                                  class_widths=MISALIGNED)
    for x, y in zip(got, (out, m, l)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    g_out = torch.as_tensor(_cot(0))
    args = [t[n] for n in ORDER[:-1]] + [m, l, g_out,
                                         (g_out * (out - t["bias"])).sum(-1)]
    got = tpa.fused_pe_link_attention_bwd(*args, MISALIGNED)
    want = tpa.fused_pe_link_attention_bwd_plain(*args, MISALIGNED)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert (tpa.fused_pe_link_attention.launches,
            tpa.fused_pe_link_attention_bwd.launches) == before
    assert tpa._LIB is None and tpa._LIB_BWD is None


@pytest.mark.parametrize("widths", [(12, 40), (12, 40, 21), (12, -1, 61)])
def test_class_widths_refused(widths):
    t = _torch_args(_inputs(MISALIGNED, seed=0))
    with pytest.raises(ValueError, match="class_widths"):
        tpa.fused_pe_link_attention(**t, class_widths=widths)


@pytest.mark.parametrize("name,bad,err", [
    ("w2f", lambda t: t.to(torch.bfloat16), TypeError),  # keys are f32
    ("valid", lambda t: t.int(), TypeError),
    ("q", lambda t: t[:, :-1], ValueError),
    ("keys", lambda t: t.transpose(0, 1).contiguous().transpose(0, 1),
     ValueError),
    ("w1", lambda t: torch.cat([t, t]), ValueError),     # K = 6
])
def test_kernel_input_checks(name, bad, err):
    """What the CUDA wrappers refuse before a launch (the checks do not
    depend on the device, so CPU tensors exercise them)."""
    t = _torch_args(_inputs(MISALIGNED, seed=0))
    tpa._check(*t.values())
    t[name] = bad(t[name])
    with pytest.raises(err):
        tpa._check(*t.values())


def _class0_count(a, widths, n):
    """Make class 0 (the first ``widths[0]`` columns) hold exactly n valid
    slots, the first n of its block in (link, column) order."""
    valid = a["valid"]
    block = np.zeros(valid.shape[0] * widths[0], dtype=bool)
    block[:n] = True
    valid[:, :widths[0]] = block.reshape(valid.shape[0], -1)
    for nm in ("ps", "pt"):
        a[nm] = a[nm] * valid
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "class TS+1", "all dead"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("o,dh", [(O, DH)] + WIDTHS)
def test_kernels_match_plain_on_card(bf16, o, dh, case):
    """Both kernels against their plain versions; with "class TS+1" class
    0 holds one slot more than a tile, with "all dead" no slot is valid.
    Both wrappers run under ``set_sync_debug_mode("error")``: a host
    synchronisation in them (a ``.item()``, a ``nonzero``) fails the
    test."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = _inputs(MISALIGNED, seed=5, bf16=bf16, o=o, dh=dh)
    if case == "class TS+1":
        a = _class0_count(a, MISALIGNED, tpa.tile_slots(o, dh) + 1)
    if case == "all dead":
        a["valid"][:] = False
        a["ps"][:] = a["pt"][:] = 0
    t = {n: v.cuda() for n, v in _torch_args(a, bf16=bf16).items()}
    before = (tpa.fused_pe_link_attention.launches,
              tpa.fused_pe_link_attention_bwd.launches)
    tpa._load()          # the builds synchronise; the wrappers must not
    tpa._load_bwd()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tpa.fused_pe_link_attention(**t, class_widths=MISALIGNED)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out, m, l = tpa.fused_pe_link_attention_plain(**t,
                                                  class_widths=MISALIGNED)
    g_out = torch.as_tensor(_cot(5, o=o)).cuda()
    args = [t[n] for n in ORDER[:-1]] + [m, l, g_out,
                                         (g_out * (out - t["bias"])).sum(-1)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got_b = tpa.fused_pe_link_attention_bwd(*args, MISALIGNED)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert (tpa.fused_pe_link_attention.launches,
            tpa.fused_pe_link_attention_bwd.launches) == (before[0] + 1,
                                                          before[1] + 1)
    want_b = tpa.fused_pe_link_attention_bwd_plain(*args, MISALIGNED)
    tol = 2e-2 if bf16 else 1e-4
    for x, y in zip(got_b, want_b):
        assert x.dtype == y.dtype
    if (o, dh) == (O, DH):
        for x, y in zip(got + got_b, (out, m, l) + want_b):
            torch.testing.assert_close(x.float(), y.float(), rtol=tol,
                                       atol=tol / 10)
    else:
        for x, y in zip(got + got_b, (out, m, l) + want_b):
            assert_close_card(x, y, tol)


def _classic_xj(a, monkeypatch):
    """The classic plain forward's xj [B, C, O] on the inputs ``a``."""
    seen = []
    attend = tpa.attend

    def keep(xj, *rest):
        seen.append(xj)
        return attend(xj, *rest)

    monkeypatch.setattr(tpa, "attend", keep)
    tpa.fused_pe_link_attention_plain(**a)
    monkeypatch.setattr(tpa, "attend", attend)
    return seen[0]


def test_kink_exempt_takes_the_classic_table(monkeypatch):
    """As the combined table's test: a dkeys element of a slot in the
    second class block, on either side of the leaky ReLU's kink, is found
    and held to the witness with that block's encoder; an element moved
    elsewhere stays."""
    a = measure.classic_kernel_inputs(torch.device("cpu"), torch.float32,
                                      b=8, widths=(8, 4, 4), o=16, dh=16)
    a["valid"][:, 8] = True     # column 8 opens the second block
    b0, c0 = 2, 8
    o0 = int((a["att"][0] * a["q"][b0]).abs().argmax())
    keys = {}
    for sign in (1.0, -1.0):
        k = a["keys"].clone()
        k[b0, c0, o0] -= _classic_xj(a, monkeypatch)[b0, c0, o0]
        for _ in range(64):
            x = float(_classic_xj(dict(a, keys=k), monkeypatch)[b0, c0, o0])
            if (x > 0) if sign > 0 else (x < 0):
                break
            k[b0, c0, o0] = torch.nextafter(k[b0, c0, o0],
                                            torch.tensor(sign * 1e30))
        assert abs(x) < 1e-6
        keys[sign] = k
    bi = measure.bwd_inputs(dict(a, keys=keys[1.0]))
    want = tpa.fused_pe_link_attention_bwd_plain(**bi)[0]
    got = tpa.fused_pe_link_attention_bwd_plain(
        **dict(bi, keys=keys[-1.0]))[0]
    lim = 1e-4 * float(want.abs().max())
    assert float((got - want).abs()[b0, c0, o0]) > lim   # the slope flipped
    got[(b0 + 1) % 8, 0, 0] += 1.0                      # not at a kink
    moved = (got - want).abs() > lim
    out, n = measure.kink_exempt(bi, got, want, 1e-4)
    assert n == 1
    assert float(out[b0, c0, o0]) == float(want[b0, c0, o0])
    assert int(((out - want).abs() > lim).sum()) == int(moved.sum()) - 1


def test_f64_witness_sums_the_plain_backwards_terms():
    """measure.classic_bwd_f64: the plain backward's weight grads with the
    sums over slots in f64 (equal to its f32 sums within their rounding),
    and each sum's magnitudes at least the sum's magnitude. Measured over
    those magnitudes, as chip_smoke.py holds row 5 at the CLI's shapes
    (SUM_TOL 1e-3 on the max, SUM_TOL_MEAN 1e-5 on the mean), the plain
    version's f32 sums stay under 1e-6 and 1e-7, and a backward that loses
    0.1% of the valid slots goes past 1e-4 and 2e-4."""
    a = measure.bwd_inputs(measure.classic_kernel_inputs(
        torch.device("cpu"), torch.float32, b=2048, widths=(32, 96, 32),
        o=32, dh=32))
    plain = tpa.fused_pe_link_attention_bwd_plain(**a)[2:7]
    wit = measure.classic_bwd_f64(**a)
    drop = a["valid"] & (torch.rand(
        a["valid"].shape, generator=torch.Generator().manual_seed(3)) < 1e-3)
    lossy = tpa.fused_pe_link_attention_bwd_plain(
        **dict(a, valid=a["valid"] & ~drop))[2:7]
    assert int(drop.sum()) > 0
    for want, got, mag, bad in zip(plain, wit[:5], wit[5:], lossy):
        assert got.dtype == torch.float64 and got.shape == want.shape
        np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-6 * float(
                                       want.abs().max()))
        assert bool((mag >= got.abs() * (1 - 1e-12)).all())
        assert float(mag.max()) > 0
        mag = mag.clamp_min(1e-300)     # a dead hidden unit sums nothing
        err, bad_err = (want.double() - got).abs(), (bad.double() - got).abs()
        assert float((err / mag).max()) < 1e-6
        assert float(err.mean() / mag.mean()) < 1e-7
        assert float((bad_err / mag).max()) > 1e-4
        assert float(bad_err.mean() / mag.mean()) > 2e-4
