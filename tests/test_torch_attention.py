"""The port's per-link attention (``ops/attention.py:fused_link_attention``,
GATv2 without PE) against the JAX package's Pallas op
(``lpformer_tpu.ops.pallas.attention.fused_link_attention`` in interpret
mode on the CPU): the output, and every gradient through ``jax.grad`` and
torch autograd.

On CPU tensors the port's op runs its plain forward and plain backward
(``fused_link_attention_bwd_plain``), so these tests hold the plain
versions to the TPU kernels; the CUDA kernels are held to the plain
versions on the card (the ``cuda``-marked test here, and chip_smoke.py at
the bench's A/B shape).

Inputs: random validity with one link of no valid slot and one full link,
C = 20 (one TPU tile) and C = 150 (not a multiple of 128: the JAX entry
pads it to two tiles), Dk and O of no power of two included.

Tolerances. float32: the two sides differ only in summation order: rtol
1e-4 / atol 1e-5. bf16 keys (W_r rounded to bf16 on both sides): both
round the key cotangent to bf16 before the dkeys and dW products, but a
last-bit difference in its f32 value flips a rounding (2^-8 relative):
rtol 2e-2 / atol 2e-3 on every gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pe_attention_mixed_bwd import assert_close_card

from lpformer_tpu.ops.pallas import attention as jatt
from lpformer_tpu_torch.ops import attention as tatt

DIFF = ("keys", "q", "w_r", "r_bias", "att", "bias")
# (C, Dk, O): one tile; C not a multiple of 128; widths of no power of two
SHAPES = [(20, 24, 16), (150, 24, 16), (37, 20, 12)]
B = 6
# the card's further shapes: the A/B's widths; several chunks of 64 valid
# slots a link; the dim-256 widths, where W_r does not fit in shared
# memory beside a block's chunk in f32; key rows of 40 bytes in bf16 (not
# 16-byte aligned)
CARD_SHAPES = [(128, 256, 128), (300, 256, 128), (128, 512, 256),
               (128, 20, 12)]
TOL = {False: dict(rtol=1e-4, atol=1e-5), True: dict(rtol=2e-2, atol=2e-3)}


def _inputs(c, dk, o, seed):
    rng = np.random.default_rng(seed)
    valid = rng.random((B, c)) < 0.6
    valid[1] = False
    valid[3] = True
    return dict(
        keys=rng.standard_normal((B, c, dk)).astype(np.float32),
        q=rng.standard_normal((B, o)).astype(np.float32),
        valid=valid,
        w_r=(rng.standard_normal((dk, o)) / dk ** 0.5).astype(np.float32),
        r_bias=(0.1 * rng.standard_normal(o)).astype(np.float32),
        att=(0.3 * rng.standard_normal((1, o))).astype(np.float32),
        bias=(0.1 * rng.standard_normal(o)).astype(np.float32),
    )


def _cot(a, seed):
    return np.random.default_rng(100 + seed).standard_normal(
        a["q"].shape).astype(np.float32)


def _jax(a, g_out, bf16):
    """out and every grad of sum(out * g_out) through the Pallas op."""
    kdt = jnp.bfloat16 if bf16 else jnp.float32
    valid = jnp.asarray(a["valid"])

    def f(keys, q, w_r, r_bias, att, bias):
        out = jatt.fused_link_attention(keys, q, valid, w_r, r_bias, att,
                                        bias, heads=1, interpret=True)
        return jnp.sum(out * jnp.asarray(g_out)), out

    prim = [jnp.asarray(a[n], kdt if n == "keys" else jnp.float32)
            for n in DIFF]
    grads, out = jax.grad(f, argnums=tuple(range(len(DIFF))),
                          has_aux=True)(*prim)
    return np.asarray(out), {n: np.asarray(g.astype(jnp.float32))
                             for n, g in zip(DIFF, grads)}


def _torch(a, g_out, bf16):
    t = {n: torch.as_tensor(v) for n, v in a.items()}
    if bf16:
        t["keys"] = t["keys"].to(torch.bfloat16)
    for n in DIFF:
        t[n].requires_grad_(True)
    out = tatt.fused_link_attention(t["keys"], t["q"], t["valid"], t["w_r"],
                                    t["r_bias"], t["att"], t["bias"])
    (out * torch.as_tensor(g_out)).sum().backward()
    return out.detach().numpy(), {n: t[n].grad.float().numpy() for n in DIFF}


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("c,dk,o", SHAPES)
def test_forward_and_grads_match_pallas(c, dk, o, bf16):
    a = _inputs(c, dk, o, seed=c + dk)
    g_out = _cot(a, c)
    jo, jg = _jax(a, g_out, bf16)
    to, tg = _torch(a, g_out, bf16)
    np.testing.assert_allclose(to, jo, **TOL[bf16])
    # a link with no valid slot gets the bias alone
    np.testing.assert_allclose(to[1], a["bias"], rtol=0, atol=0)
    for n in DIFF:
        np.testing.assert_allclose(tg[n], jg[n], err_msg=n, **TOL[bf16])
    # dead slots' key cotangents are zero on both sides
    assert not tg["keys"][~a["valid"]].any()


def test_plain_bwd_matches_autograd_of_plain_forward():
    """In f32 the hand-written backward equals autograd through the plain
    forward's torch ops (the rounding point is the identity in f32)."""
    a = _inputs(37, 20, 12, seed=3)
    g_out = torch.as_tensor(_cot(a, 3))
    t = {n: torch.as_tensor(v) for n, v in a.items()}
    for n in DIFF:
        t[n].requires_grad_(True)
    out, m, l = tatt.fused_link_attention_plain(
        t["keys"], t["q"], t["valid"], t["w_r"], t["r_bias"], t["att"],
        t["bias"])
    (out * g_out).sum().backward()
    delta = (g_out * (out.detach() - t["bias"].detach())).sum(-1)
    dkeys, dq, dw, drb, datt = tatt.fused_link_attention_bwd_plain(
        *(t[n].detach() for n in ("keys", "q", "valid", "w_r", "r_bias",
                                  "att")), m, l, g_out, delta)
    for n, got in zip(("keys", "q", "w_r", "r_bias", "att"),
                      (dkeys, dq, dw, drb, datt)):
        torch.testing.assert_close(got, t[n].grad, rtol=1e-5, atol=1e-6,
                                   msg=n)


def test_wrapper_runs_plain_on_cpu_tensors():
    """No build and no launch for CPU tensors: the result is the plain
    version's, and the module imports and runs without nvcc."""
    a = {n: torch.as_tensor(v) for n, v in _inputs(20, 24, 16, 0).items()}
    before = (tatt.fused_link_attention.launches,
              tatt.fused_link_attention_bwd.launches)
    got = tatt.fused_link_attention(*a.values())
    want, _, _ = tatt.fused_link_attention_plain(*a.values())
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (tatt.fused_link_attention.launches,
            tatt.fused_link_attention_bwd.launches) == before
    assert tatt._LIB is None and tatt._LIB_BWD is None


def test_more_heads_raise():
    a = {n: torch.as_tensor(v) for n, v in _inputs(20, 24, 16, 0).items()}
    with pytest.raises(NotImplementedError):
        tatt.fused_link_attention(*a.values(), heads=2)


@pytest.mark.parametrize("name,bad,err", [
    ("w", lambda t: t.to(torch.bfloat16), TypeError),    # keys are f32
    ("valid", lambda t: t.int(), TypeError),
    ("q", lambda t: t[:, :-1], ValueError),
    ("keys", lambda t: t.transpose(0, 1).contiguous().transpose(0, 1),
     ValueError),
    ("att", lambda t: t[0], ValueError),
])
def test_kernel_input_checks(name, bad, err):
    """What the CUDA wrappers refuse before a launch (the checks do not
    depend on the device, so CPU tensors exercise them)."""
    a = {n: torch.as_tensor(v) for n, v in _inputs(20, 24, 16, 0).items()}
    args = dict(zip(("keys", "q", "valid", "w", "r_bias", "att", "bias"),
                    a.values()))
    tatt._check(**args)
    args[name] = bad(args[name])
    with pytest.raises(err):
        tatt._check(**args)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("c,dk,o", SHAPES + CARD_SHAPES)
def test_kernels_match_plain_on_card(c, dk, o, bf16):
    """Forward and backward kernels against their plain versions on the
    card (``assert_close_card``: max |err| within rtol of each output's
    largest magnitude, mean within a tenth of it; dW sums every valid slot
    of the batch in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = _inputs(c, dk, o, seed=7)
    t = {n: torch.as_tensor(v).cuda() for n, v in a.items()}
    kdt = torch.bfloat16 if bf16 else torch.float32
    args = (t["keys"].to(kdt), t["q"], t["valid"], t["w_r"].to(kdt),
            t["r_bias"], t["att"], t["bias"])
    before = (tatt.fused_link_attention.launches,
              tatt.fused_link_attention_bwd.launches)
    got = tatt._fwd(*args)
    want = tatt.fused_link_attention_plain(*args)
    g_out = torch.as_tensor(_cot(a, 7)).cuda()
    delta = (g_out * (want[0] - t["bias"])).sum(-1)
    bargs = args[:6] + (want[1], want[2], g_out, delta)
    got_b = tatt.fused_link_attention_bwd(*bargs)
    torch.cuda.synchronize()
    assert (tatt.fused_link_attention.launches,
            tatt.fused_link_attention_bwd.launches) == (before[0] + 1,
                                                        before[1] + 1)
    want_b = tatt.fused_link_attention_bwd_plain(*bargs)
    for x, y in zip(got + got_b, want + want_b):
        assert x.dtype == y.dtype
        assert_close_card(x, y, TOL[bf16]["rtol"])


def _card_args(c, dk, o, bf16, seed=7):
    a = _inputs(c, dk, o, seed=seed)
    t = {n: torch.as_tensor(v).cuda() for n, v in a.items()}
    kdt = torch.bfloat16 if bf16 else torch.float32
    return a, (t["keys"].to(kdt), t["q"], t["valid"], t["w_r"].to(kdt),
               t["r_bias"], t["att"], t["bias"])


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_dead_slots_dkeys_are_zero_on_card(bf16):
    """The backward kernel writes every dead slot's dkeys row itself, as
    exact zeros, into an output it never clears (torch.empty): fill the
    caching allocator's blocks with NaN first, so a row left unwritten
    shows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a, args = _card_args(300, 256, 128, bf16)
    torch.full((8 << 20,), float("nan"), device="cuda")   # freed: dirty
    out, m, l = tatt.fused_link_attention_plain(*args)
    g_out = torch.as_tensor(_cot(a, 7)).cuda()
    delta = (g_out * (out - args[6])).sum(-1)
    dkeys = tatt.fused_link_attention_bwd(*args[:6], m, l, g_out, delta)[0]
    torch.cuda.synchronize()
    dead = ~args[2]
    assert dead.any()
    assert torch.equal(dkeys[dead], torch.zeros_like(dkeys[dead]))
    assert bool(torch.isfinite(dkeys[~dead].float()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_forward_is_deterministic_on_card(bf16):
    """A block takes whole links and writes out, m and l once with no
    atomics: two calls give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, args = _card_args(300, 256, 128, bf16)
    first = tatt._fwd(*args)
    second = tatt._fwd(*args)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)
