"""The port's fused PE + attention backward against the JAX package's
Pallas backward (``jax.vjp`` of ``fused_pe_link_attention_mixed`` in
interpret mode on the CPU).

On CPU tensors the port's op runs its plain forward and plain backward
(``fused_pe_link_attention_mixed_bwd_plain``), so these tests hold the
plain backward to the TPU kernel, and to autograd through the plain
forward; the CUDA kernel is held to the plain backward on the card
(``test_kernel_matches_plain_on_card`` here, and chip_smoke.py at the
main-path shape).

Tolerances. float32: the two sides differ only in summation order:
rtol 1e-4 / atol 1e-5, tighter than the JAX package's own dense-vs-Pallas
grad bound (rtol 2e-3 / atol 2e-4, tests/test_combined_context.py). bf16
keys and W2f: both sides round the hidden activation and the key
cotangent to bf16 at the same points, but a last-bit difference in an f32
value just before a rounding flips it (2^-8 relative), and a flipped dxjc
enters dw2 and the LayerNorm grads: rtol 2e-2 / atol 2e-3 on every grad.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pe_attention_mixed import CT, WIDTHS, _inputs, _torch_args

from lpformer_tpu.ops.pallas import pe_attention_mixed as jpam
from lpformer_tpu_torch.ops import pe_attention_mixed as tpam

DIFF = ("keys", "q", "w1", "b1", "g", "b", "w2f", "cbias", "att", "bias")
ORDER = ("keys", "ps", "pt", "valid", "ecls", "q", "w1", "b1", "g", "b",
         "w2f", "cbias", "att", "bias")


def _cot(a, seed):
    rng = np.random.default_rng(100 + seed)
    return rng.standard_normal(a["q"].shape).astype(np.float32)


def _jax_grads(a, g_out, bf16=False):
    kdt = jnp.bfloat16 if bf16 else jnp.float32
    fixed = {k: jnp.asarray(a[k]) for k in ("ps", "pt", "valid", "ecls")}

    def f(*diff):
        kw = dict(zip(DIFF, diff), **fixed)
        return jpam.fused_pe_link_attention_mixed(
            *(kw[k] for k in ORDER), c_tile=CT, interpret=True)

    prim = [jnp.asarray(a[k], kdt if k in ("keys", "w2f") else jnp.float32)
            for k in DIFF]
    out, vjp = jax.vjp(f, *prim)
    grads = vjp(jnp.asarray(g_out))
    return np.asarray(out), {k: np.asarray(v.astype(jnp.float32))
                             for k, v in zip(DIFF, grads)}


def _torch_grads(a, g_out, bf16=False):
    t = _torch_args(a, bf16=bf16)
    for k in DIFF:
        t[k].requires_grad_(True)
    out, _, _ = tpam.fused_pe_link_attention_mixed(*(t[k] for k in ORDER))
    out.backward(torch.as_tensor(g_out))
    return out.detach().numpy(), {k: t[k].grad for k in DIFF}


@pytest.mark.parametrize("mode", ["mixed", "single"])
@pytest.mark.parametrize("K", [1, 2, 3])
def test_grads_match_pallas_vjp_f32(K, mode):
    a = _inputs(K, seed=K, mode=mode)
    g_out = _cot(a, K)
    jo, jg = _jax_grads(a, g_out)
    to, tg = _torch_grads(a, g_out)
    np.testing.assert_allclose(to, jo, rtol=1e-4, atol=1e-5)
    for k in DIFF:
        assert tg[k].dtype == torch.float32
        np.testing.assert_allclose(tg[k].numpy(), jg[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("mode", ["mixed", "single"])
def test_grads_match_pallas_vjp_bf16(mode):
    a = _inputs(3, seed=11, mode=mode, dtype=jnp.bfloat16)
    g_out = _cot(a, 11)
    _, jg = _jax_grads(a, g_out, bf16=True)
    _, tg = _torch_grads(a, g_out, bf16=True)
    for k in DIFF:
        # the grads of bf16 inputs are bf16, as dw2.astype(w2.dtype)
        want_dtype = torch.bfloat16 if k in ("keys", "w2f") else torch.float32
        assert tg[k].dtype == want_dtype, k
        np.testing.assert_allclose(tg[k].float().numpy(), jg[k], rtol=2e-2,
                                   atol=2e-3, err_msg=k)


def assert_close_scaled(got, want, rtol, atol, msg=""):
    """rtol, and atol times the largest |want| (at least 1): at O, dh = 256
    a grad element sums hundreds of f32 terms of up to ~100 (the b1 grad
    reaches 140), so an element that cancels to near zero keeps the f32
    rounding of its largest terms, ~1e-6 of the tensor's scale (measured)."""
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol * max(1.0, float(np.abs(want).max())),
        err_msg=msg)


def assert_close_card(got, want, tol, msg=""):
    """A kernel against its plain version on the card past the main path's
    widths: max |err| within ``tol`` of the output's largest magnitude and
    mean |err| within ``tol / 10`` of its mean magnitude. At O, dh = 256 an
    element sums hundreds of terms in another order (f32), and in bf16 a
    flipped rounding of h upstream can move single elements by much more
    than their own rounding (the leaky-ReLU slope flips), which the mean
    bound keeps from hiding a systematic error."""
    d = (got.float() - want.float()).abs()
    w = want.float().abs()
    assert d.max() <= tol * w.max().clamp_min(1e-30), (msg, float(d.max()))
    assert d.mean() <= tol / 10 * w.mean().clamp_min(1e-30), (
        msg, float(d.mean()))


@pytest.mark.parametrize("o,dh", WIDTHS)
def test_grads_match_pallas_vjp_at_widths(o, dh):
    """Any O and dh, f32: rtol 1e-4 / atol 1e-5 of each grad's scale."""
    a = _inputs(3, seed=o + dh, mode="mixed", o=o, dh=dh)
    g_out = _cot(a, o)
    jo, jg = _jax_grads(a, g_out)
    to, tg = _torch_grads(a, g_out)
    assert_close_scaled(to, jo, 1e-4, 1e-5)
    for k in DIFF:
        assert_close_scaled(tg[k].numpy(), jg[k], 1e-4, 1e-5, k)


def test_plain_bwd_matches_autograd_of_plain_forward():
    """In f32 the hand-written backward equals autograd through the plain
    forward's torch ops (rounding points are identities in f32)."""
    a = _inputs(3, seed=4, mode="mixed")
    g_out = torch.as_tensor(_cot(a, 4))
    t = _torch_args(a)
    for k in DIFF:
        t[k].requires_grad_(True)
    out, _, _ = tpam.fused_pe_link_attention_mixed_plain(
        *(t[k] for k in ORDER))
    out.backward(g_out)
    auto = {k: t[k].grad for k in DIFF}
    _, ours = _torch_grads(a, g_out.numpy())
    for k in DIFF:
        torch.testing.assert_close(ours[k], auto[k], rtol=1e-4, atol=1e-5,
                                   msg=k)


def test_dead_slots_and_empty_links_get_zero_grads():
    """Dead slots' dkeys are exactly zero; the empty link (row 0) gets
    dq = 0; ps and pt carry no gradient."""
    a = _inputs(2, seed=5, mode="mixed")
    t = _torch_args(a)
    t["keys"].requires_grad_(True)
    t["q"].requires_grad_(True)
    t["ps"].requires_grad_(True)
    out, _, _ = tpam.fused_pe_link_attention_mixed(*(t[k] for k in ORDER))
    out.backward(torch.as_tensor(_cot(a, 5)))
    dead = ~torch.as_tensor(a["valid"])
    assert bool((t["keys"].grad[dead] == 0).all())
    assert bool((t["q"].grad[0] == 0).all())
    assert t["ps"].grad is None


def test_bwd_wrapper_runs_plain_on_cpu_tensors():
    """No build and no launch for CPU tensors: the backward's result is
    the plain version's."""
    a = _torch_args(_inputs(2, seed=0, mode="mixed"))
    out, m, l = tpam.fused_pe_link_attention_mixed_plain(**a)
    g_out = torch.as_tensor(_cot(a, 0))
    delta = (g_out * (out - a["bias"])).sum(-1)
    args = [a[k] for k in ORDER[:-1]] + [m, l, g_out, delta]
    before = tpam.fused_pe_link_attention_mixed_bwd.launches
    got = tpam.fused_pe_link_attention_mixed_bwd(*args)
    want = tpam.fused_pe_link_attention_mixed_bwd_plain(*args)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert tpam.fused_pe_link_attention_mixed_bwd.launches == before
    assert tpam._LIB_BWD is None


@pytest.mark.parametrize("name,bad,err", [
    ("g_out", lambda t: t.double(), TypeError),
    ("g_out", lambda t: t[:-1], ValueError),
    ("m", lambda t: t[:, None], ValueError),
    ("delta", lambda t: t.to(torch.bfloat16), TypeError),
])
def test_bwd_input_checks(name, bad, err):
    """What the backward's CUDA wrapper refuses before a launch."""
    a = _torch_args(_inputs(2, seed=0, mode="mixed"))
    fwd = [a[k] for k in ORDER[:-1]]
    b_ = a["q"].shape[0]
    extra = {"g_out": torch.zeros_like(a["q"]), "m": torch.zeros(b_),
             "l": torch.ones(b_), "delta": torch.zeros(b_)}
    tpam._check(*fwd, **extra)
    extra[name] = bad(extra[name])
    with pytest.raises(err):
        tpam._check(*fwd, **extra)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("o,dh", [(16, 16)] + WIDTHS)
def test_kernel_matches_plain_on_card(bf16, o, dh):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = _inputs(3, seed=6, mode="mixed",
                dtype=jnp.bfloat16 if bf16 else np.float32, o=o, dh=dh)
    t = {k: v.cuda() for k, v in _torch_args(a, bf16=bf16).items()}
    out, m, l = tpam.fused_pe_link_attention_mixed_plain(**t)
    g_out = torch.as_tensor(_cot(a, 6)).cuda()
    delta = (g_out * (out - t["bias"])).sum(-1)
    args = [t[k] for k in ORDER[:-1]] + [m, l, g_out, delta]
    before = tpam.fused_pe_link_attention_mixed_bwd.launches
    got = tpam.fused_pe_link_attention_mixed_bwd(*args)
    torch.cuda.synchronize()
    assert tpam.fused_pe_link_attention_mixed_bwd.launches == before + 1
    want = tpam.fused_pe_link_attention_mixed_bwd_plain(*args)
    tol = 2e-2 if bf16 else 1e-4
    for x, y in zip(got, want):
        assert x.dtype == y.dtype
        if (o, dh) == (16, 16):
            torch.testing.assert_close(x.float(), y.float(), rtol=tol,
                                       atol=tol / 10)
        else:
            assert_close_card(x, y, tol)
