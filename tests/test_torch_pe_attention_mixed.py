"""The port's fused PE + attention op against the JAX package's Pallas
kernel (run in interpret mode on the CPU).

On CPU tensors the port's wrapper runs its plain torch version, so these
tests hold that version to the TPU kernel; the CUDA kernel is held to the
plain version on the card (``test_kernel_matches_plain_on_card`` here,
and chip_smoke.py at the main-path shape).

Tolerances: float32 end to end, the two differ only in summation order:
rtol 1e-4 / atol 1e-5. With bf16 keys and W2f both round the hidden
activation to bf16 before the W2f product, but a last-bit difference in
the f32 activation can flip one bf16 rounding: rtol 2e-3 / atol 2e-3."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpformer_tpu.ops.pallas import pe_attention_mixed as jpam
from lpformer_tpu_torch.ops import pe_attention_mixed as tpam

B, C, O, DH, CT = 6, 16, 16, 16, 8
# (O, dh) beyond the main path's 128: a dim-256 layer; the first layer of
# trans_layers=2 at dim 128; widths of no power of two, the last with a
# ragged 4-column group (O % 4 != 0)
WIDTHS = [(256, 256), (256, 128), (72, 40), (70, 36)]


def _inputs(K, seed, mode, dtype=np.float32, o=O, dh=DH):
    """Front-compacted validity with an empty row and a full row; classes
    mixed per slot ("mixed") or one class per row ("single"); O = o
    output columns, dh = dh hidden units."""
    rng = np.random.default_rng(seed)
    counts = np.array([0, 1, 3, C, 5, 2])
    valid = np.arange(C)[None, :] < counts[:, None]
    if mode == "mixed":
        ecls = rng.integers(0, K, (B, C))
    else:
        ecls = np.repeat(rng.integers(0, K, (B, 1)), C, axis=1)
    ecls = np.where(valid, ecls, 0).astype(np.int32)
    a = dict(
        keys=rng.standard_normal((B, C, o)).astype(np.float32) * 0.5,
        ps=(rng.random((B, C)) * 0.1).astype(np.float32) * valid,
        pt=(rng.random((B, C)) * 0.1).astype(np.float32) * valid,
        valid=valid, ecls=ecls,
        q=rng.standard_normal((B, o)).astype(np.float32),
        w1=rng.standard_normal((K, 2, dh)).astype(np.float32),
        b1=rng.standard_normal((K, dh)).astype(np.float32) * 0.1,
        g=(1 + 0.1 * rng.standard_normal((K, dh))).astype(np.float32),
        b=(0.1 * rng.standard_normal((K, dh))).astype(np.float32),
        w2f=(rng.standard_normal((K, dh, o)) / dh ** 0.5).astype(np.float32),
        cbias=(0.1 * rng.standard_normal((K, o))).astype(np.float32),
        att=rng.standard_normal((1, o)).astype(np.float32) * 0.3,
        bias=(0.1 * rng.standard_normal(o)).astype(np.float32),
    )
    if dtype != np.float32:  # round once, so both sides see the same values
        for k in ("keys", "w2f"):
            a[k] = np.array(jnp.asarray(a[k], jnp.bfloat16).astype(jnp.float32))
    return a


def _torch_args(a, bf16=False):
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    if bf16:
        t["keys"] = t["keys"].to(torch.bfloat16)
        t["w2f"] = t["w2f"].to(torch.bfloat16)
    return t


def _jax(a, bf16=False):
    """JAX out, m and l: the public entry's argument preparation, then the
    forward pallas_call (the public entry returns out only)."""
    kdt = jnp.bfloat16 if bf16 else jnp.float32
    tile = lambda x: jnp.asarray(x, jnp.float32).reshape(  # noqa: E731
        B, C // CT, CT).swapaxes(0, 1)
    w1cat = jnp.concatenate([a["w1"][:, 0], a["w1"][:, 1], a["b1"]], axis=0)
    out, m, l = jpam._fwd_call(
        jnp.asarray(a["keys"], kdt), tile(a["ps"]), tile(a["pt"]),
        tile(a["valid"]), tile(a["ecls"]), jnp.asarray(a["q"]), w1cat,
        jnp.asarray(a["g"]), jnp.asarray(a["b"]), jnp.asarray(a["w2f"], kdt),
        jnp.asarray(a["cbias"]), jnp.asarray(a["att"]), jnp.asarray(a["bias"]),
        B, CT, True)
    public = jpam.fused_pe_link_attention_mixed(
        jnp.asarray(a["keys"], kdt), *(jnp.asarray(a[k]) for k in (
            "ps", "pt", "valid", "ecls", "q", "w1", "b1", "g", "b")),
        jnp.asarray(a["w2f"], kdt), *(jnp.asarray(a[k]) for k in (
            "cbias", "att", "bias")), c_tile=CT, interpret=True)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(public))
    return np.asarray(out), np.asarray(m)[:, 0], np.asarray(l)[:, 0]


@pytest.mark.parametrize("mode", ["mixed", "single"])
@pytest.mark.parametrize("K", [1, 2, 3])
def test_plain_matches_pallas_f32(K, mode):
    a = _inputs(K, seed=K, mode=mode)
    jo, jm, jl = _jax(a)
    to, tm, tl = tpam.fused_pe_link_attention_mixed_plain(**_torch_args(a))
    np.testing.assert_allclose(to.numpy(), jo, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tm.numpy(), jm, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-4, atol=1e-5)
    # the empty row gets exactly the bias and the initial statistics
    np.testing.assert_array_equal(to[0].numpy(), a["bias"])
    assert tm[0] == -5e29 and tl[0] == 0


def test_plain_matches_pallas_bf16():
    a = _inputs(3, seed=7, mode="mixed", dtype=jnp.bfloat16)
    jo, jm, jl = _jax(a, bf16=True)
    to, tm, tl = tpam.fused_pe_link_attention_mixed_plain(
        **_torch_args(a, bf16=True))
    np.testing.assert_allclose(to.numpy(), jo, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tm.numpy(), jm, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("o,dh", WIDTHS)
def test_plain_matches_pallas_at_widths(o, dh):
    """Any O and dh, at the f32 tolerance."""
    a = _inputs(3, seed=o + dh, mode="mixed", o=o, dh=dh)
    jo, jm, jl = _jax(a)
    to, tm, tl = tpam.fused_pe_link_attention_mixed_plain(**_torch_args(a))
    np.testing.assert_allclose(to.numpy(), jo, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tm.numpy(), jm, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-4, atol=1e-5)


def test_wrapper_runs_plain_on_cpu_tensors():
    """No build and no launch for CPU tensors: the result is the plain
    version's, and the module imports and runs without nvcc."""
    a = _torch_args(_inputs(2, seed=0, mode="mixed"))
    before = tpam.fused_pe_link_attention_mixed.launches
    got = tpam.fused_pe_link_attention_mixed(**a)
    want = tpam.fused_pe_link_attention_mixed_plain(**a)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert tpam.fused_pe_link_attention_mixed.launches == before
    assert tpam._LIB is None


@pytest.mark.parametrize("name,bad,err", [
    ("ecls", lambda t: t.long(), TypeError),
    ("w2f", lambda t: t.to(torch.bfloat16), TypeError),  # keys are f32
    ("q", lambda t: t[:, :-1], ValueError),
    ("keys", lambda t: t.transpose(0, 1).contiguous().transpose(0, 1),
     ValueError),
    ("att", lambda t: t[0], ValueError),
])
def test_kernel_input_checks(name, bad, err):
    """What the CUDA wrapper refuses before a launch (the checks do not
    depend on the device, so CPU tensors exercise them)."""
    a = _torch_args(_inputs(2, seed=0, mode="mixed"))
    tpam._check(*a.values())
    a[name] = bad(a[name])
    with pytest.raises(err):
        tpam._check(*a.values())


def _card_inputs(case, seed, o=O, dh=DH):
    """Inputs of the card tests: "mixed", ``_inputs``' layout (an empty
    link, a full one); "class TS+1", every slot valid and class 0 holding
    one slot more than a kernel tile, the first in (link, column) order;
    "all dead", no valid slot."""
    a = _inputs(3, seed=seed, mode="mixed", o=o, dh=dh)
    if case == "mixed":
        return a
    rng = np.random.default_rng(seed + 1)
    valid = np.full((B, C), case == "class TS+1")
    first = np.arange(B * C).reshape(B, C) <= tpam.tile_slots(o, dh)
    ecls = np.where(first, 0, rng.integers(1, 3, (B, C)))
    a.update(valid=valid, ecls=(ecls * valid).astype(np.int32))
    for n in ("ps", "pt"):
        a[n] = (rng.random((B, C)) * 0.1).astype(np.float32) * valid
    return a


def _card_run(a, bf16):
    """The wrapper on the card under ``set_sync_debug_mode("error")`` (a
    host synchronisation fails it), one launch counted; then the plain
    version on the same tensors."""
    a = {k: v.cuda() for k, v in _torch_args(a, bf16=bf16).items()}
    tpam._load()         # the build synchronises; the wrapper must not
    before = tpam.fused_pe_link_attention_mixed.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tpam.fused_pe_link_attention_mixed(**a)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert tpam.fused_pe_link_attention_mixed.launches == before + 1
    return got, tpam.fused_pe_link_attention_mixed_plain(**a)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mixed", "class TS+1", "all dead"])
@pytest.mark.parametrize("bf16", [False, True])
def test_kernel_matches_plain_on_card(bf16, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got, want = _card_run(_card_inputs(case, seed=5), bf16)
    tol = 2e-3 if bf16 else 1e-4
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=tol, atol=tol)
    if case == "all dead":
        assert bool((got[0] == want[0]).all())   # the bias, exactly


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mixed", "class TS+1", "all dead"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("o,dh", WIDTHS)
def test_kernel_matches_plain_on_card_at_widths(o, dh, bf16, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got, want = _card_run(_card_inputs(case, seed=o + dh, o=o, dh=dh), bf16)
    tol = 2e-3 if bf16 else 1e-4
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=tol, atol=tol)
