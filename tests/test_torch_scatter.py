"""The port's scatter-add and the gathers' backward against the JAX
package: ``scatter_rows_add`` (its Pallas kernel in interpret mode) and
``gather_rows`` / ``gather_rows_valid`` under ``jax.vjp``.

On CPU tensors the port's wrapper runs its plain version (an f32
``index_add_`` of the live rows), so these tests hold that version to the
TPU kernel; the CUDA kernel is held to the plain version on the card
(``test_kernel_matches_plain_on_card`` here, and chip_smoke.py at the
main-path shape).

Tolerances: both sides sum in float32, in different orders: rtol 1e-5 /
atol 1e-5 for sums of a few standard-normal terms (a 64-term hub row is
exact to ~1e-5 absolute); the gathers' grads are the same sums.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpformer_tpu.ops import gather as jgather
from lpformer_tpu.ops.pallas.scatter import scatter_rows_add as jscatter
from lpformer_tpu_torch.ops import gather as tgather
from lpformer_tpu_torch.ops import scatter as tscatter

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(kind, seed=0):
    rng = np.random.default_rng(seed)
    n = 300
    if kind == "2d":
        ids = rng.integers(0, n, (24, 40))
    elif kind == "skewed":          # a hub row, empty tiles, the last row
        ids = rng.integers(0, n, 900)
        ids[::14] = 7
        ids[-60:] = n - 1
    else:
        ids = rng.integers(0, n, 1100)
    ct = rng.standard_normal(ids.shape + (128,)).astype(np.float32)
    live = rng.random(ids.shape) < 0.3 if kind == "live" else None
    return ids.astype(np.int32), ct, n, live


@pytest.mark.parametrize("kind", ["1d", "2d", "skewed", "live"])
@pytest.mark.parametrize("bf16", [False, True])
def test_plain_matches_pallas(kind, bf16):
    ids, ct, n, live = _case(kind)
    jct = jnp.asarray(ct, jnp.bfloat16 if bf16 else jnp.float32)
    want = jscatter(jnp.asarray(ids), jct, n, tile=256, chunk=256,
                    interpret=True,
                    live=None if live is None else jnp.asarray(live))
    tct = torch.as_tensor(ct)
    if bf16:
        tct = tct.to(torch.bfloat16)
    got = tscatter.scatter_rows_add_plain(
        torch.as_tensor(ids), tct, n,
        None if live is None else torch.as_tensor(live))
    assert got.dtype == torch.float32 and got.shape == (n, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrapper_runs_plain_on_cpu_tensors():
    """No build and no launch for CPU tensors, and the same result."""
    ids, ct, n, live = _case("live", seed=1)
    t = torch.as_tensor(ids), torch.as_tensor(ct), n, torch.as_tensor(live)
    before = tscatter.scatter_rows_add.launches
    torch.testing.assert_close(tscatter.scatter_rows_add(*t),
                               tscatter.scatter_rows_add_plain(*t),
                               rtol=0, atol=0)
    assert tscatter.scatter_rows_add.launches == before
    assert tscatter._LIB is None


@pytest.mark.parametrize("name,bad,err", [
    ("ids", lambda t: t.long(), TypeError),
    ("ct", lambda t: t.half(), TypeError),
    ("ct", lambda t: t[:, :-1], ValueError),
    ("ct", lambda t: t.transpose(0, 1).contiguous().transpose(0, 1),
     ValueError),
    ("live", lambda t: t.int(), ValueError),
])
def test_kernel_input_checks(name, bad, err):
    """What the CUDA wrapper refuses before a launch (the checks do not
    depend on the device, so CPU tensors exercise them)."""
    ids, ct, n, live = _case("2d")
    a = {"ids": torch.as_tensor(ids), "ct": torch.as_tensor(ct),
         "live": torch.as_tensor(live if live is not None
                                 else np.ones(ids.shape, bool))}
    tscatter._check(a["ids"], a["ct"], n, a["live"])
    a[name] = bad(a[name])
    with pytest.raises(err):
        tscatter._check(a["ids"], a["ct"], n, a["live"])


# both sides of the JAX package's 65,536-row threshold: 12 x 40 rows go
# through index_add_, 1,700 x 40 = 68,000 through ops/scatter.py
@pytest.mark.parametrize("rows", [12, 1700])
@pytest.mark.parametrize("with_valid", [False, True])
def test_gather_backward_matches_jax_vjp(rows, with_valid, monkeypatch):
    rng = np.random.default_rng(rows)
    n, d, c = 500, 8, 40
    table = rng.standard_normal((n + 1, d)).astype(np.float32)
    ids = rng.integers(0, n, (rows, c)).astype(np.int32)
    valid = rng.random((rows, c)) < 0.4
    if with_valid:
        ids = np.where(valid, ids, n)     # dead slots on the pad row n
    cot = rng.standard_normal((rows, c, d)).astype(np.float32)
    if with_valid:
        cot = cot * valid[..., None]      # dead cotangents are zero

    if with_valid:
        f = lambda t: jgather.gather_rows_valid(  # noqa: E731
            t, jnp.asarray(ids), jnp.asarray(valid))
    else:
        f = lambda t: jgather.gather_rows(t, jnp.asarray(ids))  # noqa: E731
    jout, vjp = jax.vjp(f, jnp.asarray(table))
    (jgrad,) = vjp(jnp.asarray(cot))

    calls = []
    real = tscatter.scatter_rows_add

    def counting(*a, **k):
        calls.append(a[0].numel())
        return real(*a, **k)

    monkeypatch.setattr(tscatter, "scatter_rows_add", counting)
    tt = torch.as_tensor(table).requires_grad_(True)
    if with_valid:
        out = tgather.gather_rows_valid(tt, torch.as_tensor(ids),
                                        torch.as_tensor(valid))
    else:
        out = tgather.gather_rows(tt, torch.as_tensor(ids))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    out.backward(torch.as_tensor(cot))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jgrad), **TOL)
    assert calls == ([rows * c] if rows * c >= 65536 else [])


def test_gather_backward_casts_to_table_dtype():
    """A bf16 table's grad is bf16: f32 sums, cast once (as the JAX
    package's ``dtable.astype(dtype)``)."""
    rng = np.random.default_rng(3)
    table = torch.as_tensor(rng.standard_normal((30, 8)).astype(np.float32))
    tb = table.to(torch.bfloat16).requires_grad_(True)
    ids = torch.as_tensor(rng.integers(0, 30, (5, 7)).astype(np.int32))
    cot = torch.as_tensor(rng.standard_normal((5, 7, 8)).astype(np.float32))
    tgather.gather_rows(tb, ids).backward(cot.to(torch.bfloat16))
    want = torch.zeros(30, 8).index_add_(
        0, ids.reshape(-1).long(),
        cot.to(torch.bfloat16).float().reshape(-1, 8)).to(torch.bfloat16)
    assert tb.grad.dtype == torch.bfloat16
    torch.testing.assert_close(tb.grad, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_kernel_matches_plain_on_card(bf16):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for kind in ("2d", "skewed", "live"):
        ids, ct, n, live = _case(kind, seed=4)
        tct = torch.as_tensor(ct).cuda()
        if bf16:
            tct = tct.to(torch.bfloat16)
        a = (torch.as_tensor(ids).cuda(), tct, n,
             None if live is None else torch.as_tensor(live).cuda())
        before = tscatter.scatter_rows_add.launches
        got = tscatter.scatter_rows_add(*a)
        torch.cuda.synchronize()
        assert tscatter.scatter_rows_add.launches == before + 1
        torch.testing.assert_close(got, tscatter.scatter_rows_add_plain(*a),
                                   rtol=1e-5, atol=1e-5)
