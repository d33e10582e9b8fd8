"""The port's gather-SpMM (coala_gnn_tpu_torch/ops/gather_spmm.py) against
both Pallas kernels of the JAX package, run in interpret mode on the CPU,
and its backward against autograd and ``jax.grad``.

On the CPU the wrapper takes the plain versions, so these tests hold the
plain versions to the Pallas contract and to JAX's autodiff;
tests/test_torch_cuda.py and chip_smoke.py hold the CUDA kernels to the
plain versions on the card. Tolerance: rtol = atol = 1e-5, the Pallas
tests' own (both sides sum the same f32 products, in another association
order on the Pallas side); the int8 form compares against Pallas on JAX's
``dequantize_rows`` output, so both sides sum the same dequantised rows.
The backward sums the same products as autograd and ``jax.grad`` in
another order (a row dot, an index_add_ over repeated rows): 1e-5 too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coala_gnn_tpu.cache import feature_cache as jfc
from coala_gnn_tpu.ops.aggregate import padded_gather_sum
from coala_gnn_tpu.ops.pallas_gather import gather_sum_vmem as jax_vmem
from coala_gnn_tpu.ops.pallas_spmm import ell_spmm_pallas
from coala_gnn_tpu_torch.ops.gather_spmm import (
    LAUNCHES, gather_spmm, gather_spmm_grad_w, gather_spmm_grad_w_reference,
    gather_spmm_grad_x, gather_spmm_grad_x_reference, gather_spmm_reference,
    gather_sum_vmem)

torch.set_num_threads(1)
TOL = 1e-5


def _inputs(rng, S, N, F, D):
    x = rng.normal(size=(S, D)).astype(np.float32)
    adj = rng.integers(0, S, size=(N, F)).astype(np.int32)
    w = rng.random((N, F)).astype(np.float32)
    return x, adj, w


def _port(fn, x, adj, w, dtype=torch.float32):
    return fn(torch.from_numpy(x).to(dtype), torch.from_numpy(adj),
              torch.from_numpy(w)).numpy()


@pytest.mark.parametrize("shape", [(100, 40, 5, 128), (64, 300, 3, 256),
                                   (50, 17, 10, 128)])
def test_matches_ell_spmm_pallas(rng, shape):
    x, adj, w = _inputs(rng, *shape)
    want = np.asarray(ell_spmm_pallas(jnp.asarray(x), jnp.asarray(adj),
                                      jnp.asarray(w), interpret=True))
    for fn in (gather_spmm, gather_spmm_reference):
        np.testing.assert_allclose(_port(fn, x, adj, w), want, rtol=TOL,
                                   atol=TOL)


def test_zero_weights_mask(rng):
    """Slots with w = 0 contribute nothing, whatever row they point at."""
    S, N, F, D = 30, 10, 4, 128
    x, adj, _ = _inputs(rng, S, N, F, D)
    w = np.zeros((N, F), np.float32)
    w[:, 0] = 1.0
    want = np.asarray(ell_spmm_pallas(jnp.asarray(x), jnp.asarray(adj),
                                      jnp.asarray(w), interpret=True))
    out = _port(gather_spmm, x, adj, w)
    np.testing.assert_allclose(out, want, rtol=1e-6)
    np.testing.assert_allclose(out, x[adj[:, 0]], rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(128, 48, 5, 128), (64, 33, 3, 256)])
def test_matches_gather_sum_vmem(rng, shape, dtype):
    """Interpret mode takes the bf16 table as it is, so both sides read
    the same bf16 values and widen them exactly to f32."""
    x, adj, w = _inputs(rng, *shape)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(jax_vmem(jnp.asarray(x, jdt), jnp.asarray(adj),
                               jnp.asarray(w), interpret=True))
    out = _port(gather_sum_vmem, x, adj, w, tdt)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, want, rtol=TOL, atol=TOL)


def test_sum_form_equals_loop_form(rng):
    """The plain version equals the one-expression form the kernel's
    contract states: (x[adj].float() * w[..., None]).sum(1)."""
    x, adj, w = _inputs(rng, 40, 25, 7, 128)
    xt, at, wt = map(torch.from_numpy, (x, adj, w))
    want = (xt[at.long()].float() * wt[..., None]).sum(1)
    torch.testing.assert_close(gather_spmm_reference(xt, at, wt), want,
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bad", [
    dict(x=torch.zeros(8, 128, dtype=torch.float16)),        # table dtype
    dict(adj=torch.zeros(4, 3, dtype=torch.int64)),          # adj dtype
    dict(w=torch.zeros(4, 3, dtype=torch.float64)),          # w dtype
    dict(w=torch.zeros(4, 2)),                               # w shape
    dict(x=torch.zeros(8, 128, dtype=torch.int8)),           # int8, no scale
    dict(scale=torch.ones(8)),                               # scale, f32 table
    dict(x=torch.zeros(128, 8).T),                           # contiguity
    dict(adj=torch.zeros(4, dtype=torch.int32)),             # rank
    dict(x=torch.zeros(8, 16, dtype=torch.int8),
         scale=torch.ones(7)),                               # scale shape
    dict(x=torch.zeros(8, 16, dtype=torch.int8),
         scale=torch.ones(8, dtype=torch.float64)),          # scale dtype
])
def test_wrapper_rejects_bad_inputs(bad):
    args = dict(x=torch.zeros(8, 128), adj=torch.zeros(4, 3,
                                                      dtype=torch.int32),
                w=torch.zeros(4, 3))
    args.update(bad)
    with pytest.raises((TypeError, ValueError)):
        gather_spmm(**args)


def test_cpu_calls_do_not_count_launches(rng):
    x, adj, w = _inputs(rng, 20, 6, 3, 128)
    before = dict(LAUNCHES)
    _port(gather_spmm, x, adj, w)
    _port(gather_sum_vmem, x, adj, w, torch.bfloat16)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    gather_spmm(xt, torch.from_numpy(adj), wt).sum().backward()
    q, scale, _ = _quantized(x)
    gather_spmm(torch.from_numpy(q), torch.from_numpy(adj), wt.detach(),
                torch.from_numpy(scale))
    assert LAUNCHES == before
    assert gather_sum_vmem is gather_spmm


# ---- the int8 + scale form --------------------------------------------------

def _quantized(x):
    """JAX's int8 rows, scales and their dequantised f32 rows."""
    q, scale = jfc.quantize_rows(jnp.asarray(x))
    return (np.array(q), np.array(scale),
            np.array(jfc.dequantize_rows(q, scale)))


@pytest.mark.parametrize("shape", [(100, 40, 5, 128), (64, 300, 3, 256),
                                   (50, 17, 10, 128)])
def test_int8_matches_ell_spmm_pallas_on_dequantized_rows(rng, shape):
    x, adj, w = _inputs(rng, *shape)
    w[:, 0] = 0.0
    q, scale, deq = _quantized(x)
    want = np.asarray(ell_spmm_pallas(jnp.asarray(deq), jnp.asarray(adj),
                                      jnp.asarray(w), interpret=True))
    got = gather_spmm(torch.from_numpy(q), torch.from_numpy(adj),
                      torch.from_numpy(w), torch.from_numpy(scale)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_int8_table_has_no_backward(rng):
    x, adj, w = _inputs(rng, 20, 6, 3, 16)
    q, scale, _ = _quantized(x)
    args = (torch.from_numpy(q), torch.from_numpy(adj))
    with pytest.raises(ValueError, match="constant"):
        gather_spmm(*args, torch.from_numpy(w).requires_grad_(),
                    torch.from_numpy(scale))
    with torch.no_grad():
        gather_spmm(*args, torch.from_numpy(w).requires_grad_(),
                    torch.from_numpy(scale))


# ---- repair: any feature width --------------------------------------------

@pytest.mark.parametrize("dtype,d", [("float32", 100), ("bfloat16", 100),
                                     ("int8", 100), ("float32", 8),
                                     ("bfloat16", 8), ("int8", 8)])
def test_any_width_passes_the_checks(rng, dtype, d):
    """Widths whose rows are not 16-byte multiples (a bf16 table of width
    100, ogbn-products', and an int8 table of width 8) go through the
    wrapper's checks and match JAX's padded_gather_sum on the rows the
    table holds (widened, or dequantised)."""
    x, adj, w = _inputs(rng, 60, 20, 5, d)
    if dtype == "int8":
        q, scale, rows = _quantized(x)
        got = gather_spmm(torch.from_numpy(q), torch.from_numpy(adj),
                          torch.from_numpy(w), torch.from_numpy(scale))
    else:
        xt = torch.from_numpy(x).to(getattr(torch, dtype))
        rows = xt.float().numpy()
        got = gather_spmm(xt, torch.from_numpy(adj), torch.from_numpy(w))
    want = np.asarray(padded_gather_sum(jnp.asarray(rows), jnp.asarray(adj),
                                        jnp.asarray(w)))
    assert got.shape == (20, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


# ---- the backward -----------------------------------------------------------

def _grad_inputs(rng, S=40, N=25, F=6, D=16):
    """Inputs with w == 0 slots and repeated indices (adj drawn from a
    range smaller than N * F)."""
    x, adj, w = _inputs(rng, S, N, F, D)
    w[rng.random((N, F)) < 0.3] = 0.0
    g = rng.normal(size=(N, D)).astype(np.float32)
    assert (w == 0).any() and np.unique(adj).size < adj.size
    return x, adj, w, g


def _autograd_of_reference(x, adj, w, g):
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    gather_spmm_reference(xt, torch.from_numpy(adj), wt).backward(
        torch.from_numpy(g))
    return xt.grad, wt.grad


def test_backward_plain_versions_match_autograd(rng):
    x, adj, w, g = _grad_inputs(rng)
    gx, gw = _autograd_of_reference(x, adj, w, g)
    adj_t, g_t = torch.from_numpy(adj), torch.from_numpy(g)
    torch.testing.assert_close(
        gather_spmm_grad_x_reference(adj_t, torch.from_numpy(w), g_t,
                                     x.shape[0]), gx, rtol=TOL, atol=TOL)
    torch.testing.assert_close(
        gather_spmm_grad_w_reference(torch.from_numpy(x), adj_t, g_t), gw,
        rtol=TOL, atol=TOL)


def test_grad_w_is_computed_for_zero_weight_slots(rng):
    """d out / d w[n, k] = <g[n], x[adj[n, k]]> whatever w[n, k] is: a
    zero-weight slot contributes nothing forward but has a gradient."""
    x, adj, w, g = _grad_inputs(rng)
    wt = torch.from_numpy(w).requires_grad_()
    gather_spmm(torch.from_numpy(x), torch.from_numpy(adj), wt).backward(
        torch.from_numpy(g))
    zero = w == 0
    want = np.einsum("nfd,nd->nf", x[adj], g)
    np.testing.assert_allclose(wt.grad.numpy()[zero], want[zero], rtol=TOL,
                               atol=TOL)
    assert np.abs(want[zero]).min() > 0


@pytest.mark.parametrize("needs", ["x", "w", "both"])
def test_function_gradients_equal_autograd_of_reference(rng, needs):
    """The gather_spmm Function's backward (the plain versions here, the
    kernels on the card) gives autograd's gradients of the plain forward,
    and only for the inputs that require them."""
    x, adj, w, g = _grad_inputs(rng)
    want_x, want_w = _autograd_of_reference(x, adj, w, g)
    xt = torch.from_numpy(x).requires_grad_(needs in ("x", "both"))
    wt = torch.from_numpy(w).requires_grad_(needs in ("w", "both"))
    out = gather_spmm(xt, torch.from_numpy(adj), wt)
    out.backward(torch.from_numpy(g))
    for t, want, on in ((xt, want_x, needs != "w"),
                        (wt, want_w, needs != "x")):
        if on:
            torch.testing.assert_close(t.grad, want, rtol=TOL, atol=TOL)
        else:
            assert t.grad is None


def test_backward_matches_jax_grad(rng):
    """Against jax.grad of the JAX padded_gather_sum, w == 0 slots and
    repeated indices present."""
    x, adj, w, g = _grad_inputs(rng)

    def f(xs, ws):
        return jnp.sum(padded_gather_sum(xs, jnp.asarray(adj), ws)
                       * jnp.asarray(g))

    jgx, jgw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    gather_spmm(xt, torch.from_numpy(adj), wt).backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgw), rtol=TOL,
                               atol=TOL)


def test_backward_entries_check_their_inputs(rng):
    x, adj, w, g = map(torch.from_numpy, _grad_inputs(rng))
    gather_spmm_grad_w(x, adj, g)
    gather_spmm_grad_x(adj, w, g, x.shape[0])
    for bad in (dict(adj=adj.long()), dict(g=g.double()), dict(g=g[:-1]),
                dict(x=x.to(torch.int8)), dict(x=x[:, :-1]),
                dict(w=w[:, :-1]), dict(g=g.T.contiguous().T)):
        args = dict(x=x, adj=adj, w=w, g=g)
        args.update(bad)
        with pytest.raises((TypeError, ValueError)):
            if "w" in bad:
                gather_spmm_grad_x(args["adj"], args["w"], args["g"], 40)
            else:
                gather_spmm_grad_w(args["x"], args["adj"], args["g"])


def test_bf16_table_gradient_is_bf16(rng):
    x, adj, w, g = _grad_inputs(rng)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    gather_spmm(xt, torch.from_numpy(adj), torch.from_numpy(w)).backward(
        torch.from_numpy(g))
    assert xt.grad.dtype == torch.bfloat16
    want = gather_spmm_grad_x_reference(torch.from_numpy(adj),
                                        torch.from_numpy(w),
                                        torch.from_numpy(g), x.shape[0])
    torch.testing.assert_close(xt.grad, want.to(torch.bfloat16))
