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
another order (a row dot, an index_add_ over repeated rows): 1e-5 too.
The card's transposes (one block; the cooperative grid) are modelled step
by step in numpy and held to a transpose built by hand, exactly."""

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


# ---- grad_x as a gather over the transpose of adj ---------------------------

def _transpose_by_hand(adj, s):
    """row_ptr, slot from Python lists: row r's slots in ascending order."""
    per_row = [[] for _ in range(s)]
    for j, r in enumerate(adj.reshape(-1).tolist()):
        if 0 <= r < s:
            per_row[r].append(j)
    row_ptr = np.cumsum([0] + [len(p) for p in per_row]).astype(np.int32)
    slot = np.full(adj.size, -1, np.int32)
    flat = [j for p in per_row for j in p]
    slot[:len(flat)] = flat
    return row_ptr, slot


def _adj_case(rng, case):
    """(adj [N, F] int32, s) for the four kinds of adj the transpose
    meets."""
    if case == "injective":        # GAT's contiguous layout: a permutation
        return rng.permutation(60)[:48].reshape(12, 4).astype(np.int32), 60
    if case == "repeated":         # sampled ids: rows named many times
        return rng.integers(0, 9, size=(15, 6)).astype(np.int32), 9
    if case == "empty_rows":       # most table rows named by no slot
        return rng.integers(40, 45, size=(7, 3)).astype(np.int32), 100
    if case == "no_slots":         # N * F = 0
        return np.zeros((0, 4), np.int32), 10
    if case == "one_long_row":     # every slot names one row, > a block
        return np.full((300, 5), 4, np.int32), 10
    if case == "skewed":           # ~6% of slots naming 4 rows (padding)
        adj = rng.integers(0, 3000, size=(600, 10)).astype(np.int32)
        adj[rng.random(adj.shape) < 0.06] = rng.integers(0, 4)
        adj[:4, :] = np.arange(4)[:, None]
        return adj, 3000
    adj = rng.integers(0, 20, size=(10, 5)).astype(np.int32)
    adj[[0, 3, 7], [1, 4, 0]] = [-1, 20, 99]            # out of range
    return adj, 20


TRANSPOSE_CASES = ["injective", "repeated", "empty_rows", "out_of_range",
                   "no_slots", "one_long_row"]


@pytest.mark.parametrize("case", TRANSPOSE_CASES)
def test_adj_transpose_reference(rng, case):
    from coala_gnn_tpu_torch.ops.gather_spmm import (adj_transpose,
                                                     adj_transpose_reference)

    adj, s = _adj_case(rng, case)
    want = _transpose_by_hand(adj, s)
    before = dict(LAUNCHES)
    for fn in (adj_transpose_reference, adj_transpose):
        row_ptr, slot = fn(torch.from_numpy(adj), s)
        assert row_ptr.dtype == slot.dtype == torch.int32
        np.testing.assert_array_equal(row_ptr.numpy(), want[0])
        np.testing.assert_array_equal(slot.numpy(), want[1])
    assert LAUNCHES == before


def _one_block_transpose(adj, s, rng):
    """The one-block transpose kernel's algorithm in numpy, its placement
    atomics in a random order: count; exclusive scan in place (= row_ptr);
    the scanned counts as cursors, so each ends at its row's end; then each
    slot to its rank among its row's placed slots."""
    flat = adj.reshape(-1).astype(np.int64)
    ok = (flat >= 0) & (flat < s)
    count = np.zeros(s + 1, np.int64)
    np.add.at(count, flat[ok], 1)
    count[s] = count[:s].sum()
    count[:s] = np.cumsum(count[:s]) - count[:s]
    row_ptr = count.copy()
    placed = np.empty(flat.size, np.int64)
    for j in rng.permutation(np.flatnonzero(ok)):
        placed[count[flat[j]]] = j
        count[flat[j]] += 1
    slot = np.full(flat.size, -1, np.int64)
    for j in np.flatnonzero(ok):
        r = flat[j]
        beg, end = (count[r - 1] if r else 0), count[r]
        slot[beg + int((placed[beg:end] < j).sum())] = j
    return row_ptr, slot


@pytest.mark.parametrize("case", TRANSPOSE_CASES)
def test_one_block_transpose_algorithm(rng, case):
    """The card's one-launch transpose, step by step in numpy, gives the
    transpose by hand whatever order its placement atomics take."""
    adj, s = _adj_case(rng, case)
    want = _transpose_by_hand(adj, s)
    for _ in range(3):
        got = _one_block_transpose(adj, s, rng)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def _bitmap_rank(seg, window):
    """A long row's ranks as the grid transpose's block computes them: the
    slots' range [lo, hi] in windows of ``window`` words x 32 bits, in
    each a bit per slot, the exclusive scan of the words' popcounts, and a
    slot's rank = carry + its word's prefix + the bits below it in its
    word. Returns the slots in rank order."""
    seg = np.asarray(seg, np.int64)
    out = np.full(seg.size, -1, np.int64)
    carry, base = 0, int(seg.min())
    while base <= seg.max():
        words = min(window, (int(seg.max()) - base) // 32 + 1)
        x = seg - base
        inside = (x >= 0) & (x < words * 32)
        bits = np.zeros(words, np.uint64)
        np.bitwise_or.at(bits, x[inside] >> 5,
                         np.uint64(1) << (x[inside] & 31).astype(np.uint64))
        pop = np.array([bin(int(w)).count("1") for w in bits], np.int64)
        pre = carry + np.cumsum(pop) - pop
        for v, xv in zip(seg[inside], x[inside]):
            below = int(bits[xv >> 5]) & ((1 << int(xv & 31)) - 1)
            out[pre[xv >> 5] + bin(below).count("1")] = v
        carry += int(pop.sum())
        base += window * 32
    return out


def _lane_sort(seg, lane_slots=16):
    """A short row as one lane sorts it: a bitonic network over
    ``lane_slots`` registers, INT32_MAX past the row, each stage k a flip
    (i with i ^ (k - 1)) then half-cleaners (i with i ^ j)."""
    v = list(seg) + [2**31 - 1] * (lane_slots - len(seg))
    k = 2
    while k <= lane_slots:
        j = k >> 1
        while j:
            for i in range(lane_slots):
                c = i ^ (k - 1) if j == k >> 1 else i ^ j
                if c > i:
                    v[i], v[c] = min(v[i], v[c]), max(v[i], v[c])
            j >>= 1
        k <<= 1
    return v[:len(seg)]


def _grid_transpose(adj, s, rng, blocks, window, lane_slots=16, warp=32):
    """The grid transpose's algorithm in numpy: blocks own row ranges
    (counts zeroed and scanned per block, then offset by the totals of the
    blocks before); the placement's warps run in a random order, each
    warp's lanes that name one row sharing one atomic (consecutive
    positions in lane order); then each row ranked with work per row: up
    to ``lane_slots`` placed slots by one lane's sorting network
    (``_lane_sort``), up to a warp by the lanes' shuffles (each slot's rank
    the number of the row's slots below it), longer rows listed (in a random order) and dealt round the
    blocks, each ranked by its bitmap (``_bitmap_rank``)."""
    flat = adj.reshape(-1).astype(np.int64)
    nf = flat.size
    r = np.where((flat >= 0) & (flat < s), flat, -1)
    per = -(-s // blocks)
    count = np.zeros(s, np.int64)
    np.add.at(count, r[r >= 0], 1)
    totals = []
    for b in range(blocks):                       # each block's own scan
        lo, hi = min(b * per, s), min(b * per + per, s)
        c = count[lo:hi].copy()
        count[lo:hi] = np.cumsum(c) - c
        totals.append(int(c.sum()))
    row_ptr = np.zeros(s + 1, np.int64)
    for b in range(blocks):
        lo, hi = min(b * per, s), min(b * per + per, s)
        count[lo:hi] += sum(totals[:b])
        row_ptr[lo:hi] = count[lo:hi]
    grand = row_ptr[s] = sum(totals)
    placed = np.full(nf, -7, np.int64)
    for w0 in rng.permutation(np.arange(0, nf, warp)):   # warps, any order
        lanes = np.arange(w0, min(w0 + warp, nf))
        for row in dict.fromkeys(r[lanes].tolist()):    # leaders
            if row < 0:
                continue
            peers = lanes[r[lanes] == row]              # lane order
            placed[count[row] + np.arange(peers.size)] = peers
            count[row] += peers.size
    slot = np.full(nf, -7, np.int64)
    slot[grand:] = -1
    longs = []
    for tile in rng.permutation(-(-s // warp)):   # tiles, any order
        for row in range(tile * warp, min(tile * warp + warp, s)):
            beg, d = row_ptr[row], count[row] - row_ptr[row]
            if d > warp:
                longs.append(row)
            elif d <= lane_slots:                 # a lane's network
                slot[beg:beg + d] = _lane_sort(placed[beg:beg + d])
            else:                                 # the warp's ranks
                v = placed[beg:beg + d]
                for x in v:
                    slot[beg + int((v < x).sum())] = x
    longs = [longs[i] for i in rng.permutation(len(longs))]
    for b in range(blocks):                       # dealt round: q % blocks
        for row in longs[b::blocks]:
            beg, d = row_ptr[row], count[row] - row_ptr[row]
            slot[beg:beg + d] = _bitmap_rank(placed[beg:beg + d], window)
    return row_ptr, slot


@pytest.mark.parametrize("case", TRANSPOSE_CASES + ["skewed"])
def test_grid_transpose_algorithm(rng, case):
    """The card's grid transpose, step by step in numpy, gives the
    transpose by hand whatever order the placement's warps, the tiles and
    the long-row list take: 1 to 5 blocks, and bitmap windows from the
    card's 8,192 words down to one word (every long row then spans many
    windows)."""
    adj, s = _adj_case(rng, case)
    want = _transpose_by_hand(adj, s)
    for blocks, window in [(3, 8192), (5, 2048), (1, 1), (2, 2)]:
        got = _grid_transpose(adj, s, rng, blocks, window)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("d", range(1, 17))
def test_transpose_lane_sort_network(rng, d):
    """One lane's network sorts every row length up to 16, the padding
    past the row included."""
    seg = rng.permutation(1000)[:d]
    assert _lane_sort(seg) == sorted(seg.tolist())


@pytest.mark.parametrize("d,window", [(33, 1), (33, 8192), (100, 2),
                                      (513, 4), (1024, 8192), (3000, 16),
                                      (4096, 1), (20_000, 64)])
def test_transpose_long_row_bitmap_rank(rng, d, window):
    """A long row's bitmap ranks put its slots in ascending order, over one
    window or many (slot ids spread over ~10 x d)."""
    seg = rng.permutation(10 * d)[:d]
    np.testing.assert_array_equal(_bitmap_rank(seg, window), np.sort(seg))


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16])
def test_grad_w_lane_group_sum_is_the_warp_tree(rng, lanes):
    """grad_w's narrow form sums a dot's lane partials over a group of
    ``lanes`` lanes (xor levels lanes / 2 .. 1); the 32-lane xor tree
    (levels 16 .. 1, the tree each dot of the wide form is summed over,
    tests/test_torch_grad_w_design.py) over the same partials, the lanes
    past the row holding 0. In f32 the two are equal bit for bit: the
    tree's upper levels add +0."""
    parts = (rng.standard_normal((2000, 32)) *
             np.exp(rng.uniform(-40, 40, (2000, 32)))).astype(np.float32)
    warp = parts.copy()
    warp[:, lanes:] = 0
    for off in (16, 8, 4, 2, 1):
        warp = warp + warp[:, np.arange(32) ^ off]
    group = parts[:, :lanes].copy()
    off = lanes // 2
    while off:
        group = group + group[:, np.arange(lanes) ^ off]
        off //= 2
    assert warp.dtype == group.dtype == np.float32
    np.testing.assert_array_equal(warp[:, 0].view(np.int32),
                                  group[:, 0].view(np.int32))


@pytest.mark.parametrize("case", ["injective", "repeated", "empty_rows"])
def test_grad_x_over_transpose_equals_index_add_bitwise(rng, case):
    """The kernel's algorithm in plain torch (per table row, acc = acc +
    w * g over its slots in slot order) equals the CPU index_add_ plain
    version bit for bit, zero-weight slots and repeated rows included."""
    from coala_gnn_tpu_torch.ops.gather_spmm import (
        adj_transpose_reference, gather_spmm_grad_x_transposed_reference)

    adj, s = _adj_case(rng, case)
    n, f = adj.shape
    w = rng.random((n, f)).astype(np.float32)
    w[rng.random((n, f)) < 0.3] = 0.0
    g = rng.normal(size=(n, 33)).astype(np.float32)
    at, wt, gt = map(torch.from_numpy, (adj, w, g))
    got = gather_spmm_grad_x_transposed_reference(
        adj_transpose_reference(at, s), wt, gt)
    want = gather_spmm_grad_x_reference(at, wt, gt, s)
    assert torch.equal(got, want)
    assert torch.equal(got, gather_spmm_grad_x(at, wt, gt, s,
                                               adj_transpose_reference(at, s)))


def test_grad_x_over_head_stacked_transpose(rng):
    """GAT's combine layout: every feat row named by one slot, so the sums
    are single products and all three forms agree exactly."""
    from coala_gnn_tpu_torch.models.layers import head_stacked_adj
    from coala_gnn_tpu_torch.ops.gather_spmm import (
        adj_transpose, gather_spmm_grad_x_transposed_reference)

    cap_dst, fan, heads = 6, 3, 4
    n_src = cap_dst * (fan + 1)
    adj = head_stacked_adj(None, n_src, (cap_dst, fan), heads, "cpu")
    s = n_src * heads
    row_ptr, slot = adj_transpose(adj, s)
    counts = (row_ptr[1:] - row_ptr[:-1]).numpy()
    assert set(counts.tolist()) == {0, 1}
    assert counts[:cap_dst * heads].sum() == 0     # dst rows: no slot
    w = torch.from_numpy(rng.random(adj.shape).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(adj.shape[0], 5)).astype(
        np.float32))
    assert torch.equal(
        gather_spmm_grad_x_transposed_reference((row_ptr, slot), w, g),
        gather_spmm_grad_x_reference(adj, w, g, s))


def test_transpose_argument_is_checked(rng):
    from coala_gnn_tpu_torch.ops.gather_spmm import (adj_transpose,
                                                     adj_transpose_reference)

    x, adj, w, g = map(torch.from_numpy, _grad_inputs(rng))
    s = x.shape[0]
    good = adj_transpose_reference(adj, s)
    gather_spmm(x, adj, w, adj_t=good)
    gather_spmm_grad_x(adj, w, g, s, good)
    bad = [good[0],                                    # not a pair
           (good[0][:-1], good[1]),                    # row_ptr length
           (good[0], good[1][:-1]),                    # slot length
           (good[0].long(), good[1]),                  # dtype
           (good[0], good[1].view(adj.shape)),         # shape
           (good[0], torch.stack([good[1]] * 2, 1)[:, 0])]   # contiguity
    for adj_t in bad:
        with pytest.raises((TypeError, ValueError)):
            gather_spmm(x, adj, w, adj_t=adj_t)
        with pytest.raises((TypeError, ValueError)):
            gather_spmm_grad_x(adj, w, g, s, adj_t)
    for bad_adj in (adj.long(), adj.reshape(-1), adj.T):
        with pytest.raises(TypeError):
            adj_transpose(bad_adj, s)
    with pytest.raises(ValueError):
        adj_transpose(adj, 2**31)


def test_function_backward_with_transpose(rng):
    """Handing the transpose in changes nothing of the gradients."""
    from coala_gnn_tpu_torch.ops.gather_spmm import adj_transpose_reference

    x, adj, w, g = _grad_inputs(rng)
    want_x, want_w = _autograd_of_reference(x, adj, w, g)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    at = torch.from_numpy(adj)
    gather_spmm(xt, at, wt, adj_t=adj_transpose_reference(
        at, x.shape[0])).backward(torch.from_numpy(g))
    torch.testing.assert_close(xt.grad, want_x, rtol=TOL, atol=TOL)
    torch.testing.assert_close(wt.grad, want_w, rtol=TOL, atol=TOL)
