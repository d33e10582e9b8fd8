"""grad_w's kernels (coala_gnn_tpu_torch/csrc/gather_spmm.cu) modelled in
numpy, step for step, and the model held to the plain version
``gather_spmm_grad_w_reference``.

No CUDA kernel runs on the CPU, so the model carries the kernels'
arithmetic here: the vector width chosen by alignment, each lane's fmaf
chain over its vectors in column order (fused multiply-adds rounded once
to f32, as the card's), and the sums of the lane partials. The wide form
(one warp per dst row) is modelled as it now is: a chunk of 32 slots, each
slot's first occurrence in it, only the distinct rows read, their dots
reduced up to four at a time by the transposed butterfly
(``reduce_dots<P>``), and every slot taking its first occurrence's dot.
The narrow form sums a lane group's partials over the group's xor levels.
Tolerance: ``grad_w_error_bound``, the f32 error bound of a D-term dot
summed in two orders. The card holds the kernels to the same plain version
(tests/test_torch_cuda.py, chip_smoke.py) and to the form they replaced
(chip_compare.py, bit for bit). The plain version itself is held to
``jax.grad`` of the JAX package's relational combine on a stacked layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coala_gnn_tpu.ops.aggregate import padded_gather_sum
from coala_gnn_tpu_torch.models.layers import head_stacked_adj
from coala_gnn_tpu_torch.ops.aggregate import live_or_own
from coala_gnn_tpu_torch.ops.gather_spmm import (
    gather_spmm_grad_w, gather_spmm_grad_w_reference, grad_w_error_bound)

torch.set_num_threads(1)
WARP, DOTS = 32, 4            # lanes of a warp; kDots of the wide form
TOL = 1e-5
LANE = np.arange(WARP)


def _fmaf(a, b, c):
    """fmaf on f32 arrays: a * b + c rounded once to f32. The product is
    exact in f64; the sum is rounded to odd there (a two-sum gives its
    error), which then rounds to f32 as the exact sum would."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = c.astype(np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(np.int64) & 1) == 0
    toward = np.where(err > 0, np.inf, -np.inf)
    s = np.where((err != 0) & even, np.nextafter(s, toward), s)
    return s.astype(np.float32)


def _vec_bytes(d, item):
    """The largest of 16, 8, 4, 2 bytes dividing a row (bases aligned)."""
    vb = 16
    while vb > item and (d * item) % vb:
        vb //= 2
    return vb


def _lanes_for(row_bytes, vb):
    lanes = 1
    while lanes < -(-row_bytes // vb) and lanes < 256:
        lanes *= 2
    return lanes


def _lane_partials(rows, g, e, lanes):
    """[M, lanes] f32: lane l's fmaf chain over its vectors of E elements,
    columns c0 + l * E + j for c0 = 0, lanes * E, ... and j < E, in that
    order (E divides D, so a vector lies wholly below D or not at all)."""
    m, d = rows.shape
    part = np.zeros((m, lanes), np.float32)
    for c0 in range(0, d, lanes * e):
        for j in range(e):
            cols = c0 + np.arange(lanes) * e + j
            ok = cols < d
            part[:, ok] = _fmaf(g[:, cols[ok]], rows[:, cols[ok]],
                                part[:, ok])
    return part


def _xor_tree(v, lanes=WARP):
    """v [..., lanes] summed over xor levels lanes / 2, ..., 1 (each lane
    ends with the sum; the old warp-per-slot form's tree at 32)."""
    idx, off = np.arange(lanes), lanes // 2
    while off:
        v = v + v[..., idx ^ off]
        off //= 2
    return v


def _reduce_dots(v, p):
    """reduce_dots<P>: v [M, 32, P] lane partials -> [M, 32], lane l
    holding dot l // (32 // P). The first log2 P levels halve the values a
    lane holds (it keeps the half its lane bit names and adds its
    partner's), the rest are the plain xor tree."""
    h, off = p // 2, WARP // 2
    while h >= 1:
        up = ((LANE & off) != 0)[:, None]
        send = np.where(up, v[:, :, :h], v[:, :, h:2 * h])
        keep = np.where(up, v[:, :, h:2 * h], v[:, :, :h])
        v = keep + send[:, LANE ^ off, :]
        h, off = h // 2, off // 2
    s = v[:, :, 0]
    off = WARP // (2 * p)
    while off:
        s = s + s[:, LANE ^ off]
        off //= 2
    return s


def grad_w_model(x, adj, g):
    """The card's grad_w of a table x (torch, f32 or bf16), adj int32 and
    g f32 -> (f32 [N, F] numpy, rows read). Out-of-range slots give NaN."""
    s_rows, d = x.shape
    item = x.element_size()
    xf, adj, g = x.float().numpy(), adj.numpy(), g.numpy()
    vb = _vec_bytes(d, item)
    e, lanes = vb // item, _lanes_for(d * item, vb)
    n, f = adj.shape
    bad = (adj < 0) | (adj >= s_rows)
    if lanes < WARP:                       # narrow: a lane group per slot
        safe = np.where(bad, 0, adj).reshape(-1)
        part = _lane_partials(xf[safe], np.repeat(g, f, axis=0), e, lanes)
        out = _xor_tree(part, lanes)[:, 0].reshape(n, f)
        return np.where(bad, np.float32(np.nan), out), int((~bad).sum())
    out, reads = np.empty((n, f), np.float32), 0
    for k0 in range(0, f, WARP):           # wide: a chunk of 32 slots
        idx, bd = adj[:, k0:k0 + WARP], bad[:, k0:k0 + WARP]
        fc = idx.shape[1]
        first = np.argmax(idx[:, :, None] == idx[:, None, :], axis=2)
        new = (first == np.arange(fc)) & ~bd
        rank = np.cumsum(new, axis=1) - 1  # a distinct row's ordinal
        nd = new.sum(axis=1)
        reads += int(nd.sum())
        dpart = np.zeros((n, WARP, WARP), np.float32)  # [row, i, lane]
        r, k = np.nonzero(new)
        dpart[r, rank[r, k]] = _lane_partials(xf[idx[r, k]], g[r], e, WARP)
        dot = np.zeros((n, WARP), np.float32)      # lane i: dot i
        for i0 in range(0, WARP, DOTS):
            m = np.clip(nd - i0, 0, DOTS)
            for p in (1, 2, 4):            # P: m rounded up to a power of 2
                rows = np.nonzero((m > p // 2) & (m <= p))[0]
                if rows.size:
                    sums = _reduce_dots(
                        dpart[rows, i0:i0 + p].transpose(0, 2, 1), p)
                    src = (np.arange(DOTS) * (WARP // p)) % WARP
                    dot[rows, i0:i0 + DOTS] = sums[:, src]
        got = np.take_along_axis(dot, np.take_along_axis(rank, first, 1), 1)
        out[:, k0:k0 + fc] = np.where(bd, np.float32(np.nan), got)
    return out, reads


def grad_w_per_slot(x, adj, g):
    """The wide form before this design: every slot's row read and its
    lane partials summed by the 32-lane xor tree (in-range slots)."""
    d, item = x.shape[1], x.element_size()
    e = _vec_bytes(d, item) // item
    n, f = adj.shape
    part = _lane_partials(x.float().numpy()[adj.numpy().reshape(-1)],
                          np.repeat(g.numpy(), f, axis=0), e, WARP)
    return _xor_tree(part)[:, 0].reshape(n, f)


def _check(x, adj, g):
    """The model within the bound of the plain version, NaN exactly at
    out-of-range slots, each repeated slot bitwise its first occurrence in
    its chunk, and (wide form) the distinct in-range rows of each chunk
    read once; the narrow form reads every in-range slot's row."""
    s_rows, d = x.shape
    item = x.element_size()
    wide = _lanes_for(d * item, _vec_bytes(d, item)) >= WARP
    got, reads = grad_w_model(x, adj, g)
    a = adj.numpy()
    bad = (a < 0) | (a >= s_rows)
    assert np.isnan(got[bad]).all() and not np.isnan(got[~bad]).any()
    ok = torch.from_numpy(np.where(bad, 0, a))
    err = np.abs(got - gather_spmm_grad_w_reference(x, ok, g).numpy())
    assert (err <= grad_w_error_bound(x, ok, g).numpy())[~bad].all()
    want_reads = 0
    for n in range(a.shape[0]):
        for k0 in range(0, a.shape[1], WARP):
            row, b = a[n, k0:k0 + WARP], bad[n, k0:k0 + WARP]
            want_reads += np.unique(row[~b]).size
            for k in range(row.size):
                j = int(np.argmax(row == row[k]))
                assert got[n, k0 + k].view(np.int32) == \
                    got[n, k0 + j].view(np.int32)
    assert reads == (want_reads if wide else int((~bad).sum()))
    return got, reads


def _table(rng, s, d, dtype):
    return torch.from_numpy(rng.normal(size=(s, d)).astype(np.float32)).to(
        dtype)


@pytest.mark.parametrize("p", [1, 2, 4])
def test_reduce_dots_is_the_xor_tree(rng, p):
    """Each of P dots out of the transposed butterfly is bitwise the
    32-lane xor tree's sum of its partials, on the lane that the kernel
    reads it from (j * 32 / P)."""
    v = (rng.standard_normal((500, WARP, p)) *
         np.exp(rng.uniform(-40, 40, (500, WARP, p)))).astype(np.float32)
    sums = _reduce_dots(v.copy(), p)
    for j in range(p):
        want = _xor_tree(v[:, :, j])[:, 0]
        np.testing.assert_array_equal(sums[:, j * (WARP // p)].view(np.int32),
                                      want.view(np.int32))


def test_fmaf_rounds_once(rng):
    """The model's fmaf is the correctly rounded a * b + c: it agrees with
    exact rational arithmetic where a separate multiply and add would
    round twice."""
    from fractions import Fraction

    a, b, c = (rng.standard_normal(400).astype(np.float32) for _ in range(3))
    c *= np.float32(1e-6)
    got = _fmaf(a, b, c)
    twice = a * b + c
    for i in range(a.size):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + \
            Fraction(float(c[i]))
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.array(v).view(np.int32)) & 1))
        assert got[i] == best
    assert (got != twice).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [128, 256, 200, 1024])
@pytest.mark.parametrize("f", [1, 5, 10, 32, 33])
def test_model_within_bound_of_plain(rng, f, d, dtype):
    """Random slots drawn from few rows (repeats in most dst rows), some
    out of range; the zero-weight slots of a sampled layer computed like
    any other."""
    s_rows, n = 12, 20
    x = _table(rng, s_rows, d, dtype)
    g = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    adj = rng.integers(0, s_rows, size=(n, f)).astype(np.int32)
    w = rng.random((n, f)).astype(np.float32)
    w[rng.random((n, f)) < 0.3] = 0.0
    adj[1, 0], adj[n - 1, f - 1] = -1, s_rows
    got, _ = _check(x, torch.from_numpy(adj), g)
    zero = (w == 0) & (adj >= 0) & (adj < s_rows)    # within the bound
    assert zero.any() and np.isfinite(got[zero]).all()   # by _check
    assert (got[zero] != 0).all()


def _stacked_host(rng, rels, cap_dst=16, f=10, heads=4):
    """The host layout of an RGAT layer: a typed block, ~20% of slots
    masked, each relation's dead slots at their own dst row, stacked."""
    n_src = cap_dst * (1 + f)
    adj = rng.integers(0, n_src, size=(cap_dst, f)).astype(np.int32)
    own = np.broadcast_to(np.arange(cap_dst, dtype=np.int32)[:, None],
                          adj.shape)
    mask = rng.random((cap_dst, f)) >= 0.2
    adj = np.where(mask, adj, own)
    rel = rng.integers(0, rels, size=(cap_dst, f))
    live = mask[None] & (rel[None] == np.arange(rels)[:, None, None])
    stacked = head_stacked_adj(
        live_or_own(torch.from_numpy(adj)[None], torch.from_numpy(live)),
        n_src, (cap_dst, f), heads, "cpu", rels)
    return stacked, rels * n_src * heads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["stacked R=3", "stacked R=8",
                                    "contiguous GAT"])
def test_model_on_the_combine_layouts(rng, layout, dtype):
    """RGAT's stacked host layout (3 and 8 relations) reads one row per
    distinct index of a dst row, well under one per slot; GAT's
    contiguous layout reads every slot's row, each once."""
    d, heads = 256, 4
    if layout == "contiguous GAT":
        cap_dst, f = 16, 10
        n_src = cap_dst * (1 + f)
        adj = head_stacked_adj(None, n_src, (cap_dst, f), heads, "cpu")
        s_rows = n_src * heads
    else:
        adj, s_rows = _stacked_host(rng, int(layout[-1]))
    x = _table(rng, s_rows, d, dtype)
    g = torch.from_numpy(rng.normal(size=(adj.shape[0], d)).astype(
        np.float32))
    _, reads = _check(x, adj, g)
    if layout == "contiguous GAT":
        assert reads == adj.numel()
    else:
        assert reads < 0.6 * adj.numel()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [128, 200, 256, 1024])
def test_model_bitwise_the_per_slot_form(rng, d, dtype):
    """Reading each distinct row once and reducing the dots together
    changes no bit: every slot's value equals the per-slot form's (its
    row read, its partials summed by the 32-lane tree), on the stacked
    host layout and across a chunk boundary (F = 33)."""
    adj, s_rows = _stacked_host(rng, 3, cap_dst=6)
    x = _table(rng, s_rows, d, dtype)
    wide = torch.from_numpy(rng.integers(0, s_rows, size=(7, 33)).astype(
        np.int32))
    for a in (adj, wide):
        g = torch.from_numpy(rng.normal(size=(a.shape[0], d)).astype(
            np.float32))
        got, _ = grad_w_model(x, a, g)
        np.testing.assert_array_equal(
            got.view(np.int32), grad_w_per_slot(x, a, g).view(np.int32))


def test_plain_grad_w_matches_jax_grad_on_stacked_layout(rng):
    """The plain version on the stacked host layout (3 relations, 2 heads)
    against jax.grad of the JAX package's per-relation combine (one
    padded_gather_sum per relation and head, relation r's adj with its
    dead slots at their own dst row) with respect to the attention."""
    rels, heads, cap_dst, f, d = 3, 2, 8, 5, 16
    n_src = cap_dst * (1 + f)
    adj = rng.integers(0, n_src, size=(cap_dst, f)).astype(np.int32)
    rel = rng.integers(0, rels, size=(cap_dst, f))
    live = (rel[None] == np.arange(rels)[:, None, None]) & (
        rng.random((cap_dst, f)) >= 0.2)[None]
    adj_r = np.where(live, adj[None], np.arange(cap_dst)[None, :, None])
    feat = rng.normal(size=(rels, n_src, heads, d)).astype(np.float32)
    alpha = (rng.random((rels, cap_dst, f, heads)) * live[..., None]).astype(
        np.float32)
    up = rng.normal(size=(rels, cap_dst, heads, d)).astype(np.float32)

    def loss(a):
        return sum(jnp.sum(padded_gather_sum(
            jnp.asarray(feat[r, :, h]), jnp.asarray(adj_r[r]), a[r, :, :, h])
            * jnp.asarray(up[r, :, h])) for r in range(rels)
            for h in range(heads))

    want = np.asarray(jax.grad(loss)(jnp.asarray(alpha)))  # [R, dst, F, H]
    stacked = head_stacked_adj(torch.from_numpy(adj_r), n_src, (cap_dst, f),
                               heads, "cpu", rels)
    x = torch.from_numpy(feat.reshape(rels * n_src * heads, d))
    g = torch.from_numpy(up.reshape(rels * cap_dst * heads, d))
    got = gather_spmm_grad_w(x, stacked, g)     # the CPU takes the plain one
    np.testing.assert_allclose(
        got.numpy(), want.transpose(0, 1, 3, 2).reshape(-1, f), rtol=TOL,
        atol=TOL)
    dead = ~np.repeat(live.reshape(-1, f), heads, axis=0)
    assert (got.numpy()[dead] != 0).all()
