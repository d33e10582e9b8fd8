"""The set-associative tier of coala_gnn_tpu_torch/cache/feature_cache.py
against coala_gnn_tpu/cache/feature_cache.py: the same sequences of
inserts, lookups and probes on the same numpy inputs give bitwise-equal
states (tags, data, rr, color_counts, line_colors, line_prio, counters)
and equal outputs (rows, hits, evicted ids, stats). The cases mirror the
associative tests of tests/test_cache.py and add the edge cases the
one-writer rule and the stable sorts exist for: duplicate ids, more than
32 arrivals to one set, a same-batch refresh a new arrival clobbers, and
priority ties, with track_prio off and on.

The port's states carry one scratch set (row num_sets) that JAX does not
have, and size the side tables by cfg.ways where JAX uses WAYS = 32;
the comparison takes the rows and ways JAX uses."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coala_gnn_tpu.cache import feature_cache as jfc
from coala_gnn_tpu.native import lib as native_lib
from coala_gnn_tpu_torch.cache import feature_cache as tfc

torch.set_num_threads(1)


class Pair:
    """One JAX state and one port state, driven in lockstep."""

    def __init__(self, num_sets, ways=jfc.WAYS, dim=16, num_colors=0,
                 colored=False, track_prio=False, dtype="float32",
                 quantize=False):
        kw = dict(num_sets=num_sets, ways=ways, dim=dim,
                  cache_dim=jfc.round_cache_dim(dim), num_colors=num_colors,
                  quantize=quantize)
        self.jcfg = jfc.CacheConfig(dtype=getattr(jnp, dtype), **kw)
        self.tcfg = tfc.CacheConfig(dtype=getattr(torch, dtype), **kw)
        self.colored = colored
        if colored:
            self.j = jfc.init_colored_state(self.jcfg, track_prio=track_prio)
            self.t = tfc.init_colored_state(self.tcfg, "cpu",
                                            track_prio=track_prio)
        else:
            self.j = jfc.init_state(self.jcfg)
            self.t = tfc.init_state(self.tcfg, "cpu")

    @property
    def jbase(self):
        return self.j.base if self.colored else self.j

    @property
    def tbase(self):
        return self.t.base if self.colored else self.t

    def tags(self):
        return self.tbase.tags[:self.tcfg.num_sets].numpy()

    def check(self):
        S, W = self.jcfg.num_sets, self.jcfg.ways
        jb, tb = self.jbase, self.tbase
        np.testing.assert_array_equal(tb.tags[:S].numpy(),
                                      np.asarray(jb.tags))
        np.testing.assert_array_equal(tb.data[:S].float().numpy(),
                                      np.asarray(jb.data.astype(jnp.float32)))
        np.testing.assert_array_equal(tb.rr.numpy(), np.asarray(jb.rr))
        assert (tb.scales is None) == (jb.scales is None)
        if jb.scales is not None:
            np.testing.assert_array_equal(tb.scales[:S].numpy(),
                                          np.asarray(jb.scales))
        np.testing.assert_array_equal(tb.color_counts.numpy(),
                                      np.asarray(jb.color_counts))
        assert int(tb.hits) == int(jb.hits)
        assert int(tb.misses) == int(jb.misses)
        if self.colored:
            np.testing.assert_array_equal(
                self.t.line_colors[:S].numpy(),
                np.asarray(self.j.line_colors)[:, :W])
            assert (self.t.line_prio is None) == (self.j.line_prio is None)
            if self.j.line_prio is not None:
                np.testing.assert_array_equal(
                    self.t.line_prio[:S].numpy(),
                    np.asarray(self.j.line_prio)[:, :W])

    def insert(self, ids, feats, valid=None, colors=None, prios=None,
               return_evicted=False):
        ids = np.asarray(ids, np.int32)
        valid = np.ones(ids.size, bool) if valid is None else np.asarray(
            valid, bool)
        feats = np.asarray(feats, np.float32)
        if not self.colored:
            self.j = jfc.insert(self.jcfg, self.j, jnp.asarray(ids),
                                jnp.asarray(feats), jnp.asarray(valid))
            tfc.insert(self.tcfg, self.t, torch.from_numpy(ids),
                       torch.from_numpy(feats), torch.from_numpy(valid))
            self.check()
            return None
        colors = (np.zeros(ids.size, np.int32) if colors is None
                  else np.asarray(colors, np.int32))
        jp = None if prios is None else jnp.asarray(prios, jnp.float32)
        tp = None if prios is None else torch.as_tensor(
            np.asarray(prios, np.float32))
        jout = jfc.insert_with_colors(
            self.jcfg, self.j, jnp.asarray(ids), jnp.asarray(feats),
            jnp.asarray(valid), jnp.asarray(colors), prios=jp,
            return_evicted=return_evicted)
        tout = tfc.insert_with_colors(
            self.tcfg, self.t, torch.from_numpy(ids),
            torch.from_numpy(feats), torch.from_numpy(valid),
            torch.from_numpy(colors), prios=tp,
            return_evicted=return_evicted)
        ev = None
        if return_evicted:
            self.j, jev = jout
            assert tout[0] is self.t
            ev = tout[1].numpy()
            np.testing.assert_array_equal(ev, np.asarray(jev))
        else:
            self.j = jout
            assert tout is self.t
        self.check()
        return ev

    def lookup(self, ids, valid=None, count_stats=True):
        ids = np.asarray(ids, np.int32)
        valid = np.ones(ids.size, bool) if valid is None else np.asarray(
            valid, bool)
        jb, jf, jh = jfc.lookup(self.jcfg, self.jbase, jnp.asarray(ids),
                                jnp.asarray(valid), count_stats=count_stats)
        self.j = self.j._replace(base=jb) if self.colored else jb
        _, tf, th = tfc.lookup(self.tcfg, self.tbase, torch.from_numpy(ids),
                               torch.from_numpy(valid),
                               count_stats=count_stats)
        assert tf.dtype == self.tcfg.dtype
        np.testing.assert_array_equal(tf.float().numpy(),
                                      np.asarray(jf.astype(jnp.float32)))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(
            tfc.probe(self.tcfg, self.tbase, torch.from_numpy(ids),
                      torch.from_numpy(valid)).numpy(),
            np.asarray(jfc.probe(self.jcfg, self.jbase, jnp.asarray(ids),
                                 jnp.asarray(valid))))
        self.check()
        return th.numpy(), tf.float().numpy()

    def stats(self):
        jb, js = jfc.stats(self.jbase)
        self.j = self.j._replace(base=jb) if self.colored else jb
        _, ts = tfc.stats(self.tbase)
        assert ts == js
        self.check()
        return ts


def _feats(rng, n, dim=16):
    return rng.normal(size=(n, dim)).astype(np.float32)


# ---- the associative cases of tests/test_cache.py ------------------------

def case_miss_then_hit_roundtrip(rng, colored):
    p = Pair(4, colored=colored)
    ids = np.arange(10)
    hit, out = p.lookup(ids)
    assert not hit.any() and (out == 0).all()
    f = _feats(rng, 10)
    p.insert(ids, f)
    hit, out = p.lookup(ids)
    assert hit.all()
    np.testing.assert_array_equal(out, f)
    assert p.stats() == {"hits": 10, "misses": 10, "hit_ratio": 0.5}
    assert p.stats()["hits"] == 0


def case_same_set_claims_distinct_ways(rng, colored):
    p = Pair(2, colored=colored)
    ids = np.arange(8) * 2                       # all in set 0
    f = _feats(rng, 8)
    p.insert(ids, f)
    hit, out = p.lookup(ids)
    assert hit.all()
    np.testing.assert_array_equal(out, f)


def case_round_robin_eviction(rng, colored):
    p = Pair(1, colored=colored)
    ids, f = np.arange(40), _feats(rng, 40)
    p.insert(ids[:32], f[:32])
    p.insert(ids[32:], f[32:])
    hit, _ = p.lookup(ids)
    assert not hit[:8].any() and hit[8:].all()


def case_refresh_does_not_duplicate(rng, colored):
    p = Pair(2, colored=colored)
    p.insert([4, 6], _feats(rng, 2))
    f2 = _feats(rng, 2)
    p.insert([4, 6], f2)
    tags = p.tags()
    assert (tags == 4).sum() == 1 and (tags == 6).sum() == 1
    np.testing.assert_array_equal(p.lookup([4, 6])[1], f2)


def case_invalid_rows_dropped(rng, colored):
    p = Pair(4, colored=colored)
    p.insert([1, 2, 3], _feats(rng, 3), valid=[True, False, True])
    np.testing.assert_array_equal(p.lookup([1, 2, 3])[0],
                                  [True, False, True])


def case_overflowing_set_keeps_first_ways_ranks(rng, colored):
    p = Pair(1, ways=2, dim=4, colored=colored)
    p.insert(np.arange(5), _feats(rng, 5, 4))
    tags = p.tags()[0]
    assert (tags >= 0).all() and len(set(tags.tolist())) == 2


def case_color_occupancy_tracking(rng, colored):
    p = Pair(1, num_colors=5, colored=True)
    p.insert(np.arange(32), np.zeros((32, 16)),
             colors=np.arange(32) % 5 + 1)
    np.testing.assert_array_equal(p.t.base.color_counts[1:].numpy(),
                                  [7, 7, 6, 6, 6])
    p.insert(np.arange(100, 104), np.zeros((4, 16)), colors=[5] * 4)
    np.testing.assert_array_equal(p.t.base.color_counts[1:].numpy(),
                                  [6, 6, 5, 5, 10])


def case_refresh_clobbered_by_new_arrival(rng, colored):
    p = Pair(1, ways=2, dim=4, num_colors=4, colored=True)
    f = np.arange(20, dtype=np.float32).reshape(5, 4) + 1
    p.insert([0], f[[0]], colors=[1])
    # refresh id 0 (way 0) + new ids 1, 2 (ways 1, 0): id 2 clobbers it
    ev = p.insert([0, 1, 2], f[[0, 1, 2]], colors=[1, 2, 3],
                  return_evicted=True)
    assert set(p.tags()[0].tolist()) == {1, 2}
    assert sorted(ev[ev >= 0].tolist()) == [0]
    np.testing.assert_array_equal(p.t.base.color_counts.numpy(),
                                  [0, 0, 1, 1, 0])


def case_priority_admission_protects_hubs(rng, colored):
    p = Pair(1, num_colors=4, colored=True, track_prio=True)
    f = _feats(rng, 32)
    hubs = np.arange(32)
    p.insert(hubs, f, colors=[1] * 32, prios=np.arange(10.0, 42.0))
    ev = p.insert(np.arange(100, 132), f, colors=[2] * 32,
                  prios=np.ones(32), return_evicted=True)
    assert (ev == -1).all() and p.lookup(hubs)[0].all()
    ev = p.insert([999], f[:1], colors=[3], prios=[1000.0],
                  return_evicted=True)
    assert ev.tolist() == [0]                    # the lowest-priority hub
    hit, _ = p.lookup(hubs)
    assert not hit[0] and hit[1:].all()
    np.testing.assert_array_equal(p.t.base.color_counts.numpy(),
                                  [0, 31, 0, 1, 0])


def case_priority_strongest_arrival_wins(rng, colored):
    p = Pair(1, colored=True, track_prio=True)
    f = _feats(rng, 32)
    p.insert(np.arange(32), f, prios=np.full(32, 5.0))
    p.insert([200, 201], f[:2], prios=[1.0, 99.0])
    np.testing.assert_array_equal(p.lookup([200, 201])[0], [False, True])


def case_rr_without_prios_on_prio_state(rng, colored):
    p = Pair(2, colored=True, track_prio=True)
    p.insert(np.arange(8) * 2, _feats(rng, 8))
    q = Pair(2, colored=True)
    q.insert(np.arange(8) * 2, _feats(rng, 8))
    np.testing.assert_array_equal(p.tags(), q.tags())
    np.testing.assert_array_equal(p.t.base.rr.numpy(), q.t.base.rr.numpy())


# ---- edge cases of the one-writer rule and the stable sorts --------------

def case_duplicate_ids_in_batch(rng, colored):
    p = Pair(2, colored=colored)
    ids = np.array([3, 5, 3, 3, 7, 5, 9, 3])
    p.insert(ids, _feats(rng, ids.size))
    tags = p.tags()
    for i in (3, 5, 7, 9):
        assert (tags == i).sum() == 1
    p.insert(ids[::-1], _feats(rng, ids.size))   # refreshes with repeats
    p.lookup(np.concatenate([ids, [11]]))


def case_more_than_ways_arrivals_to_one_set(rng, colored):
    p = Pair(2, num_colors=3, colored=colored)

    def ins(ids):
        kw = {"colors": ids % 4} if colored else {}
        p.insert(ids, _feats(rng, ids.size), **kw)

    ids = np.arange(0, 200, 2)                   # 100 arrivals, set 0
    ins(ids)
    assert (p.tags()[0] >= 0).all()
    ins(np.arange(1, 101, 2))                    # set 1
    ins(ids[::-1])                               # wraps set 0 again
    p.lookup(np.arange(200))


def case_random_batches(rng, colored):
    """Batches with repeats, invalid slots, evictions, refreshes that new
    arrivals clobber and, on the prio state, priority ties (integer
    priorities). 32 ways: JAX sizes line_prio by WAYS, so its priority
    victims are only defined for cfg.ways == 32."""
    for track_prio in ((False, True) if colored else (False,)):
        p = Pair(3, num_colors=3, colored=colored, track_prio=track_prio)
        for _ in range(10):
            n = int(rng.choice([7, 120]))     # two shapes: few JAX compiles
            ids = rng.integers(0, 240, n)
            valid = rng.random(n) < 0.85
            f = _feats(rng, n)
            if colored:
                prios = (rng.integers(0, 4, n).astype(np.float32)
                         if track_prio else None)
                p.insert(ids, f, valid=valid, colors=rng.integers(0, 4, n),
                         prios=prios, return_evicted=bool(rng.random() < .5))
            else:
                p.insert(ids, f, valid=valid)
            p.lookup(rng.integers(0, 240, 60), valid=rng.random(60) < 0.9,
                     count_stats=bool(rng.random() < 0.7))
        p.stats()


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("colored", [False, True],
                         ids=["insert", "insert_with_colors"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_assoc_cache_matches_jax(case, colored):
    CASES[case](np.random.default_rng(0), colored)


@pytest.mark.parametrize("colored,track_prio",
                         [(False, False), (True, False), (True, True)],
                         ids=["insert", "insert_with_colors", "prio"])
def test_int8_lines_match_jax(colored, track_prio):
    """quantize=True: int8 lines and per-line scales bitwise equal to JAX's
    through batches with repeats, invalid slots, evictions and clobbered
    refreshes; lookups dequantise to the same f32 rows."""
    rng = np.random.default_rng(3)
    p = Pair(3, num_colors=3, colored=colored, track_prio=track_prio,
             quantize=True)
    assert p.tbase.data.dtype == torch.int8
    for _ in range(8):
        n = int(rng.choice([7, 120]))
        ids = rng.integers(0, 240, n)
        valid = rng.random(n) < 0.85
        f = _feats(rng, n) * rng.uniform(0.01, 40, (n, 1)).astype(np.float32)
        if colored:
            p.insert(ids, f, valid=valid, colors=rng.integers(0, 4, n),
                     prios=(rng.integers(0, 4, n).astype(np.float32)
                            if track_prio else None),
                     return_evicted=bool(rng.random() < .5))
        else:
            p.insert(ids, f, valid=valid)
        p.lookup(rng.integers(0, 240, 60), valid=rng.random(60) < 0.9,
                 count_stats=bool(rng.random() < 0.7))
    p.stats()
    ids = np.arange(240)
    hit, rows = p.lookup(ids)
    assert hit.sum() > 10 and (rows[~hit] == 0).all()


def test_bf16_lines_match_jax():
    rng = np.random.default_rng(1)
    p = Pair(2, dtype="bfloat16", colored=True)
    ids = rng.integers(0, 100, 50)
    p.insert(ids, _feats(rng, 50))
    p.lookup(np.arange(100))
    assert p.t.base.data.dtype == torch.bfloat16


def test_prios_without_track_prio_raises():
    cfg = tfc.CacheConfig(num_sets=2, ways=tfc.WAYS, dim=16, cache_dim=128,
                          num_colors=0)
    with pytest.raises(ValueError, match="track_prio"):
        tfc.insert_with_colors(cfg, tfc.init_colored_state(cfg, "cpu"),
                               torch.arange(4, dtype=torch.int32),
                               torch.zeros(4, 16), torch.ones(4, dtype=bool),
                               torch.zeros(4, dtype=torch.int32),
                               prios=torch.ones(4))


@pytest.mark.parametrize("tdt,jdt", [(torch.float32, jnp.float32),
                                     (torch.bfloat16, jnp.bfloat16)])
def test_line_bytes_and_size_match(tdt, jdt):
    for mb, dim in [(1, 8), (97, 256), (1024, 256), (3, 1000)]:
        t = tfc.make_config(mb, dim, dtype=tdt)
        j = jfc.make_config(mb, dim, dtype=jdt)
        assert (t.line_bytes, t.size_mb) == (j.line_bytes, j.size_mb)
    assert tfc.make_config(97, 256).capacity == 99_328


def _quant_rows():
    rng = np.random.default_rng(2)
    rows = (rng.standard_normal((64, 48)) *
            rng.uniform(0.01, 50, (64, 1))).astype(np.float32)
    rows[3] = 0.0                                  # scale 1
    rows[4, :] = np.arange(48) - 23.5              # many exact .5 quotients
    rows[4, 0] = 127.0
    rows[5, :] = -1e-30                            # tiny absmax
    return rows


def test_quantize_rows_bitwise_jax_and_native():
    rows = _quant_rows()
    tq, ts = tfc.quantize_rows(torch.from_numpy(rows))
    jq, js = jfc.quantize_rows(jnp.asarray(rows))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    nq, ns = native_lib.quantize_rows_native(rows)
    np.testing.assert_array_equal(tq.numpy(), nq)
    np.testing.assert_array_equal(ts.numpy(), ns)
    for tdt, jdt in [(torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)]:
        td = tfc.dequantize_rows(tq, ts, dtype=tdt)
        jd = jfc.dequantize_rows(jq, js, dtype=jdt)
        assert td.dtype == tdt
        np.testing.assert_array_equal(td.float().numpy(),
                                      np.asarray(jd.astype(jnp.float32)))
