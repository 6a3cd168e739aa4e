"""Port parity: the giant-graph tier's sampling (``repro_torch.sampling``)
against the JAX package's on the CPU.

Host code, so bitwise: ``neighbor_sample`` blocks, ``ItemSampler`` epochs,
the bucket ladders, ``SampledNodeLoader.sample_batch`` (and its purity in
``(epoch, batch)``), the hot-node cache's hit and fetch counts on one id
stream (each package on its own ``MetricsRegistry``), and the
``Prefetcher``'s order and error hand-off.
"""
import threading

import numpy as np
import pytest

from repro import sampling as js
from repro.data import graphs as jgraphs
from repro.observability import MetricsRegistry as JRegistry
from repro_torch import sampling as ts
from repro_torch.data import graphs as tgraphs
from repro_torch.observability import MetricsRegistry as TRegistry
from test_torch_csc import assert_same, assert_same_block

N_NODES, BATCH, FANOUTS = 2_000, 64, (3, 2)


@pytest.fixture(scope="module")
def graphs():
    return tgraphs.reddit_like(N_NODES), jgraphs.reddit_like(N_NODES)


@pytest.mark.parametrize("fanouts,seed", [(FANOUTS, 0), (FANOUTS, (0, 3, 1)),
                                          ((4,), 5), ((2, 2, 2), (1, 0, 0))])
@pytest.mark.parametrize("normalize", ["mean", "none"])
def test_neighbor_sample_is_the_reference_bitwise(graphs, fanouts, seed,
                                                  normalize):
    t, j = graphs
    seeds = t.train_ids[:BATCH]
    tb = ts.neighbor_sample(t.csc, seeds, fanouts, seed=seed,
                            normalize=normalize)
    jb = js.neighbor_sample(j.csc, seeds, fanouts, seed=seed,
                            normalize=normalize)
    assert len(tb) == len(jb) == len(fanouts)
    for a, b in zip(tb, jb):
        assert_same_block(a, b)
    for a, b in zip(tb[:-1], tb[1:]):          # the chaining invariant
        np.testing.assert_array_equal(a.dst_ids(), b.src_ids)
    np.testing.assert_array_equal(tb[-1].dst_ids(), seeds)


def test_neighbor_sample_pins_shapes_as_the_reference(graphs):
    t, j = graphs
    seeds = t.train_ids[:BATCH]
    shapes = [(1024, 640), None]
    tb = ts.neighbor_sample(t.csc, seeds, FANOUTS, seed=2, shapes=shapes)
    jb = js.neighbor_sample(j.csc, seeds, FANOUTS, seed=2, shapes=shapes)
    for a, b in zip(tb, jb):
        assert_same_block(a, b)
    assert (tb[0].m_pad, tb[0].nnz_pad) == (1024, 640)


@pytest.mark.parametrize("kw,what", [
    (dict(seeds=np.asarray([], np.int64)), "at least one seed"),
    (dict(seeds=np.asarray([3, 3])), "must be unique"),
    (dict(shapes=[None]), "shapes has 1 entries"),
])
def test_neighbor_sample_errors_are_the_reference(graphs, kw, what):
    t, _ = graphs
    args = dict(seeds=t.train_ids[:4], shapes=None) | kw
    for mod in (ts, js):
        with pytest.raises(ValueError, match=what):
            mod.neighbor_sample(t.csc, args["seeds"], FANOUTS,
                                shapes=args["shapes"])
        with pytest.raises(ValueError, match="fanout must be"):
            mod.sample_layer(t.csc, t.train_ids[:4], 0,
                             np.random.default_rng(0))


@pytest.mark.parametrize("kw", [dict(), dict(shuffle=False),
                                dict(drop_remainder=False, seed=4)])
def test_item_sampler_epochs_are_the_reference(kw):
    ids = np.random.default_rng(0).permutation(1000)[:203]
    t, j = ts.ItemSampler(ids, 32, **kw), js.ItemSampler(ids, 32, **kw)
    assert t.batches_per_epoch() == j.batches_per_epoch()
    for e in (0, 1, 7):
        te, je = list(t.epoch(e)), list(j.epoch(e))
        assert [b for b, _ in te] == [b for b, _ in je]
        for (_, a), (_, b) in zip(te, je):
            assert_same(a, b)
    for mod in (ts, js):
        with pytest.raises(ValueError, match="batch_size must be"):
            mod.ItemSampler(ids, 0)
        with pytest.raises(ValueError, match="must be unique"):
            mod.ItemSampler(np.asarray([1, 1]), 1)


@pytest.mark.parametrize("batch,fanouts,n_nodes,levels", [
    (512, (10, 5), None, 3), (512, (10, 5), 100_000, 3),
    (64, (3, 2), 2_000, 3), (32, (4, 4, 4), 500, 2), (8, (1,), None, 1)])
def test_block_caps_and_ladders_are_the_reference(batch, fanouts, n_nodes,
                                                  levels):
    assert ts.block_caps(batch, fanouts, n_nodes=n_nodes) == \
        js.block_caps(batch, fanouts, n_nodes=n_nodes)
    tl = ts.block_ladders(batch, fanouts, n_nodes=n_nodes, levels=levels)
    assert tl == js.block_ladders(batch, fanouts, n_nodes=n_nodes,
                                  levels=levels)
    for ladder in tl:
        for n_src, nnz in ((1, 0), ladder[0], (ladder[-1][0], 1)):
            assert ts.bucket_for(ladder, n_src, nnz) == \
                js.bucket_for(ladder, n_src, nnz)
        top_m, top_nnz = ladder[-1]
        for mod in (ts, js):
            with pytest.raises(ValueError, match="exceeds the top ladder"):
                mod.bucket_for(ladder, top_m + 1, top_nnz)


def test_tier_ladders_at_the_example_settings():
    """batch 512, fanouts (10, 5) at 100k nodes: the top rungs are the
    33,792-row and 3,072-row blocks the tier's kernels run."""
    ladders = ts.block_ladders(512, (10, 5), n_nodes=100_000)
    assert [lad[-1] for lad in ladders] == [(33_792, 30_720), (3_072, 2_560)]


def _cache_pair(policy: str, capacity: int):
    """(port, reference) caches over one feature table, each package's
    store and cache on a fresh registry of its own."""
    feats = np.random.default_rng(1).normal(size=(64, 4)).astype(np.float32)
    deg = np.arange(64)
    out = []
    for mod, reg in ((ts, TRegistry()), (js, JRegistry())):
        store = mod.FeatureStore(feats, registry=reg)
        hot = mod.static_hot_ids(deg, capacity) if policy == "static" \
            else None
        out.append((store, mod.HotNodeCache(store, capacity, policy=policy,
                                            hot_ids=hot, registry=reg)))
    return feats, out


@pytest.mark.parametrize("policy,capacity", [("static", 8), ("lru", 2),
                                             ("lru", 3)])
def test_cache_counts_are_the_reference(policy, capacity):
    """One id stream through both packages: the same rows, hits, misses,
    hit rate and store traffic after every gather. The lru stream has a
    batch whose admissions evict a row that was a hit when the batch began,
    and repeated miss ids in one batch."""
    feats, ((tst, tc), (jst, jc)) = _cache_pair(policy, capacity)
    stream = [[0], [1], [0], [2], [1, 0], [63, 62, 0, 1, 63], [5, 6, 7, 5],
              [7, 8, 8, 6, 9], [60, 61, 62, 63, 0]]
    for ids in stream:
        ids = np.asarray(ids)
        got = tc.gather(ids)
        assert_same(got, jc.gather(ids))
        np.testing.assert_array_equal(got, feats[ids])
        assert tc.hit_rate() == jc.hit_rate()
        assert len(tc) == len(jc)
        assert (tc._hits.value(policy=policy), tc._misses.value(
            policy=policy)) == (jc._hits.value(policy=policy),
                                jc._misses.value(policy=policy))
        assert (tst._fetch_rows.total(), tst._fetch_bytes.total()) == \
            (jst._fetch_rows.total(), jst._fetch_bytes.total())
    if policy == "lru":
        assert list(tc._rows) == list(jc._rows)


def test_cache_and_store_errors_are_the_reference():
    feats = np.zeros((4, 2), np.float32)
    for mod, reg in ((ts, TRegistry()), (js, JRegistry())):
        store = mod.FeatureStore(feats, registry=reg)
        with pytest.raises(ValueError, match="2-D"):
            mod.FeatureStore(np.zeros(3, np.float32), registry=reg)
        with pytest.raises(ValueError, match="unknown cache policy"):
            mod.HotNodeCache(store, 2, policy="fifo", registry=reg)
        with pytest.raises(ValueError, match="capacity must be"):
            mod.HotNodeCache(store, 0, policy="lru", registry=reg)
        with pytest.raises(ValueError, match="static policy needs"):
            mod.HotNodeCache(store, 2, registry=reg)
    assert_same(ts.static_hot_ids(np.array([5, 1, 9, 9, 0]), 3),
                js.static_hot_ids(np.array([5, 1, 9, 9, 0]), 3))


@pytest.mark.parametrize("fail_at", [None, 0, 3])
def test_prefetcher_keeps_order_and_hands_errors_to_their_item(fail_at):
    def gen():
        for i in range(5):
            if i == fail_at:
                raise RuntimeError(f"boom at {i}")
            yield i

    threads = []

    def spy():
        threads.append(threading.current_thread())
        yield from gen()

    it = iter(ts.Prefetcher(spy(), registry=TRegistry()))
    stop = 5 if fail_at is None else fail_at
    assert [next(it) for _ in range(stop)] == list(range(stop))
    if fail_at is None:
        with pytest.raises(StopIteration):
            next(it)
    else:
        with pytest.raises(RuntimeError, match=f"boom at {fail_at}"):
            next(it)
    assert threads and threads[0] is not threading.current_thread()


def _loaders(graphs, *, cache: bool, ids=slice(None)):
    t, j = graphs
    out = []
    for mod, reg, d in ((ts, TRegistry(), t), (js, JRegistry(), j)):
        kw = {}
        if cache:
            store = mod.FeatureStore(d.features, registry=reg)
            kw["cache"] = mod.HotNodeCache(
                store, 128, hot_ids=mod.static_hot_ids(d.csc.in_degrees(),
                                                       128), registry=reg)
        else:
            kw["registry"] = reg
        out.append(mod.SampledNodeLoader(
            d.csc, d.features, d.labels, d.train_ids[ids], fanouts=FANOUTS,
            batch_size=BATCH, **kw))
    return out


def assert_same_batch(t, j) -> None:
    for a, b in zip(t.blocks, j.blocks):
        assert_same_block(a, b)
    for f in ("x", "labels", "seeds"):
        assert_same(getattr(t, f), getattr(j, f))
    assert (t.epoch, t.batch_index, t.shape_key()) == \
        (j.epoch, j.batch_index, j.shape_key())


@pytest.mark.parametrize("cache", [True, False])
def test_loader_epoch_is_the_reference_bitwise(graphs, cache):
    tl, jl = _loaders(graphs, cache=cache, ids=slice(0, 6 * BATCH))
    assert tl.ladders == jl.ladders
    assert tl.batches_per_epoch() == jl.batches_per_epoch() == 6
    bound = np.prod([len(lad) for lad in tl.ladders])
    keys = set()
    for e in (0, 1):
        for t, j in zip(tl.epoch(e), jl.epoch(e), strict=True):
            assert_same_batch(t, j)
            keys.add(t.shape_key())
            b0 = t.blocks[0]
            np.testing.assert_array_equal(t.x[:b0.n_src],
                                          graphs[0].features[b0.src_ids])
            assert not t.x[b0.n_src:].any()
    assert 1 <= len(keys) <= bound


def test_sample_batch_is_pure_in_epoch_and_batch(graphs):
    tl, jl = _loaders(graphs, cache=True)
    seeds = graphs[0].train_ids[100:100 + BATCH]
    a = tl.sample_batch(10_000, 3, seeds)
    tl.sample_batch(10_000, 4, seeds)             # another batch between
    b = tl.sample_batch(10_000, 3, seeds)
    assert_same_batch(a, b)
    assert_same_batch(a, jl.sample_batch(10_000, 3, seeds))
    c = tl.sample_batch(10_001, 3, seeds)
    assert any(not np.array_equal(x.src_ids, y.src_ids)
               for x, y in zip(a.blocks, c.blocks))


def test_loader_rejects_misaligned_features_as_the_reference(graphs):
    t, _ = graphs
    for mod in (ts, js):
        with pytest.raises(ValueError, match="must cover all"):
            mod.SampledNodeLoader(t.csc, t.features[:-1], t.labels,
                                  t.train_ids, fanouts=FANOUTS,
                                  batch_size=BATCH)
