"""Port parity: segmented kernels' plain twins and ``multi_select``.

The same seeded numpy arena goes through ``repro.kernels`` (JAX, CPU:
the ``ref`` twins and the Pallas kernels in interpret mode) and
``repro_torch.kernels``. The twins must match ``repro.kernels.ref``
bitwise; against the Pallas bodies counts and compaction are exact and
sums within rtol 1e-6 (the Pallas stats body accumulates row sums in
sequence, not the pinned tree). The CUDA kernels themselves run only on
the card: ``test_cuda_kernels_match_twins`` (marker ``cuda``)."""
import numpy as np
import pytest

SIZES = (1500, 1024, 3000)      # ragged 3-slot arena: odd, exact, 3 rows
SEG_KS = (7, 3, 40)


def _groups(sizes=SIZES, ks=SEG_KS, alg="threshold_bsearch"):
    from repro.core import arena as jarena
    from repro_torch.core import arena as tarena
    slots = [(i, f"s{i}", n, k, 2 * k, 1 + 4 * k)
             for i, (n, k) in enumerate(zip(sizes, ks))]
    return (jarena.build_group(0, alg, "float32", slots),
            tarena.build_group(0, alg, "float32", slots))


def _arena(group, seed, tied=False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = np.zeros(group.total, np.float32)
    for s in group.slots:
        v = (rng.integers(-4, 5, s.size) * 0.5 if tied
             else rng.standard_normal(s.size))
        x[s.offset:s.offset + s.size] = v
    return x.reshape(group.nblocks, 1024)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def test_arena_layout_equal():
    pytest.importorskip("torch")
    jg, tg = _groups()
    assert jg.slots == tg.slots or [vars(s) for s in jg.slots] == \
        [vars(s) for s in tg.slots]
    jgeo, tgeo = jg.geometry, tg.geometry
    for f in ("block_seg", "block_base", "block_size"):
        np.testing.assert_array_equal(getattr(jgeo, f), getattr(tgeo, f))
    assert (jgeo.seg_sizes, jgeo.seg_ks, jgeo.seg_rows) == \
        (tgeo.seg_sizes, tgeo.seg_ks, tgeo.seg_rows)


@pytest.mark.parametrize("tied", [False, True])
def test_twins_match_reference_bitwise(tied):
    torch = pytest.importorskip("torch")
    import jax
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    from repro_torch.kernels import segmented as kseg
    jg, tg = _groups()
    g = tg.geometry
    x = _arena(jg, 1, tied)
    xt = torch.from_numpy(x)
    thr = np.asarray([0.9, 1.0, 0.0], np.float32)

    ws, wm = jax.jit(lambda a: jref.seg_abs_sum_max(
        a, g.block_seg, g.block_size, g.n_seg))(jnp.asarray(x))
    gs, gm = kseg.seg_abs_sum_max(xt, g)
    np.testing.assert_array_equal(_bits(gs.numpy()), _bits(ws))
    np.testing.assert_array_equal(_bits(gm.numpy()), _bits(wm))

    wc = jref.seg_count_gt(jnp.asarray(x), g.block_seg, jnp.asarray(thr),
                           g.n_seg)
    gc = kseg.seg_count_gt(xt, g, torch.from_numpy(thr))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))

    for cap in (8, 64):
        w = jax.jit(lambda a, t, cap=cap: jref.seg_compact_gt(
            a, g.block_seg, g.block_base, g.block_size, t, cap))(
                jnp.asarray(x), jnp.asarray(thr))
        got = kseg.seg_compact_gt(xt, g, torch.from_numpy(thr), cap)
        np.testing.assert_array_equal(_bits(got[0].numpy()), _bits(w[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(w[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(w[2]))


def test_twins_match_pallas_interpret():
    torch = pytest.importorskip("torch")
    import jax.numpy as jnp

    from repro.kernels import segmented as jseg
    from repro_torch.kernels import segmented as kseg
    jg, tg = _groups()
    g = tg.geometry
    x = _arena(jg, 2)
    xt = torch.from_numpy(x)
    thr = np.asarray([1.2, 0.4, 2.0], np.float32)

    ws, wm = jseg.seg_abs_sum_max(jnp.asarray(x), g.block_seg, g.n_seg,
                                  interpret=True)
    gs, gm = kseg.seg_abs_sum_max(xt, g)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))

    wc = jseg.seg_count_gt(jnp.asarray(x), g.block_seg, jnp.asarray(thr),
                           interpret=True)
    np.testing.assert_array_equal(
        kseg.seg_count_gt(xt, g, torch.from_numpy(thr)).numpy(),
        np.asarray(wc))

    w = jseg.seg_compact_gt(jnp.asarray(x), g.block_seg, g.block_base,
                            g.block_size, jnp.asarray(thr), 16,
                            interpret=True)
    got = kseg.seg_compact_gt(xt, g, torch.from_numpy(thr), 16)
    for a, b in zip(got, w):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _spec_pair(kind: str, n_seg: int, seed: int):
    """Matching (reference, port) SegmentSpecs for one arena."""
    torch = pytest.importorskip("torch")
    import jax.numpy as jnp

    from repro.kernels import segmented as jseg
    from repro_torch.kernels import segmented as kseg
    if kind == "trimmed":
        return (jseg.SegmentSpec(alg="trimmed", eps=0.2),
                kseg.SegmentSpec(alg="trimmed", eps=0.2))
    rng = np.random.default_rng(seed)
    refresh = np.ones(n_seg, bool)
    cached = None
    warm = kind in ("warm", "reuse")
    if warm:
        cached = np.abs(rng.standard_normal(n_seg)).astype(np.float32) + 0.5
    if kind == "reuse":
        refresh[::2] = False
    j = jseg.SegmentSpec(
        alg="bsearch", eps=1e-3, refresh=jnp.asarray(refresh),
        cached=None if cached is None else jnp.asarray(cached), warm=warm)
    t = kseg.SegmentSpec(
        alg="bsearch", eps=1e-3, refresh=torch.from_numpy(refresh),
        cached=None if cached is None else torch.from_numpy(cached),
        warm=warm)
    return j, t


def _check_multi(parts_np, kinds):
    """The reference runs under ``jax.jit`` (its selection arithmetic is
    pinned, so jit and eager agree bitwise)."""
    torch = pytest.importorskip("torch")
    import jax
    import jax.numpy as jnp

    from repro.kernels import segmented as jseg
    from repro_torch.kernels import segmented as kseg
    jparts, tparts = [], []
    for (x, jg, tg), kind, seed in zip(parts_np, kinds, range(10)):
        js, ts = _spec_pair(kind, tg.geometry.n_seg, seed)
        jparts.append((jnp.asarray(x), jg.geometry, js, None))
        tparts.append((torch.from_numpy(x), tg.geometry, ts, None))
    want = jax.jit(lambda: jseg.multi_select(jparts, use_pallas=False))()
    got = kseg.multi_select(tparts)
    assert len(want) == len(got)
    for (wsel, wthr), (gsel, gthr) in zip(want, got):
        np.testing.assert_array_equal(_bits(gthr.numpy()), _bits(wthr))
        for w, g in zip(wsel, gsel):
            np.testing.assert_array_equal(g.indices.numpy(),
                                          np.asarray(w.indices))
            np.testing.assert_array_equal(_bits(g.values.numpy()),
                                          _bits(w.values))
            assert int(g.count) == int(w.count)
            if w.overflow is not None:
                assert bool(g.overflow) == bool(w.overflow)


@pytest.mark.parametrize("kind,tied", [("trimmed", False), ("cold", True),
                                       ("warm", False), ("reuse", True)])
def test_multi_select_matches_reference(kind, tied):
    alg = "trimmed_topk" if kind == "trimmed" else "threshold_bsearch"
    jg, tg = _groups(alg=alg)
    _check_multi([(_arena(jg, 3, tied), jg, tg)], [kind])


def test_multi_select_two_arenas_one_call():
    """A trimmed and a warm bsearch arena searched together (the fused
    select GradientSync issues), including a trimmed slot whose k exceeds
    its survivors (the jnp fallback to the exact top-k)."""
    jt, tt = _groups((2048, 1100), (600, 5), alg="trimmed_topk")
    jb, tb = _groups()
    _check_multi([(_arena(jt, 4, tied=True), jt, tt),
                  (_arena(jb, 5), jb, tb)], ["trimmed", "warm"])


def test_gather_topk_from_buckets_ties():
    torch = pytest.importorskip("torch")
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    from repro_torch.kernels import ops as tops
    rng = np.random.default_rng(6)
    vals = (rng.integers(-2, 3, (10, 8)) * 0.5).astype(np.float32)
    idx = rng.integers(0, 120, (10, 8)).astype(np.int32)
    for k in (5, 40, 79):
        for mag in (True, False):
            w = jops._gather_topk_from_buckets(jnp.asarray(vals),
                                               jnp.asarray(idx), k, 100, mag)
            g = tops._gather_topk_from_buckets(torch.from_numpy(vals),
                                               torch.from_numpy(idx), k, 100,
                                               mag)
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(w[0]))
            np.testing.assert_array_equal(_bits(g[1].numpy()), _bits(w[1]))
    for cap, nb in ((30000, 14649), (18000, 8790), (10, 3), (5000, 2)):
        assert tops._cap_for(cap, nb, 1024) == jops._cap_for(cap, nb, 1024)


def _port_group(sizes=SIZES, ks=SEG_KS):
    from repro_torch.core import arena
    return arena.build_group(0, "threshold_bsearch", "float32", [
        (i, f"s{i}", n, k, 2 * k, 1 + 4 * k)
        for i, (n, k) in enumerate(zip(sizes, ks))])


def _need_cuda():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch


# The card tests import nothing of JAX (the card's host has none); run them
# there with: python -m pytest --noconftest -m cuda tests/test_torch_*.py

@pytest.mark.cuda
def test_cuda_kernels_match_twins():
    """On the card: each CUDA kernel against its plain twin on the same
    CUDA tensors (bitwise sums, exact counts and compaction), with ties,
    threshold 0 and bucket overflow."""
    torch = _need_cuda()
    from repro_torch.kernels import ref
    from repro_torch.kernels import segmented as kseg
    group = _port_group()
    g = group.geometry
    for tied in (False, True):
        x = torch.from_numpy(_arena(group, 7, tied)).cuda()
        thr = torch.tensor([0.9, 1.0, 0.0], device="cuda")
        ks, km = kseg.seg_abs_sum_max(x, g)
        ps, pm = ref.seg_abs_sum_max(x, g.block_seg, g.block_size, g.n_seg)
        assert torch.equal(ks.view(torch.int32), ps.view(torch.int32))
        assert torch.equal(km, pm)
        assert torch.equal(kseg.seg_count_gt(x, g, thr),
                           ref.seg_count_gt(x, g.block_seg, thr, g.n_seg))
        got = kseg.seg_compact_gt(x, g, thr, 8)
        want = ref.seg_compact_gt(x, g.block_seg, g.block_base,
                                  g.block_size, thr, 8)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_gradient_sync_matches_cpu_bitwise():
    """On the card: two port updates (refresh, then reuse) on CUDA — the
    kernel path — equal the same updates on the CPU — the plain path the
    other tests tie to the JAX reference — bitwise, with dense, trimmed
    and bsearch leaves in one step."""
    torch = _need_cuda()
    from repro_torch.core import tree
    from repro_torch.core.gradient_sync import build_gradient_sync
    from repro_torch.kernels import segmented as kseg
    rng = np.random.default_rng(8)

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))
    params = {"a": t(64, 48), "b": t(40, 30), "c": t(50),
              "d": {"e": t(100, 40), "f": t(17)}}
    grads = [tree.tree_map(lambda p: t(*p.shape, scale=1e-2), params)
             for _ in range(2)]

    def run(device):
        sync = build_gradient_sync("rgc", density=0.01, device=device,
                                   dense_threshold_bytes=1024,
                                   trimmed_threshold_bytes=8192)
        mv = lambda tr: tree.tree_map(lambda x: x.to(device), tr)  # noqa: E731
        p = mv(params)
        st = sync.init(p)
        lr = torch.tensor(0.1, device=device)
        for g in grads:
            p, st = sync.update(mv(g), st, p, lr)
        return [x.cpu() for x in tree.flatten(p)[0]] + [
            f.cpu() for s in tree.flatten(st)[0] for f in s]

    before = kseg.launches["seg_count_gt"]
    on_card = run("cuda")
    assert kseg.launches["seg_count_gt"] > before
    for a, b in zip(on_card, run("cpu")):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)
