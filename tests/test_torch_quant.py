"""Port parity for quantized RGC (§5.2.3) and ``exact_topk``.

The same numpy inputs go through ``repro.core.selection`` / ``sync`` /
``compressors`` (JAX, the selectors under ``jax.jit``) and their
counterparts in ``repro_torch`` on the CPU: the plain ``*_quant``
selectors and their kernel compositions in ``kernels.ops`` (the kernels'
plain twins here). Indices, counts, overflow flags and the quantized
values (the ``_quantize`` mean is pinned) are bitwise. The one tolerance
is the wire mean of a packed quantized message: the reference sums the
values in an order XLA picks, the port with ``torch.sum``; it is held
to ``WIRE_RTOL`` relative.

Mirrors the quantized parts of ``test_rgc.py``
(``test_quantized_update_sign_consistent``) and
``test_compressor_invariants.py``.
"""
import numpy as np
import pytest

N, K = 3000, 40        # one shape, so each jitted reference compiles once
WIRE_RTOL = 2e-6       # relative; the unpinned wire-mean sum (ROADMAP §3)
CASES = ["normal", "signed_zeros", "ties", "few_of_sign"]
SELECTORS = ["exact_topk_quant", "trimmed_topk_quant",
             "threshold_binary_search_quant"]


def _leaf(case, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(N).astype(np.float32)
    if case == "signed_zeros":
        # ±0.0 entries in both phases, and fewer than K of either sign
        x[rng.random(N) < 0.99] = 0.0
        x[rng.random(N) < 0.5] *= -1.0
    elif case == "ties":
        x = (np.round(x * 2) / 2).astype(np.float32)
    elif case == "few_of_sign":
        # phase 0 finds 10 positives, phase 1 plenty of negatives
        x = -np.abs(x)
        x[rng.choice(N, 10, replace=False)] *= -1.0
        x[rng.random(N) < 0.2] = -0.0
    return x


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_sel_equal(got, want, what):
    for f in ("indices", "values", "count", "overflow"):
        w, g = getattr(want, f), getattr(got, f)
        assert (w is None) == (g is None), (what, f)
        if w is not None:
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(w),
                                          err_msg=f"{what}: {f}")


_JITTED = {}


def _reference(name, x, phase):
    import jax
    import jax.numpy as jnp

    from repro.core import selection as jsel
    if name not in _JITTED:
        _JITTED[name] = jax.jit(getattr(jsel, name), static_argnums=1)
    return _JITTED[name](jnp.asarray(x), K, jnp.int32(phase))


@pytest.mark.parametrize("name", SELECTORS)
def test_quant_selectors_match_reference(name):
    """Each plain ``*_quant`` selector, and for the two search-based ones
    its ``kernels.ops`` composition, bitwise against the reference, in
    both phases on every case of ``CASES``."""
    torch = pytest.importorskip("torch")
    from repro_torch.core import selection as tsel
    from repro_torch.kernels import ops

    for phase in (0, 1):
        for case in CASES:
            what = f"{name} phase {phase} {case}"
            x = _leaf(case, seed=CASES.index(case) + 10 * phase)
            want = _reference(name, x, phase)
            ph = torch.tensor(phase, dtype=torch.int32)
            _assert_sel_equal(getattr(tsel, name)(torch.from_numpy(x), K, ph),
                              want, f"selection.{what}")
            if name != "exact_topk_quant":
                _assert_sel_equal(
                    getattr(ops, name)(torch.from_numpy(x), K, ph), want,
                    f"ops.{what}")
            cnt = int(want.count)
            vals = np.asarray(want.values)
            assert np.all(vals[:cnt] == vals[0]), what
            assert np.all(vals[cnt:] == 0), what


def test_signed_score_zeros_are_positive():
    """Every zero score is +0.0 in both phases, as the reference's
    ``jnp.maximum(y, 0.0)`` gives it. The CPU sort ties -0.0 with +0.0,
    so the parity cases above cannot see a -0.0 score; a sort that ranks
    by bit pattern would order them apart."""
    torch = pytest.importorskip("torch")
    from repro_torch.core.selection import _signed_score
    x = torch.tensor([-0.0, 0.0, -1.5, 2.0, float("nan")])
    for phase, want in ((0, [0.0, 0.0, 0.0, 2.0]), (1, [0.0, 0.0, 1.5, 0.0])):
        s = _signed_score(x, torch.tensor(phase, dtype=torch.int32))
        assert s[:4].tolist() == want
        assert not torch.signbit(s[:4]).any()
        assert torch.isnan(s[4])


def _gathered(seed, quantized, rows=4, cap=64, size=200):
    """A synthetic [rows, msg_len] gathered buffer whose rows share
    (collide on) indices, with counts below, at and of 0 capacity."""
    rng = np.random.default_rng(seed)
    counts = [cap, cap // 2, 0, 7][:rows]
    buf = []
    for c in counts:
        idx = np.full(cap, size, np.int32)
        idx[:c] = np.sort(rng.choice(60, c, replace=False)) if c <= 60 \
            else np.sort(rng.choice(size, c, replace=False))
        if quantized:
            pay = np.float32([rng.standard_normal()])
        else:
            pay = rng.standard_normal(cap).astype(np.float32)
        buf.append(np.concatenate([np.int32([c]).view(np.float32),
                                   idx.view(np.float32), pay]))
    return np.stack(buf), cap, size


def test_unpack_decompress_colliding_rows_match_reference():
    """Quantized and unquantized gathered buffers whose rows collide."""
    torch = pytest.importorskip("torch")
    import jax

    from repro.core import sync as jsync
    from repro_torch.core import sync as tsync
    for quantized in (True, False):
        g, cap, size = _gathered(5, quantized)
        want = jax.jit(jsync.unpack_decompress, static_argnums=(1, 2, 3))(
            g, size, cap, quantized)
        got = tsync.unpack_decompress(torch.from_numpy(g), size, cap,
                                      quantized)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want),
                                      err_msg=f"quantized={quantized}")


def test_pack_quantized_p1_matches_reference():
    """``[count | indices | mean]``: header and indices bitwise, the mean
    within ``WIRE_RTOL``; unpacked at p = 1 it puts that mean at each
    live index. For both search-based quantized selectors."""
    for name in ("trimmed_topk_quant", "threshold_binary_search_quant"):
        _check_pack_quantized_p1(name)


def _check_pack_quantized_p1(name):
    torch = pytest.importorskip("torch")
    import jax
    import jax.numpy as jnp

    from repro.core import sync as jsync
    from repro_torch.core import selection as tsel
    from repro_torch.core import sync as tsync
    x = _leaf("normal", seed=11)
    want_sel = _reference(name, x, 1)
    got_sel = getattr(tsel, name)(torch.from_numpy(x), K,
                                  torch.tensor(1, dtype=torch.int32))
    want = np.asarray(jax.jit(jsync.pack, static_argnums=1)(want_sel, True))
    got = tsync.pack(got_sel, True).numpy()
    cap = want_sel.indices.shape[0]
    assert got.shape == want.shape == (tsync.message_len(cap, True),)
    np.testing.assert_array_equal(_bits(got[:-1]), _bits(want[:-1]))
    np.testing.assert_allclose(got[-1], want[-1], rtol=WIRE_RTOL, atol=0)
    dense = tsync.unpack_decompress(torch.from_numpy(got)[None], N, cap,
                                    True).numpy()
    cnt = int(want_sel.count)
    live = np.asarray(want_sel.indices)[:cnt]
    assert np.all(dense[live] == got[-1]) and np.count_nonzero(dense) == cnt
    jdense = np.asarray(jsync.unpack_decompress(jnp.asarray(got)[None], N,
                                                cap, True))
    np.testing.assert_array_equal(_bits(dense), _bits(jdense))


def test_quantized_wrapper_flips_phase_and_refuses():
    torch = pytest.importorskip("torch")
    from repro.core import registry as jreg
    from repro_torch.core import registry

    for spec in ("quantized(trimmed_topk)", "quantized(threshold_bsearch)",
                 "quantized(exact_topk)", "quantized"):
        comp = registry.make(registry.COMPRESSOR, spec)
        want = jreg.make(jreg.COMPRESSOR, spec)
        assert comp.quantized and comp.name == want.name
        assert comp.capacity(8) == comp.inner.capacity(8) == want.capacity(8)
        st = comp.init_leaf(torch.zeros(N), momentum=False)
        st = st._replace(residual=torch.from_numpy(_leaf("normal", 3)))
        phases = []
        for _ in range(3):
            sel, st = comp.compress(st.residual, K, st)
            phases.append(int(st.phase))
            assert st.phase.dtype == torch.int32
        assert phases == [1, 0, 1]
    for bad in ("quantized(quantized(trimmed_topk))",
                "quantized(sampled_bsearch)", "quantized(dense)"):
        with pytest.raises(ValueError):
            jreg.make(jreg.COMPRESSOR, bad)
        with pytest.raises(ValueError):
            registry.make(registry.COMPRESSOR, bad)
    assert registry.make(registry.COMPRESSOR, "quantized").inner.name == \
        "exact_topk"


def test_exact_topk_matches_reference():
    torch = pytest.importorskip("torch")
    import jax

    from repro.core import registry as jreg
    from repro_torch.core import registry
    for case in ("normal", "ties", "signed_zeros"):
        x = _leaf(case, seed=21)
        want, _ = jax.jit(lambda v: jreg.make(
            jreg.COMPRESSOR, "exact_topk").compress(v, K, None))(x)
        got, _ = registry.make(registry.COMPRESSOR, "exact_topk").compress(
            torch.from_numpy(x), K, None)
        _assert_sel_equal(got, want, f"exact_topk {case}")


def test_roundtrip_conservation_and_padding():
    """``test_compressor_invariants``' mass conservation (bitwise for
    ``exact_topk``, the total within tolerance when quantized) and
    count/padding invariants, for each compressor at two sizes."""
    for name in ("exact_topk", "quantized(exact_topk)",
                 "quantized(trimmed_topk)", "quantized(threshold_bsearch)"):
        for n, k in ((64, 3), (1000, 7)):
            _check_roundtrip(name, n, k)


def _check_roundtrip(name, n, k):
    torch = pytest.importorskip("torch")
    from repro_torch.core import registry
    from repro_torch.core.residual import mask_communicated
    comp = registry.make(registry.COMPRESSOR, name)
    tr = registry.make(registry.TRANSPORT, "fused_allgather", sync_axes=())
    x = torch.from_numpy(np.random.default_rng(n + k).standard_normal(n)
                         .astype(np.float32))
    st = comp.init_leaf(x, momentum=False)._replace(residual=x)
    sel, st = comp.compress(x, k, st)
    st = mask_communicated(st, sel.indices, momentum=False)
    (gathered,) = tr.allgather([tr.pack(sel, comp.quantized)])
    dense = comp.decompress(gathered, n, k)
    if comp.quantized:
        np.testing.assert_allclose(float(dense.sum()), float(sel.values.sum()),
                                   rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal((st.residual + dense).numpy(),
                                      x.numpy())
    cnt, cap = int(sel.count), comp.capacity(k)
    idx = sel.indices.numpy()
    assert 1 <= cnt <= cap and idx.shape == (cap,)
    assert np.all((idx[:cnt] >= 0) & (idx[:cnt] < n))
    assert np.all(idx[cnt:] == n)


def test_quantized_update_sign_consistent():
    """``test_rgc.py``'s sign test through the port's ``rgc_apply``:
    phase 0 sends one positive mean, the next step one negative."""
    torch = pytest.importorskip("torch")
    from repro_torch.core.rgc import RGCConfig, rgc_apply, rgc_init
    params = {"w": torch.zeros((60, 60))}
    grads = {"w": torch.from_numpy(np.random.default_rng(2)
                                   .standard_normal((60, 60))
                                   .astype(np.float32))}
    cfg = RGCConfig(density=0.01, momentum=0.0, quantize=True,
                    sync_axes=(), dense_threshold_bytes=1024,
                    no_quant_paths=())
    lr = torch.tensor(1.0)
    st = rgc_init(params, cfg, device="cpu")
    new_p, st = rgc_apply(grads, params, st, lr=lr, cfg=cfg, device="cpu")
    upd = -new_p["w"].numpy().ravel()
    nz = upd[upd != 0]
    assert nz.size and np.all(nz > 0) and np.allclose(nz, nz[0])
    new_p2, st = rgc_apply(grads, new_p, st, lr=lr, cfg=cfg, device="cpu")
    upd2 = (new_p["w"] - new_p2["w"]).numpy().ravel()
    nz2 = upd2[np.abs(upd2) > 1e-12]
    assert nz2.size and np.all(nz2 < 0)
