"""Port parity of the MoE FFN (``repro_torch.models.moe``) and of the moe
family on the transformer chassis (``granite-moe-3b-a800m``,
``grok-1-314b``) against the JAX reference, on the CPU.

Two items, each looping over its cases rather than parametrising: under
``pytest -n 6 --dist load`` the suite's wall time is set by where the
scheduler cuts ``tests/test_property.py``'s long tests into chunks, and
the number of items collected after that file moves the cuts (replayed
with measured durations, xdist's scheduler finishes sooner with two
items here than with three). Each reference call runs under ``jax.jit``.

Tolerances, and why:
* routing (``gate_idx``, ``slot``, ``keep``): exact, ties and capacity
  drops included. The port takes top-k by a stable descending sort (the
  reference's ``lax.top_k`` order) and slots by an integer cumsum.
* ``moe_ffn`` (f32): output rtol 1e-5 and atol 1e-6 of its largest
  magnitude, aux rtol 1e-6, gradients of x and of every leaf within 1e-5
  of the reference gradient's largest magnitude: matmul and reduction
  orders differ between XLA and PyTorch (measured: at most 1.5e-7 of the
  output's scale, 3.4e-6 of a gradient's). The port's one-hot form
  against its scatter form: atol 3e-5, the bound of the reference's own
  ``test_moe_impls_agree``.
* model loss: rtol 1e-5; gradients within 1e-3 of each leaf's scale,
  for the reason ``tests/test_torch_models.py`` gives (the reference's
  ``fan_in = shape[0]`` init saturates the smoke models' attention).
* trainer losses (granite smoke, 3 RGC steps at lr 0.01): rtol 1e-4
  (measured 1.8e-5; the item's docstring says why not lr 0.2).
"""
import dataclasses

import numpy as np
import pytest


@pytest.fixture(scope="module", autouse=True)
def _free_jax_executables():
    """Free the XLA executables, and the memory maps they hold, that
    earlier test modules on this worker left: on entry and on exit."""
    import gc
    try:
        from jax import clear_caches
    except ImportError:              # a card-only run, without JAX
        def clear_caches():
            pass
    clear_caches()
    gc.collect()
    yield
    clear_caches()
    gc.collect()


MOE = ("granite-moe-3b-a800m", "grok-1-314b")
IMPLS = ("onehot", "scatter")
BATCH, SEQ = 2, 32
GRANITE_LAYERS = 20          # the depth chip_smoke.py trains at full width
# its bsearch arena: every matrix but the router (1,228,800 elements,
# which the size policy sends to trimmed_topk); the norms go dense
GRANITE_ARENA = 2_088_768_512


def _fields(cfg) -> dict:
    def name(dt):
        return (str(dt).replace("torch.", "") if "torch" in str(dt)
                else np.dtype(dt).name)
    return {f.name: (name(getattr(cfg, f.name)) if f.name == "dtype"
                     else getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


def _moe_cases(jcfg, rng):
    """(label, cfg overrides, x [B,S,D], router override or None)."""
    d, e = jcfg.d_model, jcfg.num_experts
    x = rng.standard_normal((BATCH, 24, d)).astype(np.float32)
    router = (0.1 / np.sqrt(d) * rng.standard_normal((d, e))).astype(
        np.float32)
    router[:, 1] = router[:, 0]        # experts 0 and 1 tie on every token
    return [
        ("seeded normal", (), x, None),
        ("tied router columns", (), x, router),
        ("capacity 0.1, all ones", (("moe_capacity_factor", 0.1),),
         np.ones((1, 16, d), np.float32), None),
    ]


def _jax_moe(jcfg):
    """One jitted reference call for both forms: per form, routing
    (gate_idx, slot, keep) and the value and gradients (params, x) of
    ``sum(out * ct) + aux``."""
    import jax
    import jax.numpy as jnp

    from repro.models import moe as jmoe

    def run(p, x, ct):
        xt = x.reshape(-1, x.shape[-1])
        res = {}
        for impl in IMPLS:
            cfg = dataclasses.replace(jcfg, moe_impl=impl)

            def loss(p, x, cfg=cfg):
                out, aux = jmoe.moe_ffn(cfg, p, x)
                return jnp.sum(out * ct) + aux, (out, aux)
            r = jmoe._route(cfg, p, xt, jmoe._capacity(xt.shape[0], cfg))
            (_, (out, aux)), grads = jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True)(p, x)
            res[impl] = ((r[1], r[2], r[3]), out, aux, grads)
        return res
    return jax.jit(run)


def test_moe_ffn_configs_and_models_match_reference():
    """The MoE FFN, then the configs, models and granite's arena, against
    the reference."""
    _check_moe_ffn()
    _check_configs_models_and_arena()


def _check_moe_ffn():
    """Both forms, granite and grok smoke: routing exact; output within
    rtol 1e-5 and 1e-6 of its largest magnitude (the reference's init,
    ``fan_in = E`` for the experts, puts the outputs in the hundreds,
    where an f32 ulp is ~3e-5: an absolute 1e-6 would hold the elements
    that cancel to near zero below the rounding of their terms); aux
    rtol 1e-6; gradients within 1e-5 of each one's scale."""
    torch = pytest.importorskip("torch")
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.models import moe as jmoe
    from repro.models.common import init_params as jinit
    from repro_torch import convert
    from repro_torch.configs import get_config as tget
    from repro_torch.models import moe as tmoe

    rng = np.random.default_rng(0)
    for arch in MOE:
        base_j, base_t = jget(arch, smoke=True), tget(arch, smoke=True)
        params0 = jax.tree.map(np.asarray, jinit(
            jmoe.moe_defs(base_j), 0, jnp.float32))
        cases = _moe_cases(base_j, rng)
        cts = [rng.standard_normal(c[2].shape).astype(np.float32)
               for c in cases]
        outs, jitted = {}, {}
        for (label, over, x, router), ct in zip(cases, cts):
            params = dict(params0)
            if router is not None:
                params["router"] = router
            if over not in jitted:
                jitted[over] = _jax_moe(
                    dataclasses.replace(base_j, **dict(over)))
            ref = jitted[over](params, x, ct)
            for impl in IMPLS:
                what = f"{arch} {impl} {label}"
                tcfg = dataclasses.replace(base_t, moe_impl=impl,
                                           **dict(over))
                want_r, wo, wa, (wgp, wgx) = ref[impl]
                want_r = [np.asarray(a) for a in want_r]

                tp = convert.from_numpy(params)
                tx = torch.from_numpy(x).requires_grad_(True)
                for v in tp.values():
                    v.requires_grad_(True)
                xt = tx.detach().reshape(-1, x.shape[-1])
                got_r = tmoe._route(tcfg, tp, xt,
                                    tmoe._capacity(xt.shape[0], tcfg))
                for name, g, w in zip(("gate_idx", "slot", "keep"),
                                      got_r[1:4], want_r):
                    np.testing.assert_array_equal(
                        g.numpy(), w.astype(g.numpy().dtype),
                        err_msg=f"{what} {name}")
                gate_idx, _, keep = want_r
                if over:
                    assert not keep.all(), f"{what}: no choice dropped"
                if router is not None:
                    both = (gate_idx == 0).any(1) & (gate_idx == 1).any(1)
                    assert both.any(), f"{what}: no tie reached the top k"

                out, aux = tmoe.moe_ffn(tcfg, tp, tx)
                loss = torch.sum(out * torch.from_numpy(ct)) + aux
                names = list(tp)
                grads = torch.autograd.grad(loss, [tp[n] for n in names]
                                            + [tx])
                out, aux = out.detach().numpy(), float(aux.detach())
                wo = np.asarray(wo)
                np.testing.assert_allclose(
                    out, wo, rtol=1e-5, atol=1e-6 * float(np.abs(wo).max()),
                    err_msg=what)
                np.testing.assert_allclose(aux, float(wa), rtol=1e-6,
                                           err_msg=what)
                for n, g in zip(names + ["x"], grads):
                    w = np.asarray(wgx if n == "x" else wgp[n])
                    np.testing.assert_allclose(
                        g.numpy(), w, rtol=0,
                        atol=1e-5 * float(np.abs(w).max()),
                        err_msg=f"{what} grad {n}")
                outs[impl, label] = (out, aux)
        for label, *_ in cases:
            (o1, a1), (o2, a2) = outs["onehot", label], outs["scatter", label]
            np.testing.assert_allclose(o1, o2, atol=3e-5,
                                       err_msg=f"{arch} {label}")
            np.testing.assert_allclose(a1, a2, rtol=1e-6,
                                       err_msg=f"{arch} {label}")


def _check_configs_models_and_arena():
    """``get_config`` fields and the param trees' names and shapes equal
    the reference's for both archs; smoke loss and gradients; the port's
    own init; granite FULL at 20 layers plans one bsearch arena below
    2^31 - 1, and a larger one raises at planning time."""
    torch = pytest.importorskip("torch")
    import jax

    from repro.configs import get_config as jget
    from repro.models.registry import get_model as jmodel
    from repro_torch import convert
    from repro_torch.configs import ARCH_IDS
    from repro_torch.configs import get_config as tget
    from repro_torch.core import arena, tree
    from repro_torch.core.dispatch import SizeBasedPolicy
    from repro_torch.models import transformer
    from repro_torch.models.registry import get_model as tmodel

    assert set(MOE) <= set(ARCH_IDS)
    for arch in MOE:
        for smoke in (False, True):
            want, got = jget(arch, smoke=smoke), tget(arch, smoke=smoke)
            assert _fields(got) == _fields(want), (arch, smoke)
            assert got.pattern_codes() == want.pattern_codes(), arch
            jdefs = jax.tree_util.tree_flatten_with_path(
                jmodel(want).param_defs(),
                is_leaf=lambda x: hasattr(x, "axes"))[0]
            tdefs = tree.flatten_with_paths(tmodel(got).param_defs())
            assert [(jax.tree_util.keystr(p), d.shape, d.axes, d.init,
                     d.scale) for p, d in jdefs] == \
                [(p, d.shape, d.axes, d.init, d.scale) for p, d in tdefs], \
                (arch, smoke)

    rng = np.random.default_rng(0)
    for arch in MOE:
        jcfg, tcfg = jget(arch, smoke=True), tget(arch, smoke=True)
        jm, tm = jmodel(jcfg), tmodel(tcfg)
        params = jax.tree.map(np.asarray, jm.init_params(0))
        batch = {"tokens": rng.integers(0, jcfg.vocab_size, (BATCH, SEQ),
                                        dtype=np.int32)}
        wl, wg = jax.jit(jax.value_and_grad(jm.loss))(params, batch)
        leaves, treedef = tree.flatten(convert.from_numpy(params))
        for p in leaves:
            p.requires_grad_(True)
        loss = tm.loss(tree.unflatten(treedef, leaves),
                       convert.from_numpy(batch))
        grads = torch.autograd.grad(loss, leaves)
        np.testing.assert_allclose(float(loss.detach()), float(wl),
                                   rtol=1e-5, err_msg=arch)
        jg = jax.tree_util.tree_flatten_with_path(wg)[0]
        assert len(jg) == len(grads), arch
        for (path, w), g in zip(jg, grads):
            w = np.asarray(w)
            np.testing.assert_allclose(
                g.numpy(), w, rtol=0, atol=1e-3 * float(np.abs(w).max()),
                err_msg=f"{arch} {jax.tree_util.keystr(path)}")
        # the port's own init: the reference's per-leaf std within 10%
        own = tree.flatten(tm.init_params(0))[0]
        for (path, w), t in zip(
                jax.tree_util.tree_flatten_with_path(params)[0], own):
            assert t.shape == w.shape and t.dtype == torch.float32
            ws, ts = float(np.std(w)), float(t.std())
            name = jax.tree_util.keystr(path)
            if ws == 0.0:
                assert float(t.abs().max()) == 0.0, name
            else:
                assert abs(ts / ws - 1) < 0.1, (arch, name, ts, ws)

    # full-width granite: the default dispatch's bsearch arena, reckoned
    # from meta tensors; its int32 message indices need < 2^31 - 1
    policy = SizeBasedPolicy()

    def bsearch_slots(cfg):
        out = []
        for i, (path, d) in enumerate(
                tree.flatten_with_paths(transformer.param_defs(cfg))):
            leaf = torch.empty(d.shape, dtype=cfg.dtype, device="meta")
            if policy.compressor_for(path, leaf) == "threshold_bsearch":
                out.append((i, path, leaf.numel(), 1, 2, 5))
        return out
    full = tget("granite-moe-3b-a800m")
    cut = dataclasses.replace(full, num_layers=GRANITE_LAYERS)
    group = arena.build_group(0, "threshold_bsearch", "bfloat16",
                              bsearch_slots(cut))
    assert group.total == GRANITE_ARENA and group.total < 2 ** 31 - 1
    deeper = bsearch_slots(dataclasses.replace(full, num_layers=21))
    with pytest.raises(ValueError, match=r"2,189,431,808 elements.*"
                       r"2\^31 - 1 = 2,147,483,647"):
        arena.build_group(0, "threshold_bsearch", "bfloat16", deeper)


def test_trainer_and_launcher_train_granite_smoke(capsys):
    """3 RGC steps of the port's Trainer against the reference's from the
    same carried params; then the launcher in process.

    lr 0.01, not the 0.2 of ``test_torch_models.py``: at 0.2 this smoke
    model diverges in both packages (loss 6.2 -> 12 -> 48), and the f32
    differences of the first update (up to 3.4e-4 in the embedding)
    flip one token's top-2 choice in layer 2, which moves the second
    loss by 1.2% (~1/T of a token's loss, T = 64). The port's model on
    the reference's own step-1 params gives its loss within 3e-7."""
    pytest.importorskip("torch")
    import jax

    from repro.configs import TrainConfig as JTC
    from repro.configs import get_config as jget
    from repro.data import SyntheticLM as JLM
    from repro.train.trainer import Trainer as JTrainer
    from repro_torch import convert
    from repro_torch.configs import get_config as tget
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train as launch
    from repro_torch.train.trainer import Trainer

    arch = "granite-moe-3b-a800m"
    kw = dict(lr=0.01, optimizer="rgc", density=0.01)
    jtr = JTrainer(jget(arch, smoke=True), JTC(**kw))
    jstate = jtr.init_state()
    params = jax.tree.map(np.asarray, jstate.params)
    want = []
    jtr.run(jstate, JLM(512, BATCH, SEQ, seed=0), 3, log_every=0,
            on_metrics=lambda s, d, loss: want.append(loss))

    tr = Trainer(tget(arch, smoke=True), TrainConfig(**kw), device="cpu")
    state = tr.init_state(params=convert.from_numpy(params))
    got = []
    tr.run(state, SyntheticLM(512, BATCH, SEQ, seed=0), 3, log_every=0,
           on_metrics=lambda s, d, loss: got.append(loss))
    assert len(got) == 3 and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4)

    capsys.readouterr()
    launch.main(["--arch", arch, "--smoke", "--device", "cpu",
                 "--steps", "2", "--data", "zipf", "--log-every", "1"])
    out = capsys.readouterr().out
    assert f"arch={arch} params=558,720" in out
    losses = [float(ln.split("loss")[1]) for ln in out.splitlines()
              if ln.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))
