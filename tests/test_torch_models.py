"""Port parity of the transformer chassis (``repro_torch.models``:
``common``, ``attention``, ``transformer``, ``registry``) and of the
dense and vlm configs against the JAX reference, on the CPU.

Five items, each looping over its cases rather than parametrising (every
item collected after ``tests/test_property.py`` lengthens that file's run
on one xdist worker). Each reference call runs under ``jax.jit``.

Tolerances, and why:
* attention: rtol 1e-5, atol 1e-6 (f32). The port takes one softmax over
  a query chunk's whole kv span, the reference an online softmax over kv
  chunks that rescales its running sums per chunk; both are f32 with the
  same masks, ``NEG_INF`` and ``max(l, 1e-30)`` guard.
* model loss: rtol 1e-5. Gradients: each leaf within ``GRAD_TOL`` times
  the leaf's largest reference magnitude (f32 smoke configs; matmul,
  softmax and reduction orders differ between XLA and PyTorch). The
  reference's init gives a stacked leaf ``fan_in = num_layers``, so the
  smoke models' q and k projections have std 1/sqrt(2) and their
  attention logits run into the hundreds: the softmax is saturated and
  amplifies f32 rounding. Against the port run in float64, the port's
  f32 gradients differ by up to 2.3e-4 of a leaf's scale and the
  reference's by up to 1.7e-4 (measured at this size); so 1e-3. With
  qk-norm (qwen3) the logits stay small and the bound is 1e-5.
* trainer losses (internlm2 smoke, 3 RGC steps): rtol 1e-4 for the
  first two, 1e-3 for the third. The gradients differ by the f32 margin
  above, and at the second update a coordinate near the selection
  threshold can fall on the other side (measured: 2.2e-4 relative on
  the third loss, 3e-7 on the second).
* bf16 sync: bitwise, with two stated exceptions. The learning rate is
  a power of two, so the reference's ``p - lr * upd``, which XLA may
  contract into one fused multiply-add, rounds as the port's two
  operations do. The dense leaves' velocity ``m * u + g`` is not pinned
  in the reference, and XLA contracts it: it is held within 1 ulp of the
  larger operand (as ``test_torch_sync.py`` holds it), and those leaves'
  params by replaying the port's velocity where the two differ.
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


PORTED = ("internlm2-1.8b", "qwen3-32b", "h2o-danube-3-4b", "gemma3-4b",
          "paligemma-3b")
NOT_PORTED = ("recurrentgemma-9b", "rwkv6-3b", "grok-1-314b",
              "granite-moe-3b-a800m", "whisper-large-v3")
BATCH, SEQ = 2, 32
LR = 0.125
GRAD_TOL = {"qwen3-32b": 1e-5}        # else 1e-3 (see the docstring)


def _dtype_name(dt) -> str:
    return (str(dt).replace("torch.", "") if "torch" in str(dt)
            else np.dtype(dt).name)


def _fields(cfg) -> dict:
    return {f.name: (_dtype_name(getattr(cfg, f.name)) if f.name == "dtype"
                     else getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _batch(cfg, seed=0):
    """Seeded numpy batch: tokens, and for vlm N(0, 0.02^2) prefix
    embeddings."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, SEQ),
                                  dtype=np.int32)}
    if cfg.family == "vlm":
        out["prefix_embeds"] = (0.02 * rng.standard_normal(
            (BATCH, cfg.num_prefix_tokens, cfg.d_model))).astype(np.float32)
    return out


def test_configs_shapes_and_registry_match_reference():
    pytest.importorskip("torch")
    import torch

    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import arena
    from repro_torch.core.dispatch import SizeBasedPolicy
    from repro_torch.core.tree import flatten_with_paths
    from repro_torch.models import registry, transformer

    assert set(tconfigs.ARCH_IDS) == set(PORTED)
    assert [f.name for f in dataclasses.fields(ModelConfig)] == \
        [f.name for f in dataclasses.fields(jconfigs.ModelConfig)]
    for arch in PORTED + ("paper-lstm",):
        for smoke in (False, True):
            want = jconfigs.get_config(arch, smoke=smoke)
            got = tconfigs.get_config(arch, smoke=smoke)
            assert _fields(got) == _fields(want), (arch, smoke)
            assert got.pattern_codes() == want.pattern_codes(), arch
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    for arch in NOT_PORTED:
        jconfigs.get_config(arch)                 # the reference has it
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tconfigs.get_config(arch)
    with pytest.raises(KeyError):
        tconfigs.get_config("internlm2")
    moe = dataclasses.replace(tconfigs.get_config("internlm2-1.8b"),
                              family="moe")
    with pytest.raises(NotImplementedError):
        registry.get_model(moe)

    # full-width internlm2-1.8b: the default dispatch sends the nine
    # matrices (bf16) to one bsearch arena of ~1.89e9 elements; its
    # arena-global indices and padding sentinel (the arena's size) are
    # int32, so the arena must stay below 2^31
    full = tconfigs.get_config("internlm2-1.8b")
    policy = SizeBasedPolicy()
    sparse = []
    for i, (path, d) in enumerate(
            flatten_with_paths(transformer.param_defs(full))):
        leaf = torch.empty(d.shape, dtype=full.dtype, device="meta")
        if policy.compressor_for(path, leaf) == "threshold_bsearch":
            n = leaf.numel()
            sparse.append((i, path, n, 1, 2, 5))
    group = arena.build_group(0, "threshold_bsearch", "bfloat16", sparse)
    assert len(sparse) == 9
    assert group.total == 1_889_009_664 and group.total < 2 ** 31 - 1
    assert group.nblocks == 1_844_736


def test_flash_attention_matches_reference():
    torch = pytest.importorskip("torch")
    import jax

    from repro.models.attention import flash_attention as jflash
    from repro_torch.models.attention import flash_attention as tflash

    cases = [
        ("causal", dict(), 40, 40, 4, 2, 0),
        ("window 16", dict(window=16), 40, 40, 4, 2, 0),
        ("prefix 8", dict(prefix_len=8), 40, 40, 4, 2, 0),
        ("softcap 30", dict(softcap=30.0), 40, 40, 4, 2, 0),
        ("non-causal", dict(causal=False), 40, 40, 4, 2, 0),
        ("GQA g=1", dict(), 40, 40, 4, 4, 0),
        ("GQA g=4", dict(), 40, 40, 4, 1, 0),
        ("q_offset 24", dict(q_offset=24), 16, 40, 4, 2, 0),
        ("window + softcap + q_offset", dict(window=12, softcap=20.0,
                                             q_offset=8), 24, 32, 4, 2, 0),
    ]
    rng = np.random.default_rng(0)
    for label, kw, sq, skv, hq, hkv, _ in cases:
        hd = 16
        q = rng.standard_normal((2, sq, hq, hd)).astype(np.float32)
        k = rng.standard_normal((2, skv, hkv, hd)).astype(np.float32)
        v = rng.standard_normal((2, skv, hkv, hd)).astype(np.float32)
        kw = dict(q_chunk=16, kv_chunk=8, **kw)
        want = np.asarray(jax.jit(lambda a, b, c: jflash(
            a, b, c, differentiable=True, **kw))(q, k, v))
        got = tflash(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6,
                                   err_msg=label)


def test_models_match_reference_loss_grads_and_init():
    torch = pytest.importorskip("torch")
    import jax

    from repro.configs import get_config as jget
    from repro.models.registry import get_model as jmodel
    from repro_torch import convert
    from repro_torch.configs import get_config as tget
    from repro_torch.core import tree
    from repro_torch.models.registry import get_model as tmodel

    for arch in PORTED:
        jcfg, tcfg = jget(arch, smoke=True), tget(arch, smoke=True)
        jm, tm = jmodel(jcfg), tmodel(tcfg)
        params = jax.tree.map(np.asarray, jm.init_params(0))
        batch = _batch(jcfg)
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
        tol = GRAD_TOL.get(arch, 1e-3)
        for (path, w), g in zip(jg, grads):
            w = np.asarray(w)
            np.testing.assert_allclose(
                g.numpy(), w, rtol=0, atol=tol * float(np.abs(w).max()),
                err_msg=f"{arch} {jax.tree_util.keystr(path)}")

        # the port's own init: the reference's per-leaf std within 10%
        # (a leaf stacked on the layer axis has fan_in = num_layers)
        own = tree.flatten(tm.init_params(0))[0]
        for (path, w), t in zip(
                jax.tree_util.tree_flatten_with_path(params)[0], own):
            assert t.shape == w.shape and t.dtype == torch.float32
            ws, ts = float(np.std(w)), float(t.std())
            name = jax.tree_util.keystr(path)
            if ws == 0.0:
                assert ts == 0.0 and float(t.abs().max()) == 0.0, name
            else:
                assert abs(ts / ws - 1) < 0.1, (arch, name, ts, ws)
            if name.startswith("['layers']") and t.dim() == 3:
                assert abs(ts * tcfg.num_layers ** 0.5 - 1) < 0.1, name


def test_trainer_and_launcher_train_internlm2_smoke(capsys):
    """3 RGC steps of the port's Trainer against the reference's from the
    same carried params; then the launcher in process."""
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

    kw = dict(lr=0.2, optimizer="rgc", density=0.01)
    jtr = JTrainer(jget("internlm2-1.8b", smoke=True), JTC(**kw))
    jstate = jtr.init_state()
    params = jax.tree.map(np.asarray, jstate.params)
    want = []
    jtr.run(jstate, JLM(512, BATCH, SEQ, seed=0), 3, log_every=0,
            on_metrics=lambda s, d, loss: want.append(loss))

    tr = Trainer(tget("internlm2-1.8b", smoke=True), TrainConfig(**kw),
                 device="cpu")
    state = tr.init_state(params=convert.from_numpy(params))
    got = []
    tr.run(state, SyntheticLM(512, BATCH, SEQ, seed=0), 3, log_every=0,
           on_metrics=lambda s, d, loss: got.append(loss))
    assert len(got) == 3 and all(np.isfinite(got))
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-4)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-3)

    capsys.readouterr()
    launch.main(["--arch", "internlm2-1.8b", "--smoke", "--device", "cpu",
                 "--steps", "2", "--data", "zipf", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "arch=internlm2-1.8b params=426,624" in out
    losses = [float(ln.split("loss")[1]) for ln in out.splitlines()
              if ln.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))


def _assert_fma_close(got, want, *operands):
    """|got - want| <= 1 ulp of the largest of ``operands`` and ``want``
    (elementwise): the gap a fused vs an unfused multiply-add leaves."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.maximum.reduce([np.abs(np.asarray(o, np.float32))
                               for o in (*operands, want)])
    assert np.all(np.abs(got - want) <= np.spacing(scale))


def test_bf16_sync_matches_reference_bitwise():
    """internlm2-1.8b smoke in bf16: the same seeded bf16 gradient tree
    through both packages' ``GradientSync.update`` for 2 steps (default
    ``rgc`` dispatch: trimmed and dense leaves at this width). Messages
    (selected indices and values), residual, thresholds, phases,
    intervals, the sparse leaves' velocity and params bitwise; the dense
    leaves as the module docstring says. The tree crosses ``convert``
    bitwise both ways."""
    torch = pytest.importorskip("torch")
    import jax
    import jax.numpy as jnp
    import ml_dtypes

    from repro.configs import get_config as jget
    from repro.core.gradient_sync import build_gradient_sync as jbuild
    from repro.models.registry import get_model as jmodel
    from repro_torch import convert
    from repro_torch.core import tree
    from repro_torch.core.gradient_sync import build_gradient_sync as tbuild

    cfg = dataclasses.replace(jget("internlm2-1.8b", smoke=True),
                              dtype=jnp.bfloat16)
    params = jax.tree.map(np.asarray, jmodel(cfg).init_params(0))
    leaves = jax.tree.leaves(params)
    assert all(a.dtype == ml_dtypes.bfloat16 for a in leaves)

    # the bf16 tree crosses bitwise (bits in, f32 values back)
    tp = convert.from_numpy(params)
    for a, t in zip(leaves, jax.tree.leaves(convert.to_numpy(tp))):
        assert t.dtype == np.float32
        np.testing.assert_array_equal(t, a.astype(np.float32))
    for a, t in zip(leaves, tree.flatten(tp)[0]):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16))

    rng = np.random.default_rng(1)
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 1e-2)
                          .astype(ml_dtypes.bfloat16), params)
             for _ in range(2)]

    kw = dict(density=0.01)
    jsync, tsync = jbuild("rgc", **kw), tbuild("rgc", device="cpu", **kw)
    dense = [tsync.policy.compressor_for(path, t) == "dense"
             for path, t in tree.flatten_with_paths(tp)]
    assert 0 < sum(dense) < len(dense)
    jsent, tsent = [], []
    jsync.transport.allgather = (
        lambda ms, f=jsync.transport.allgather: jsent.extend(ms) or f(ms))
    tsync.transport.allgather = (
        lambda ms, f=tsync.transport.allgather: tsent.extend(ms) or f(ms))

    def jstep(g, s, p):
        jsent.clear()
        return jsync.update(g, s, p, jnp.float32(LR)), list(jsent)
    jstep = jax.jit(jstep)

    jp = jax.tree.map(jnp.asarray, params)
    js = jsync.init(jp)
    ts = tsync.init(tp)
    lr = torch.tensor(LR, dtype=torch.float32)
    is_ls = {"is_leaf": lambda x: hasattr(x, "_fields")}
    for step, g in enumerate(grads):
        p_prev = [a.astype(np.float32) for a in jax.tree.leaves(
            convert.to_numpy(tp))]
        u_prev = [np.asarray(st.momentum) for st in jax.tree.leaves(
            convert.to_numpy(ts), **is_ls)]
        (jp, js), jmsgs = jstep(jax.tree.map(jnp.asarray, g), js, jp)
        tsent.clear()
        tp, ts = tsync.update(convert.from_numpy(g), ts, tp, lr)
        assert len(jmsgs) == len(tsent) >= 1
        for a, b in zip(tsent, jmsgs):
            np.testing.assert_array_equal(
                a.numpy().view(np.int32), np.asarray(b).view(np.int32),
                err_msg=f"step {step} message")
        tls = jax.tree.leaves(convert.to_numpy(ts), **is_ls)
        jls = jax.tree.leaves(js, **is_ls)
        for i, (a, b) in enumerate(zip(tls, jls)):
            for fld, x, y in zip(a._fields, a, b):
                if fld == "momentum" and dense[i]:
                    g_i = jax.tree.leaves(g)[i].astype(np.float32)
                    _assert_fma_close(x, y, 0.9 * u_prev[i], g_i)
                else:
                    np.testing.assert_array_equal(
                        _bits(x), _bits(y), err_msg=f"step {step} {fld} {i}")
        for i, (a, b) in enumerate(zip(tree.flatten(tp)[0],
                                       jax.tree.leaves(jp))):
            assert a.dtype == torch.bfloat16
            want = np.asarray(b).view(np.int16)
            if dense[i]:
                # where the velocities differ, the port's own apply
                u_t = np.asarray(tls[i].momentum)
                u_j = np.asarray(jls[i].momentum)
                replay = (p_prev[i] - np.float32(LR) * u_t).astype(
                    ml_dtypes.bfloat16).view(np.int16)
                want = np.where(_bits(u_t) == _bits(u_j), want, replay)
            np.testing.assert_array_equal(
                a.view(torch.int16).numpy(), want,
                err_msg=f"step {step} params {i}")
