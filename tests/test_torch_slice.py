"""Port parity for the slice as a whole: the smoke ``paper-lstm`` model,
the data streams, three RGC trainer steps on each path (default, 2b, and
the per-leaf paths 3a and 3b), the launcher's flags, the spec grammar,
and the port's import and device rules."""
import ast
import os

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


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, BATCH = 16, 2


def _jax_smoke():
    from repro.configs import get_config
    from repro.models.registry import get_model
    return get_model(get_config("paper-lstm", smoke=True))


def test_smoke_loss_and_grads_match_reference():
    torch = pytest.importorskip("torch")
    import jax

    from repro.data import bigram_batches as jbigram
    from repro_torch import convert
    from repro_torch.configs import paper_lstm
    from repro_torch.core import tree
    from repro_torch.models import lstm

    model = _jax_smoke()
    params = jax.tree.map(np.asarray, model.init_params(0))
    tokens = next(jbigram(512, BATCH, SEQ, seed=0))["tokens"]
    wl, wg = jax.jit(jax.value_and_grad(model.loss))(
        params, {"tokens": tokens})

    tp = convert.from_numpy(params)
    leaves, treedef = tree.flatten(tp)
    for p in leaves:
        p.requires_grad_(True)
    gl = lstm.loss(paper_lstm.smoke(), tp, torch.from_numpy(tokens))
    grads = torch.autograd.grad(gl, leaves)
    np.testing.assert_allclose(float(gl.detach()), float(wl), rtol=1e-5)
    for g, w in zip(grads, jax.tree.leaves(wg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_data_streams_identical():
    pytest.importorskip("torch")
    from repro.data import SyntheticLM as JLM
    from repro.data import bigram_batches as jbigram
    from repro_torch.data import SyntheticLM, bigram_batches
    a, b = jbigram(512, 3, 12, seed=4), bigram_batches(512, 3, 12, seed=4)
    for _ in range(3):
        np.testing.assert_array_equal(next(a)["tokens"], next(b)["tokens"])
    np.testing.assert_array_equal(JLM(512, 3, 12, seed=1).batch_at(5)["tokens"],
                                  SyntheticLM(512, 3, 12, seed=1)
                                  .batch_at(5)["tokens"])


def _trainer_losses(kw):
    """Three steps of the JAX Trainer(mesh=None) and of the port's Trainer
    on the CPU, from the same carried-over initial params."""
    import jax

    from repro.configs import TrainConfig as JTC
    from repro.configs import get_config
    from repro.data import bigram_batches as jbigram
    from repro.train.trainer import Trainer as JTrainer
    from repro_torch import convert
    from repro_torch.configs import paper_lstm
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import bigram_batches
    from repro_torch.train.trainer import Trainer

    jtr = JTrainer(get_config("paper-lstm", smoke=True), JTC(**kw))
    jstate = jtr.init_state()
    params = jax.tree.map(np.asarray, jstate.params)
    want = []
    jtr.run(jstate, jbigram(512, BATCH, SEQ, seed=0), 3, log_every=0,
            on_metrics=lambda s, d, loss: want.append(loss))

    tr = Trainer(paper_lstm.smoke(), TrainConfig(**kw), device="cpu")
    state = tr.init_state(params=convert.from_numpy(params))
    got = []
    tr.run(state, bigram_batches(512, BATCH, SEQ, seed=0), 3, log_every=0,
           on_metrics=lambda s, d, loss: got.append(loss))
    return got, want


def test_trainer_steps_match_reference():
    """Three RGC steps (trimmed arena + dense leaves at smoke width)."""
    pytest.importorskip("torch")
    got, want = _trainer_losses(dict(lr=0.2, optimizer="rgc", density=0.01))
    assert len(got) == 3 and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_trainer_sampled_fused_steps_match_reference():
    """Three steps of path 2b at smoke width: ``sampled_bsearch`` on every
    leaf (one nine-slot arena, strided slots) with ``fuse_accumulate``."""
    pytest.importorskip("torch")
    got, want = _trainer_losses(dict(lr=0.2, optimizer="sampled_bsearch",
                                     density=0.01, fuse_accumulate=True))
    assert len(got) == 3 and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("kw", [
    dict(fuse_leaves=False),
    dict(optimizer="trimmed_topk", fuse_leaves=False),
], ids=["3a", "3b"])
def test_trainer_per_leaf_steps_match_reference(kw):
    """Three steps of paths 3a (``rgc`` per leaf: Alg 3 on the matrices,
    dense biases) and 3b (``trimmed_topk`` per leaf on every leaf) at
    smoke width, through the per-leaf kernel compositions' twins."""
    pytest.importorskip("torch")
    got, want = _trainer_losses(dict(lr=0.2, density=0.01, **kw))
    assert len(got) == 3 and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_trainer_quant_and_corrections_match_reference():
    """Three steps of paths 4a (``rgc_quant``: quantized per-leaf search
    on the LSTM matrices, embedding and output layer in the arena) and 4b
    (factor masking, local clipping and the warm-up ramp, two steps per
    stage: densities 0.25, 0.25, 0.0625) at smoke width."""
    pytest.importorskip("torch")
    for path, kw in (("4a", dict(optimizer="rgc_quant")),
                     ("4b", dict(optimizer="factor_masking+warmup(rgc)",
                                 local_clip=1.0, warmup_steps_per_stage=2))):
        got, want = _trainer_losses(dict(lr=0.2, density=0.01, **kw))
        assert len(got) == 3 and all(np.isfinite(got)), path
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=path)


def test_launcher_runs_quant_and_warmup(capsys):
    """The launcher trains 2 steps at smoke width on the CPU with
    ``rgc_quant`` and with ``warmup(rgc)``, and the
    ``--warmup-steps-per-stage`` ramp shows in the logged density."""
    pytest.importorskip("torch")
    from repro_torch.launch import train as launch
    for optimizer in ("rgc_quant", "warmup(rgc)"):
        launch.main(["--arch", "paper-lstm", "--smoke", "--device", "cpu",
                     "--steps", "2", "--batch", "2", "--seq", "8",
                     "--optimizer", optimizer, "--momentum", "0.5",
                     "--warmup-steps-per-stage", "1", "--log-every", "1"])
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("step")]
        assert len(lines) == 2, optimizer
        losses = [float(ln.split("loss")[1]) for ln in lines]
        assert all(np.isfinite(losses)), optimizer
        # the trainer's own schedule ramps rgc_quant; the spec's,
        # warmup(rgc)
        assert [ln.split("density")[1].split()[0] for ln in lines] == \
            ["25.0000%", "6.2500%"], optimizer


def test_launcher_momentum_and_warmup_flags(monkeypatch):
    pytest.importorskip("torch")
    from repro_torch.launch import train as launch
    from repro_torch.train import trainer

    seen = []

    class Stop(Exception):
        pass

    def fake(cfg, tc, device=None):
        seen.append(tc)
        raise Stop
    monkeypatch.setattr(trainer, "Trainer", fake)
    with pytest.raises(Stop):
        launch.main(["--arch", "paper-lstm", "--smoke", "--device", "cpu",
                     "--optimizer", "rgc_quant", "--momentum", "0.0",
                     "--warmup-steps-per-stage", "7"])
    assert (seen[-1].momentum, seen[-1].warmup_steps_per_stage,
            seen[-1].optimizer) == (0.0, 7, "rgc_quant")


def test_launcher_no_fuse_leaves_flag(monkeypatch):
    """``--no-fuse-leaves`` reaches the trainer as
    ``TrainConfig(fuse_leaves=False)``, as in the JAX launcher."""
    pytest.importorskip("torch")
    from repro_torch.launch import train as launch
    from repro_torch.train import trainer

    seen = []

    class Stop(Exception):
        pass

    def fake(cfg, tc, device=None):
        seen.append(tc)
        raise Stop
    monkeypatch.setattr(trainer, "Trainer", fake)
    for flags, fuse in (([], True), (["--no-fuse-leaves"], False)):
        with pytest.raises(Stop):
            launch.main(["--arch", "paper-lstm", "--smoke", "--device", "cpu",
                         "--optimizer", "trimmed_topk", *flags])
        assert seen[-1].fuse_leaves is fuse
        assert seen[-1].optimizer == "trimmed_topk"


@pytest.mark.parametrize("spec", [
    "rgc", "threshold_bsearch", "momentum", "momentum+clip(threshold_bsearch)",
    "momentum+clip+threshold_bsearch", "warmup(rgc)", "masking+momentum(rgc)",
    "clip(rgc)+momentum", "trimmed_topk+momentum"])
def test_spec_grammar_parses_as_reference(spec):
    pytest.importorskip("torch")
    import repro.core  # noqa: F401 (registrations)
    from repro.core.correction import split_corrections as jsplit
    from repro_torch.core.correction import split_corrections as tsplit
    try:
        want = jsplit(spec)
    except ValueError:
        with pytest.raises(ValueError):
            tsplit(spec)
        return
    assert tsplit(spec) == want


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    torch = pytest.importorskip("torch")
    from repro_torch.configs import paper_lstm
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.gradient_sync import build_gradient_sync
    from repro_torch.launch import train as launch
    from repro_torch.train.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(paper_lstm.smoke(), TrainConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_gradient_sync("rgc")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--arch", "paper-lstm", "--smoke", "--steps", "1"])
    assert build_gradient_sync("rgc", device="cpu").device.type == "cpu"


def test_kernel_wrappers_raise_off_cpu_and_cuda():
    """A wrapper takes the plain twin only for a CPU tensor; any other
    non-CUDA device raises instead of falling back."""
    torch = pytest.importorskip("torch")
    from repro_torch.core import arena
    from repro_torch.kernels import segmented as kseg
    g = arena.build_group(0, "threshold_bsearch", "float32",
                          [(0, "a", 3000, 3, 6, 13)]).geometry
    x = torch.empty((g.nblocks, 1024), device="meta")
    thr = torch.zeros(1, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kseg.seg_count_gt(x, g, thr)
    with pytest.raises(ValueError, match="no kernel"):
        kseg.seg_abs_sum_max(x, g)
    with pytest.raises(ValueError, match="no kernel"):
        kseg.seg_compact_gt(x, g, thr, 8)
    with pytest.raises(ValueError, match="no kernel"):
        kseg.seg_count_gt(x, g, thr, (4,))
    with pytest.raises(ValueError, match="no kernel"):
        kseg.seg_abs_sum_max(x, g, (4,))
    with pytest.raises(ValueError, match="no kernel"):
        kseg.seg_residual_update_stats(x, x, None, None, g, momentum=0.0,
                                       nesterov=False, stride_seg=(4,))
    # the per-leaf wrappers
    from repro_torch.kernels import (block_stats, compact, residual_update,
                                     threshold_count)
    leaf, t = torch.empty(3000, device="meta"), torch.zeros((), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        threshold_count.count_gt(leaf, t)
    with pytest.raises(ValueError, match="no kernel"):
        block_stats.abs_sum_max(leaf)
    with pytest.raises(ValueError, match="no kernel"):
        compact.compact_gt(leaf, t, 8)
    with pytest.raises(ValueError, match="no kernel"):
        compact.compact_gt_exact(leaf, t, 8)
    with pytest.raises(ValueError, match="no kernel"):
        residual_update.residual_update(leaf, leaf, leaf, momentum=0.9,
                                        nesterov=False)
