"""Port parity for the slice as a whole: the smoke ``paper-lstm`` model,
the data streams, three RGC trainer steps, the spec grammar, and the
port's import and device rules."""
import ast
import os

import numpy as np
import pytest

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


def test_trainer_steps_match_reference():
    """Three RGC steps (trimmed arena + dense leaves at smoke width) of
    the port's Trainer on the CPU against the JAX Trainer(mesh=None) from
    the same carried-over initial params."""
    pytest.importorskip("torch")
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

    kw = dict(lr=0.2, optimizer="rgc", density=0.01)
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
    assert len(got) == 3 and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4)


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
