"""Port parity of multi-worker RGC sync over ``torch.distributed`` (gloo
ranks on the CPU) against the JAX package run under ``jax.vmap``.

* Sync, 4 workers: ``_transport_prog.py``'s scenario (the mixed-size
  tree, 3 steps, density 0.01, momentum 0.9, a different gradient per
  worker) for fused / bucketed / per-leaf on ``("data",) = 4`` and fused /
  hierarchical / hierarchical(intra_axis="node") on ``("node", "local")
  = (2, 2)``. The reference runs the same steps as a (nested) ``vmap``
  over the named axes, which gives the same bits as its ``shard_map``.
* The hierarchical exchange's row order, on tagged payloads.
* The data-parallel trainer, 2 workers: ``Trainer(mesh=("data",)=2)``
  against ``flat_step``'s computation (local ``value_and_grad``,
  ``sync.update`` over "data", ``pmean`` of the loss) under ``vmap``,
  on the default path and on path 3a.

Each group of ranks is spawned once per test run (shared by the xdist
workers through a lock); the tests read what the ranks wrote.
"""
import fcntl
import json
import os
import shutil
import time
import traceback
import types

import numpy as np
import pytest

import _torch_dist_prog as prog


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


SPARSE = ("big", "mid", "mid2")      # leaves the §5.5 dispatch compresses


def _lock(lock, name: str, timeout: float) -> None:
    """Take ``lock`` exclusively, polling until ``timeout`` seconds have
    passed; then fail the test with the reason."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
            return
        except BlockingIOError:
            if time.monotonic() > deadline:
                pytest.fail(f"{name}: another worker held the lock for "
                            f"over {timeout:.0f} s (its ranks hung?)")
            time.sleep(0.2)


def _once(tmp_path_factory, name, produce):
    """``produce(dir)`` once per test run, whichever xdist worker asks
    first; the others wait on the lock (up to the ranks' deadline and the
    reference's time) and read its directory (or its error)."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent          # the run's temp dir, shared by workers
    out = base / name
    with open(base / f"{name}.lock", "w") as lock:
        _lock(lock, name, 2 * prog.DEADLINE_S)
        if not (out / "done").exists():
            shutil.rmtree(out, ignore_errors=True)
            out.mkdir()
            try:
                produce(str(out))
                (out / "done").write_text("ok")
            except Exception:
                (out / "done").write_text(
                    f"failed:\n{traceback.format_exc()}")
    said = (out / "done").read_text()
    if said != "ok":
        pytest.fail(f"{name}: {said}")
    return str(out)


def test_hung_ranks_fail_by_one_deadline(tmp_path):
    """``wait`` gives the group one deadline: ranks still running at it
    are killed and named as hung, and the group fails at once."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=time.sleep, args=(60,)) for _ in range(2)]
    for p in procs:
        p.start()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        prog.wait(procs, str(tmp_path), timeout=2.0)
    assert time.monotonic() - t0 < 10
    for r in range(2):
        assert f"rank {r} (exit" in str(err.value)
    assert str(err.value).count(", hung)") == 2
    assert not any(p.is_alive() for p in procs)


# ---------------------------------------------------------------------------
# sync at p = 4
# ---------------------------------------------------------------------------

def _jax_sync(axes, inp, schedule="sequential"):
    """The reference's STEPS updates on every worker under (nested) vmap:
    ``{key: [4, ...]}`` in worker order. On ``("node", "local")`` it runs
    ``hierarchical`` (its one-axis gathers batch under vmap, where a
    joint-axis ``all_gather`` does not), which the reference holds
    bitwise equal to ``fused_allgather``."""
    import jax
    import jax.numpy as jnp

    from repro.core import build_gradient_sync

    sizes = prog.TREE_SIZES
    sync = build_gradient_sync(
        "rgc", sync_axes=axes, density=prog.DENSITY, momentum=0.9,
        transport="fused_allgather" if len(axes) == 1 else "hierarchical",
        schedule=schedule)
    params = {k: jnp.asarray(inp[f"p/{k}"]) for k in sizes}
    state0 = sync.init(params)

    def worker(gs, p, st):
        for t in range(prog.STEPS):
            p, st = sync.update({k: g[t] for k, g in gs.items()}, st, p,
                                jnp.float32(prog.LR))
        return p, st

    grads = {k: jnp.asarray(inp[f"g/{k}"]) for k in sizes}
    if axes == ("data",):
        f = jax.vmap(worker, in_axes=(0, None, None), axis_name="data")
    else:
        grads = {k: g.reshape(2, 2, *g.shape[1:]) for k, g in grads.items()}
        f = jax.vmap(jax.vmap(worker, in_axes=(0, None, None),
                              axis_name="local"),
                     in_axes=(0, None, None), axis_name="node")
    p, st = jax.jit(f)(grads, params, state0)
    out = {f"p/{k}": np.asarray(v).reshape(4, -1) for k, v in p.items()}
    pending = ()
    if hasattr(st, "pending"):
        st, pending = st.leaf, st.pending
    for k, leaf in st.items():
        for fld, v in leaf._asdict().items():
            v = np.asarray(v)
            out[f"s/{k}/{fld}"] = v.reshape(4, *v.shape[len(axes):])
    for i, m in enumerate(pending):
        out[f"q/{i}"] = np.asarray(m).reshape(4, -1)
    return out


def _produce_sync(d):
    rng = np.random.default_rng(0)
    inp = {}
    for k, n in prog.TREE_SIZES.items():
        inp[f"p/{k}"] = rng.standard_normal(n).astype(np.float32)
    for k, n in prog.TREE_SIZES.items():
        inp[f"g/{k}"] = (rng.standard_normal((4, prog.STEPS, n)) * 0.01
                         ).astype(np.float32)
    np.savez(os.path.join(d, "sync_inputs.npz"), **inp)
    ranks = prog.start("sync", 4, d)     # the ranks run beside the reference
    try:
        for axes, tag, schedule in ((("data",), "data", "sequential"),
                                    (("node", "local"), "node",
                                     "sequential"),
                                    (("data",), "stale1_data", "stale1")):
            ref = _jax_sync(axes, inp, schedule)
            np.savez(os.path.join(d, f"jax_{tag}.npz"),
                     **{k: v[0] for k, v in ref.items()})
            with open(os.path.join(d, f"jax_{tag}.json"), "w") as f:
                json.dump([{k: prog.digest(v[w]) for k, v in ref.items()}
                           for w in range(4)], f)
    finally:
        prog.wait(ranks, d)


@pytest.fixture(scope="module")
def sync_run(tmp_path_factory):
    pytest.importorskip("torch")
    return _once(tmp_path_factory, "torch_dist_sync", _produce_sync)


def _rank_digests(d):
    out = []
    for r in range(4):
        with open(os.path.join(d, f"sync_rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _within_ulps(got, want, ulps, *scales):
    """|got - want| <= ``ulps`` ulp of the largest of |want| and the
    ``scales`` (elementwise or scalar)."""
    scale = np.maximum.reduce([np.abs(want)] + [np.abs(np.asarray(
        x, np.float32)) + np.zeros_like(want) for x in scales])
    gap = np.abs(got.astype(np.float64) - want)
    assert np.all(gap <= ulps * np.spacing(scale)), float(
        np.max(gap / np.spacing(scale)))


@pytest.mark.parametrize("name", [c[0] for c in prog.SYNC_CONFIGS])
def test_sync_matches_jax_at_four_workers(sync_run, name):
    """Every rank's residual, momentum, threshold and counters of the
    sparse leaves bitwise equal to the reference worker's (they are per
    worker), so every selection and message is too; so are a buffered
    schedule's pending messages (``stale1``, against the reference's
    ``stale1``; ``chunked`` against ``sequential``, which the reference
    holds bitwise equal to it). Parameters: see
    ``test_sync_params_match_jax_up_to_contraction``. The dense leaf (the
    all-reduce mean, summed in gloo's order, not XLA's) within 2 ulp of
    the larger of its value and the gradients summed into it."""
    tag = prog.ref_tag(name)
    with open(os.path.join(sync_run, f"jax_{tag}.json")) as f:
        want_digests = json.load(f)
    for r, ranks in enumerate(_rank_digests(sync_run)):
        got_digests = ranks["digests"][name]
        assert sorted(got_digests) == sorted(want_digests[r])
        for key, dig in got_digests.items():
            if (key.startswith("q/") or key.startswith("s/")
                    and key.split("/")[1] in SPARSE):
                assert dig == want_digests[r][key], (r, key)
    got = np.load(os.path.join(sync_run, f"sync_{name}.npz"))
    want = np.load(os.path.join(sync_run, f"jax_{tag}.npz"))
    g = np.load(os.path.join(sync_run, "sync_inputs.npz"))["g/small"]
    for key in ("p/small", "s/small/momentum"):
        _within_ulps(got[key], want[key], 2, np.abs(g).max(axis=(0, 1)))
    for key in want.files:
        if key.startswith("s/small/") and key != "s/small/momentum":
            assert np.array_equal(got[key], want[key]), key


def test_sync_params_match_jax_up_to_contraction(sync_run):
    """Replaying ``p - lr * (g_sum / 4)`` over the steps from the shared
    inputs and the update sums the port decompressed: with two roundings
    it gives the port's parameters of the sparse leaves bit for bit, and
    with one (a fused multiply-add, which XLA makes of the reference's
    unpinned ``p - lr * upd`` under jit) the reference's. So the
    decompressed sums, where rows of 4 workers collide, match too."""
    inp = np.load(os.path.join(sync_run, "sync_inputs.npz"))
    sums = np.load(os.path.join(sync_run, "sync_sums.npz"))
    got = np.load(os.path.join(sync_run, "sync_fused-data.npz"))
    want = np.load(os.path.join(sync_run, "jax_data.npz"))
    lr = np.float32(prog.LR)
    for leaf in SPARSE:
        assert sums[leaf].shape[0] == prog.STEPS
        two = one = inp[f"p/{leaf}"]
        for g_sum in sums[leaf]:
            upd = g_sum / np.float32(4)
            two = two - lr * upd
            # lr * upd is exact in f64 (24 + 24 bits): one rounding to f32
            one = (one.astype(np.float64)
                   - np.float64(lr) * upd.astype(np.float64)
                   ).astype(np.float32)
        assert np.array_equal(two.view(np.int32),
                              got[f"p/{leaf}"].view(np.int32)), leaf
        assert np.array_equal(one.view(np.int32),
                              want[f"p/{leaf}"].view(np.int32)), leaf


def test_sync_ranks_and_transports_bitwise_equal(sync_run):
    """Every rank ends with rank 0's parameter bits, and on every rank
    every transport, and the ``chunked`` schedule, ends with the fused
    sequential run's bits (params and state), on both meshes."""
    ranks = [r["digests"] for r in _rank_digests(sync_run)]
    for r in range(4):
        for name, digests in ranks[r].items():
            if prog.ref_tag(name) in ("data", "node"):
                assert digests == ranks[r]["fused-data"], (r, name)
            params = {k: v for k, v in digests.items()
                      if k.startswith("p/")}
            assert params == {k: v for k, v in ranks[0][name].items()
                              if k.startswith("p/")}, (r, name)


def test_hierarchical_row_order(sync_run):
    """The two-hop exchange stacks the rows as the joint gather does,
    node-major, for either intra axis; a gather over the axes named in
    the other order is major in that order, as ``jax.lax.all_gather``."""
    for ranks in _rank_digests(sync_run):
        order = ranks["order"]
        assert order["joint"] == [0.0, 1.0, 2.0, 3.0]
        assert order["swapped"] == [0.0, 2.0, 1.0, 3.0]
        assert order["hier_equal"] and order["hier_node_equal"]


# ---------------------------------------------------------------------------
# data-parallel trainer at p = 2
# ---------------------------------------------------------------------------

def _jax_trainer_losses(params, kw):
    """``flat_step``'s computation under vmap over "data" = 2."""
    import jax
    import jax.numpy as jnp

    from repro.configs import TrainConfig as JTC
    from repro.configs import get_config
    from repro.data import bigram_batches as jbigram
    from repro.models.registry import get_model
    from repro.train.trainer import make_gradient_sync

    model = get_model(get_config("paper-lstm", smoke=True))
    sync = make_gradient_sync(JTC(**prog.TRAINER_KW, **kw),
                              types.SimpleNamespace(axis_names=("data",)))

    def flat_step(p, st, batch, lr):
        loss, grads = jax.value_and_grad(model.loss)(p, batch)
        p, st = sync.update(grads, st, p, lr,
                            density=prog.TRAINER_KW["density"])
        return jax.lax.pmean(loss, "data"), p, st

    step = jax.jit(jax.vmap(flat_step, in_axes=(0, 0, 0, None),
                            axis_name="data"))
    p = jax.tree.map(lambda x: jnp.stack([x, x]), params)
    st = jax.tree.map(lambda x: jnp.stack([x, x]), sync.init(params))
    data = jbigram(512, prog.TRAINER_BATCH, prog.TRAINER_SEQ, seed=0)
    losses = []
    for _ in range(prog.TRAINER_STEPS):
        tokens = next(data)["tokens"]
        batch = {"tokens": tokens.reshape(2, -1, tokens.shape[-1])}
        loss, p, st = step(p, st, batch, jnp.float32(
            prog.TRAINER_KW["lr"]))
        losses.append(np.asarray(loss))
    return [float(x[0]) for x in losses], all(x[0] == x[1] for x in losses)


def _produce_trainer(d):
    import jax

    from repro.configs import get_config
    from repro.models.registry import get_model

    params = get_model(get_config("paper-lstm", smoke=True)).init_params(0)
    np.savez(os.path.join(d, "trainer_params.npz"),
             **prog.flat(jax.tree.map(np.asarray, params)))
    ranks = prog.start("trainer", 2, d)
    try:
        ref = {path: _jax_trainer_losses(params, kw)
               for path, kw in prog.TRAINER_PATHS.items()}
        with open(os.path.join(d, "jax_trainer.json"), "w") as f:
            json.dump(ref, f)
    finally:
        prog.wait(ranks, d)


@pytest.fixture(scope="module")
def trainer_run(tmp_path_factory):
    pytest.importorskip("torch")
    return _once(tmp_path_factory, "torch_dist_trainer", _produce_trainer)


def _trainer_ranks(d):
    out = []
    for r in range(2):
        with open(os.path.join(d, f"trainer_rank{r}.json")) as f:
            out.append(json.load(f))
    return out


@pytest.mark.parametrize("path", list(prog.TRAINER_PATHS))
def test_trainer_matches_jax_data_parallel(trainer_run, path):
    """Rank-mean losses within rtol 1e-4 of the reference's pmean'd
    losses; both ranks end with the same parameter bits."""
    with open(os.path.join(trainer_run, "jax_trainer.json")) as f:
        want, workers_equal = json.load(f)[path]
    assert workers_equal
    r0, r1 = _trainer_ranks(trainer_run)
    got = r0[path]["losses"]
    assert len(got) == prog.TRAINER_STEPS and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert r1[path]["losses"] == got
    assert r1[path]["digests"] == r0[path]["digests"]


def test_trainer_seeded_init_is_replicated(trainer_run):
    """Every rank draws the same initial parameters from the seed."""
    r0, r1 = _trainer_ranks(trainer_run)
    assert r0["seeded_init"] and r0["seeded_init"] == r1["seeded_init"]
