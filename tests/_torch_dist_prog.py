"""Worker side of ``test_torch_dist.py``: gloo ranks on the CPU.

``start(task, world, workdir)`` starts ``world`` processes (the
``spawn`` start method) that join one gloo process group through a file
under ``workdir`` and run ``task``, and ``wait`` joins them; each writes
its results into ``workdir``, and a rank's exception lands in
``rank<r>.err``. The tasks
import ``torch``, ``numpy`` and ``repro_torch`` only.

* ``sync``    — 4 ranks: ``_transport_prog.py``'s scenario (STEPS sync
                steps of the mixed-size tree, a different gradient per
                worker) for every transport, mesh and schedule of
                ``SYNC_CONFIGS``, then the tagged row-order check.
* ``trainer`` — 2 ranks: ``Trainer(mesh=("data",)=2)`` from given params
                for each path of ``TRAINER_PATHS``, the seeded init, and
                ``CKPT_STEPS`` steps under ``stale1`` that save one
                checkpoint chain into ``<workdir>/CKPT_DIR``, then a save
                that fails on rank 0.
"""
from __future__ import annotations

import datetime
import hashlib
import json
import os
import time
import traceback

import numpy as np

STEPS = 3
LR = 0.1
DENSITY = 0.01
TREE_SIZES = {"big": (1 << 20) + 17, "mid": 96 * 1024 + 3,
              "mid2": 33_001, "small": 1_000}
MESHES = {("data",): (4,), ("node", "local"): (2, 2)}
# (name, transport, sync axes, build_gradient_sync knobs); "chunked"'s
# bucket_bytes splits the tree into three chunks: (small, mid2), mid, big
SYNC_CONFIGS = (
    ("fused-data", "fused_allgather", ("data",), {}),
    ("bucketed-data", "bucketed_allgather", ("data",),
     {"bucket_bytes": 40_000}),
    ("per_leaf-data", "per_leaf_allgather", ("data",), {}),
    ("fused-node", "fused_allgather", ("node", "local"), {}),
    ("hier-node", "hierarchical", ("node", "local"), {}),
    ("hier_intra_node-node", "hierarchical", ("node", "local"),
     {"intra_axis": "node"}),
    ("chunked-data", "fused_allgather", ("data",),
     {"schedule": "chunked", "bucket_bytes": 400_000}),
    ("stale1-data", "fused_allgather", ("data",), {"schedule": "stale1"}),
)
TRAINER_PATHS = {"default": {}, "3a": {"fuse_leaves": False}}
TRAINER_KW = dict(lr=0.2, density=0.01)
TRAINER_BATCH, TRAINER_SEQ, TRAINER_STEPS = 4, 16, 3
CKPT_DIR, CKPT_STEPS = "ckpt_stale1", 2
# one deadline for a whole group of ranks (several times the slowest
# group's run), and the process group's own timeout for a collective
DEADLINE_S = 180.0
PG_TIMEOUT = datetime.timedelta(seconds=120)


def digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def ref_tag(name: str) -> str:
    """The reference run a config is held against: its mesh's (``data``,
    ``node``), or ``<schedule>_<mesh>`` for a stale schedule (``chunked``
    is bitwise ``sequential`` in the reference too)."""
    kw = next(c[3] for c in SYNC_CONFIGS if c[0] == name)
    tag = name.rsplit("-", 1)[1]
    sched = kw.get("schedule", "sequential")
    return tag if sched in ("sequential", "chunked") else f"{sched}_{tag}"


def state_arrays(params, state) -> dict[str, np.ndarray]:
    """Every params leaf and LeafState field, keyed ``p/<leaf>`` and
    ``s/<leaf>/<field>``, and a buffered schedule's pending messages,
    ``q/<unit>``, as numpy arrays."""
    out = {f"p/{k}": v.numpy() for k, v in params.items()}
    pending = ()
    if hasattr(state, "pending"):
        state, pending = state.leaf, state.pending
    for k, st in state.items():
        for fld, v in st._asdict().items():
            out[f"s/{k}/{fld}"] = v.numpy()
    for i, m in enumerate(pending):
        out[f"q/{i}"] = m.numpy()
    return out


def _join(rank: int, world: int, workdir: str):
    import torch

    from repro_torch.launch.mesh import init_process_group
    torch.set_num_threads(1)
    init_process_group(f"file://{workdir}/pg", rank, world, device="cpu",
                       timeout=PG_TIMEOUT)


def _sync_task(rank: int, workdir: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.core import build_gradient_sync
    from repro_torch.core import sync as sync_lib
    from repro_torch.launch.mesh import Mesh

    meshes = {axes: Mesh(shape, axes) for axes, shape in MESHES.items()}
    inp = np.load(os.path.join(workdir, "sync_inputs.npz"))
    lr = torch.tensor(LR, dtype=torch.float32)
    digests = {}
    for name, transport, axes, kw in SYNC_CONFIGS:
        mesh = meshes[axes]
        me = mesh.index(axes)
        sync = build_gradient_sync("rgc", transport=transport,
                                   sync_axes=axes, mesh=mesh,
                                   density=DENSITY, momentum=0.9,
                                   device="cpu", **kw)
        p = {k: torch.from_numpy(inp[f"p/{k}"]) for k in TREE_SIZES}
        st = sync.init(p)
        sums = _record_sums(sync, p) if name == "fused-data" else None
        for t in range(STEPS):
            g = {k: torch.from_numpy(inp[f"g/{k}"][me, t].copy())
                 for k in TREE_SIZES}
            p, st = sync.update(g, st, p, lr)
        arrays = state_arrays(p, st)
        digests[name] = {k: digest(v) for k, v in arrays.items()}
        if rank == 0:
            np.savez(os.path.join(workdir, f"sync_{name}.npz"), **arrays)
            if sums is not None:
                np.savez(os.path.join(workdir, "sync_sums.npz"),
                         **{k: np.stack(v) for k, v in sums.items()})

    # tagged payloads: every rank's message is its global rank
    mesh = meshes[("node", "local")]
    x = torch.full((4,), float(rank))
    joint = sync_lib.sparse_allgather(x, ("node", "local"), mesh)
    hier = sync_lib.hierarchical_allgather(x, ("node",), "local",
                                           ("node", "local"), mesh)
    hier_node = sync_lib.hierarchical_allgather(x, ("local",), "node",
                                                ("node", "local"), mesh)
    swapped = sync_lib.sparse_allgather(x, ("local", "node"), mesh)
    order = {"joint": joint[:, 0].tolist(),
             "swapped": swapped[:, 0].tolist(),
             "hier_equal": bool(torch.equal(joint, hier)),
             "hier_node_equal": bool(torch.equal(joint, hier_node))}
    with open(os.path.join(workdir, f"sync_rank{rank}.json"), "w") as f:
        json.dump({"digests": digests, "order": order}, f)
    dist.barrier()


def _record_sums(sync, params) -> dict[str, list]:
    """Record every decompressed update SUM per sparse leaf and step:
    ``{leaf: [g_sum of step 0, ...]}`` (leaves told apart by size)."""
    names = {int(v.numel()): k for k, v in params.items()}
    sums: dict[str, list] = {}
    for comp in {sync.compressor(n) for n in ("trimmed_topk",
                                              "threshold_bsearch")}:
        def spy(gathered, size, k, f=comp.decompress):
            out = f(gathered, size, k)
            sums.setdefault(names[size], []).append(out.numpy().copy())
            return out
        comp.decompress = spy
    return sums


def _trainer_task(rank: int, workdir: str) -> None:
    import torch.distributed as dist

    from repro_torch import convert
    from repro_torch.configs import paper_lstm
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import bigram_batches
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train.trainer import Trainer

    mesh = Mesh((2,), ("data",))
    inp = dict(np.load(os.path.join(workdir, "trainer_params.npz")))
    out = {}
    for path, kw in TRAINER_PATHS.items():
        tr = Trainer(paper_lstm.smoke(), TrainConfig(**TRAINER_KW, **kw),
                     device="cpu", mesh=mesh)
        state = tr.init_state(params=convert.from_numpy(nest(inp)))
        losses = []
        state = tr.run(state, bigram_batches(
            512, TRAINER_BATCH, TRAINER_SEQ, seed=0), TRAINER_STEPS,
            log_every=0, on_metrics=lambda s, d, loss: losses.append(loss))
        arrays = {k: v.numpy() for k, v in flat(state.params).items()}
        out[path] = {"losses": losses,
                     "digests": {k: digest(v) for k, v in arrays.items()}}
        if rank == 0:
            np.savez(os.path.join(workdir, f"trainer_{path}.npz"), **arrays)
    seeded = Trainer(paper_lstm.smoke(), TrainConfig(**TRAINER_KW),
                     device="cpu", mesh=mesh).init_state()
    out["seeded_init"] = {k: digest(v.numpy())
                          for k, v in flat(seeded.params).items()}
    ck = Trainer(paper_lstm.smoke(),
                 TrainConfig(**TRAINER_KW, schedule="stale1"), device="cpu",
                 mesh=mesh, ckpt_dir=os.path.join(workdir, CKPT_DIR),
                 ckpt_every=CKPT_STEPS)
    state = ck.run(ck.init_state(params=convert.from_numpy(nest(inp))),
                   bigram_batches(512, TRAINER_BATCH, TRAINER_SEQ, seed=0),
                   CKPT_STEPS, log_every=0)
    # a save whose write fails on rank 0 (its directory is a file) must
    # raise on every rank, not leave rank 1 waiting
    bad = Trainer(paper_lstm.smoke(), ck.tc, device="cpu", mesh=mesh,
                  ckpt_dir=os.path.join(workdir, "trainer_params.npz"))
    try:
        bad.save_checkpoint(state)
        out["failed_save"] = None
    except (OSError, RuntimeError) as e:
        out["failed_save"] = f"{type(e).__name__}: {e}"
    with open(os.path.join(workdir, f"trainer_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()


def flat(tree: dict, prefix: str = "") -> dict:
    """Nested dict -> {"a/b": leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def nest(flat_: dict) -> dict:
    """{"a/b": leaf} -> nested dict."""
    out: dict = {}
    for k, v in flat_.items():
        *head, last = k.split("/")
        d = out
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


TASKS = {"sync": _sync_task, "trainer": _trainer_task}


def worker(rank: int, world: int, task: str, workdir: str) -> None:
    try:
        _join(rank, world, workdir)
        TASKS[task](rank, workdir)
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def start(task: str, world: int, workdir: str) -> list:
    """Start ``task`` on ``world`` gloo ranks (the ``spawn`` method);
    ``wait`` on what it returns."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=worker, args=(r, world, task, workdir))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def wait(procs: list, workdir: str, timeout: float = DEADLINE_S) -> None:
    """Join the ranks; raise with the failing ranks' tracebacks unless
    every rank exits 0 within ``timeout`` seconds, one deadline for all
    of them (a hung rank is killed and named)."""
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in hung:
        procs[r].kill()
        procs[r].join()
    bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        errs = []
        for r in bad:
            path = os.path.join(workdir, f"rank{r}.err")
            errs.append(f"rank {r} (exit {procs[r].exitcode}"
                        f"{', hung' if r in hung else ''}):\n"
                        + (open(path).read() if os.path.exists(path)
                           else ""))
        raise RuntimeError("ranks failed:\n" + "\n".join(errs))
