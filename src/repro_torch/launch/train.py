"""Training launcher (port of ``src/repro/launch/train.py``).

Trains a registry model with RGC, CUDA by default: ``--arch`` is the
paper's LSTM LM (``paper-lstm``) or one of the transformer configs
ported so far (``internlm2-1.8b``, ``qwen3-32b``, ``h2o-danube-3-4b``,
``gemma3-4b``, ``paligemma-3b``; ``--smoke`` for the reduced width). It
runs on one device, or data parallel over ``--mesh D`` (or ``Dx1``)
ranks started by ``torchrun``, whose environment gives the rank, world
size and address. ``--batch`` is the GLOBAL batch, split over the ranks
as in JAX:

  PYTHONPATH=src python -m repro_torch.launch.train --arch paper-lstm \
      --steps 20 --batch 20 --seq 35
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper-lstm \
      --smoke --steps 6 --batch 2 --seq 16 --density 0.02 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper-lstm \
      --steps 20 --batch 20 --seq 35 --optimizer sampled_bsearch
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper-lstm \
      --steps 20 --batch 20 --seq 35 --no-fuse-leaves \
      [--optimizer trimmed_topk]
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper-lstm \
      --steps 20 --batch 20 --seq 35 --optimizer rgc_quant
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper-lstm \
      --steps 20 --batch 20 --seq 35 --optimizer "warmup(rgc)" \
      --warmup-steps-per-stage 5
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper-lstm \
      --steps 20 --batch 20 --seq 35 --schedule "staleK(k=2)"
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
      --arch paper-lstm --smoke --mesh 2 --device cpu --steps 6 \
      --batch 4 --seq 16 --density 0.02 [--transport per_leaf_allgather]
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper-lstm \
      --steps 4 --batch 20 --seq 35 --ckpt-dir ckpt --ckpt-every 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper-lstm \
      --steps 6 --batch 20 --seq 35 --ckpt-dir ckpt --resume
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
      --steps 4 --batch 2 --seq 4096 --data zipf --density 0.001
  PYTHONPATH=src python -m repro_torch.launch.train --arch paligemma-3b \
      --smoke --steps 2 --batch 2 --seq 32 --data zipf --device cpu

On a mesh the backend is ``nccl`` on the card (one rank per card:
``cuda:LOCAL_RANK``) and ``gloo`` on the CPU. The two-axis
``("node", "local")`` mesh is reached through ``launch.mesh`` and
``Trainer(mesh=...)``, as in the JAX harness.

``--data`` picks the seeded stream (``bigram``: the learnable chain,
``zipf``: ``SyntheticLM``). ``bigram`` draws a dense ``vocab x vocab``
float64 transition matrix, 68 GB at vocab 92,544, so the transformer
configs at full width take ``--data zipf``. A vlm config (paligemma)
gets the reference's stub patch embeddings, one seeded batch of them
attached to every batch as ``prefix_embeds``. ``--ckpt-dir`` /
``--ckpt-every N`` save a checkpoint chain every N steps and at the end;
``--resume`` restores the latest one (bitwise at the same worker count,
redistributed at another) and replays the stream to its step, so
``--steps`` counts from step 0.

``--profile N`` trains N more steps under ``torch.profiler`` and prints
the device time by kernel and the device's busy share of those steps.
"""
from __future__ import annotations

import argparse


def _mesh_from_env(spec: str, device):
    """Join the process group ``torchrun`` describes and build the
    ``("data",)`` mesh of ``--mesh D`` / ``Dx1``. Returns (mesh, device)."""
    import os

    from repro_torch.launch.mesh import Mesh, init_process_group
    d, _, m = spec.partition("x")
    if m and int(m) != 1:
        raise NotImplementedError(
            f"--mesh {spec}: a model axis > 1 is not ported yet "
            f"(see ROADMAP.md)")
    env = os.environ
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    if device is None:
        device = f"cuda:{env.get('LOCAL_RANK', '0')}"
    dev = init_process_group(
        f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}", rank, world,
        device=device)
    return Mesh((int(d),), ("data",)), dev


def main(argv: list[str] | None = None) -> None:
    from repro_torch.configs import ARCH_IDS
    from repro_torch.core import registry

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=["paper-lstm", *ARCH_IDS],
                    required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.2)
    ap.add_argument("--optimizer", default="rgc",
                    help="rgc | rgc_quant | dense | a registered "
                    "compressor spec, e.g. threshold_bsearch or "
                    "'quantized(trimmed_topk)', optionally prefixed by "
                    "corrections: 'factor_masking+warmup(rgc)', "
                    "'momentum+clip(threshold_bsearch)'")
    ap.add_argument("--transport", default="fused_allgather",
                    choices=list(registry.names(registry.TRANSPORT)))
    ap.add_argument("--bucket-bytes", type=int, default=None,
                    help="bucketed_allgather: byte budget per fused "
                    "collective bucket (default 4 MiB)")
    ap.add_argument("--mesh", default=None,
                    help="D or Dx1: data parallel over D ranks started "
                    "by torchrun (default: one device)")
    ap.add_argument("--no-fuse-leaves", action="store_true",
                    help="disable the flat residual arenas (per-leaf "
                    "mask/select/pack baseline)")
    ap.add_argument("--schedule", default="sequential",
                    help="§5.6 overlap schedule spec: sequential (one "
                    "full-tree transport barrier), chunked (one collective "
                    "per chunk of --bucket-bytes in reverse parameter "
                    "order, bitwise sequential), stale1 (one-step-delayed "
                    "double-buffered sync), or 'staleK(k=4)' (K-step-"
                    "delayed ring)")
    ap.add_argument("--density", type=float, default=0.01)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--warmup-steps-per-stage", type=int, default=0,
                    help="§5.7 density ramp: steps per warm-up stage "
                    "(0: none, or 25 under a 'warmup(...)' spec)")
    ap.add_argument("--data", default="bigram", choices=["bigram", "zipf"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save a fault-tolerance checkpoint (full + "
                    "sparse-delta chain) every N steps into --ckpt-dir")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in "
                    "--ckpt-dir (bitwise at the same worker count; "
                    "elastic remainder-rule redistribution otherwise)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the "
                    "plain PyTorch path)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="after --steps, profile N more steps and print "
                    "where their device time goes")
    args = ap.parse_args(argv)

    # the schedule grammar is free-form, so argparse choices cannot check
    # it: an unknown name or a malformed spec fails here, before any work
    from repro_torch.core.overlap import make_schedule
    make_schedule(args.schedule)
    if args.resume and not args.ckpt_dir:
        raise SystemExit("--resume requires --ckpt-dir")

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import tree
    from repro_torch.data.synthetic import SyntheticLM, bigram_batches
    from repro_torch.train.trainer import Trainer

    cfg = get_config(args.arch, smoke=args.smoke)
    tc = TrainConfig(lr=args.lr, momentum=args.momentum,
                     optimizer=args.optimizer, transport=args.transport,
                     schedule=args.schedule, density=args.density,
                     warmup_steps_per_stage=args.warmup_steps_per_stage,
                     fuse_leaves=not args.no_fuse_leaves)
    if args.bucket_bytes is not None:
        import dataclasses
        tc = dataclasses.replace(tc, bucket_bytes=args.bucket_bytes)
    mesh, device, kw = None, args.device, {}
    if args.mesh:
        mesh, device = _mesh_from_env(args.mesh, args.device)
        kw["mesh"] = mesh
    if args.ckpt_dir:
        kw.update(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    trainer = Trainer(cfg, tc, device=device, **kw)
    if args.resume:
        state = trainer.restore_checkpoint()
        if mesh is None or mesh.rank == 0:
            print(f"resumed from step {state.step} in {args.ckpt_dir}")
    else:
        state = trainer.init_state()
    n = sum(p.numel() for p in tree.flatten(state.params)[0])
    if mesh is not None and mesh.rank != 0:
        args.log_every = 0      # rank 0 reports the (rank-mean) loss
    else:
        print(f"arch={cfg.name} params={n:,} optimizer={args.optimizer} "
              f"density={args.density} fuse_leaves={tc.fuse_leaves} "
              f"transport={tc.transport} schedule={tc.schedule} "
              f"mesh={mesh or 'single-device'} "
              f"device={trainer.device}")
    if args.data == "bigram":
        batches = bigram_batches(cfg.vocab_size, args.batch, args.seq,
                                 seed=tc.seed)
    else:
        batches = iter(SyntheticLM(cfg.vocab_size, args.batch, args.seq,
                                   seed=tc.seed))
    if cfg.family == "vlm":
        batches = _with_stub(batches, trainer.model.make_train_batch(
            args.batch, args.seq))
    for _ in range(state.step):             # deterministic batch replay
        next(batches)
    # hand the state over without keeping a reference: held here, the
    # initial state would outlive the first step beside the current one
    # (at internlm2-1.8b's full width, 17.6 GiB of params, residual and
    # velocity more than the card has room for)
    box, steps = [state], max(0, args.steps - state.step)
    del state
    state = trainer.run(box.pop(), batches, steps, log_every=args.log_every)
    if args.profile:
        profile_steps(trainer, state, batches, args.profile)
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()


def _with_stub(src, stub: dict):
    """Attach the modality stub (every key of ``stub`` but the tokens) to
    each batch of ``src``, as the reference's launcher does."""
    extra = {k: v for k, v in stub.items() if k != "tokens"}
    for b in src:
        yield {**b, **extra}


def profile_steps(trainer, state, batches, n: int) -> None:
    """Run ``n`` steps under ``torch.profiler``; print device time per
    kernel (the top 15, then every other kernel in an anonymous
    namespace, which holds all of ``kernels/csrc`` and a few of
    PyTorch's) and the device's busy share of the steps' wall time."""
    import re
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = trainer.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        trainer.run(state, batches, n, log_every=0)
        sync()
        wall = time.perf_counter() - t0
    # kernel rows only: operator rows repeat their kernels' device time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    events.sort(key=lambda e: -e.self_device_time_total)
    print(f"profile: {n} steps, wall {wall * 1e3:.2f} ms, device busy "
          f"{busy * 1e3:.2f} ms ({busy / wall:.1%}), idle "
          f"{1 - busy / wall:.1%}")
    for i, e in enumerate(events):
        if i < 15 or re.match(r"(void )?\(anonymous namespace\)::", e.key):
            print(f"profile: {e.self_device_time_total / 1e3 / n:10.3f} "
                  f"ms/step {e.count / n:7.1f} calls/step  {e.key[:90]}")


if __name__ == "__main__":
    main()
