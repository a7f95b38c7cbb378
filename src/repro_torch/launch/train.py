"""Training launcher (port of ``src/repro/launch/train.py``, minimal).

Runs the paper's LSTM LM with RGC on one device, CUDA by default:

  PYTHONPATH=src python -m repro_torch.launch.train --arch paper-lstm \
      --steps 20 --batch 20 --seq 35
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper-lstm \
      --smoke --steps 6 --batch 2 --seq 16 --density 0.02 --device cpu

``--profile N`` trains N more steps under ``torch.profiler`` and prints
the device time by kernel and the device's busy share of those steps.
"""
from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=["paper-lstm"], required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.2)
    ap.add_argument("--optimizer", default="rgc",
                    help="rgc | dense | a registered compressor spec, "
                    "e.g. threshold_bsearch")
    ap.add_argument("--density", type=float, default=0.01)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the "
                    "plain PyTorch path)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="after --steps, profile N more steps and print "
                    "where their device time goes")
    args = ap.parse_args(argv)

    from repro_torch.configs import paper_lstm
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.synthetic import bigram_batches
    from repro_torch.train.trainer import Trainer

    cfg = paper_lstm.smoke() if args.smoke else paper_lstm.FULL
    tc = TrainConfig(lr=args.lr, optimizer=args.optimizer,
                     density=args.density)
    trainer = Trainer(cfg, tc, device=args.device)
    state = trainer.init_state()
    n = sum(p.numel() for p in trainer.model.parameters())
    print(f"arch={cfg.name} params={n:,} optimizer={args.optimizer} "
          f"density={args.density} device={trainer.device}")
    batches = bigram_batches(cfg.vocab_size, args.batch, args.seq,
                             seed=tc.seed)
    state = trainer.run(state, batches, args.steps,
                        log_every=args.log_every)
    if args.profile:
        profile_steps(trainer, state, batches, args.profile)


def profile_steps(trainer, state, batches, n: int) -> None:
    """Run ``n`` steps under ``torch.profiler``; print device time per
    kernel (top 15) and the device's busy share of the steps' wall time."""
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
    for e in events[:15]:
        print(f"profile: {e.self_device_time_total / 1e3 / n:10.3f} ms/step "
              f"{e.count / n:7.1f} calls/step  {e.key[:90]}")


if __name__ == "__main__":
    main()
