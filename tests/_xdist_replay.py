"""Replay pytest-xdist's ``--dist load`` scheduling with measured test
durations, to see how a change to the collected items moves the wall
time of ``pytest -n 6 --dist load`` (ROADMAP.md's tier-1 command).

The suite's wall time is not its total work over the workers: the load
scheduler hands each worker runs of consecutive tests, and where those
runs cut ``tests/test_property.py``'s long tests decides which worker
finishes last. Items collected after that file move the cuts.

Usage::

    PYTHONPATH=src python -m pytest --collect-only -q | grep :: > order.txt
    python tests/_xdist_replay.py order.txt run.xml [--samples 400]

``run.xml`` is the ``--junitxml`` of a whole run (each item's time);
items it lacks take 0.01 s. Prints the replayed wall time and, with
every duration scaled by a uniform factor in [1 - jitter, 1 + jitter],
the median, the 90th percentile and the share of samples past
``--limit`` seconds. The rules are ``xdist/scheduler/load.py`` of
pytest-xdist 3.8.0: a first run of ``n // workers // 4`` items to each
worker; then, when a worker holds fewer than ``pending // workers // 4``
items (and is not in a test of 0.1 s or more with two items held), a
run that fills it to ``pending // workers // 2``; a worker starts an
item only while it holds a second one, or after shutdown.
"""
from __future__ import annotations

import argparse
import heapq
import random
import xml.etree.ElementTree as ET


def junit_durations(path: str) -> dict[str, float]:
    """Item id (``tests/x.py::name``) -> seconds, from a junit xml."""
    out = {}
    for case in ET.parse(path).getroot().iter("testcase"):
        parts = case.get("classname").split(".")
        node = "/".join(parts[:2]) + ".py"
        out["::".join([node, *parts[2:], case.get("name")])] = float(
            case.get("time"))
    return out


def replay(order: list[str], seconds: dict[str, float],
           workers: int = 6) -> float:
    """The wall time of ``order`` under the load scheduler."""
    pending = list(range(len(order)))
    held = [[] for _ in range(workers)]
    running = [None] * workers
    clock = [0.0] * workers
    shut = [False] * workers
    events = []

    def send(w, count):
        for _ in range(count):
            if pending:
                held[w].append(pending.pop(0))

    def start(w):
        q = held[w]
        if running[w] is None and q and (len(q) >= 2 or shut[w]):
            running[w] = q[0]
            heapq.heappush(events, (clock[w] + seconds.get(order[q[0]],
                                                           0.01), w, q[0]))

    for w in range(workers):
        send(w, max(len(order) // workers // 4, 2))
    for w in range(workers):
        start(w)
    end = 0.0
    while events:
        now, w, item = heapq.heappop(events)
        clock[w], end = now, max(end, now)
        held[w].remove(item)
        running[w] = None
        if pending:
            low = max(2, len(pending) // workers // 4)
            high = max(2, len(pending) // workers // 2)
            long_test = seconds.get(order[item], 0.01) >= 0.1
            if len(held[w]) < low and not (long_test and len(held[w]) >= 2):
                send(w, high - len(held[w]))
        else:
            for v in range(workers):
                shut[v] = True
                if running[v] is None:
                    clock[v] = max(clock[v], now)
                    start(v)
        start(w)
    return end


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("order", help="collected item ids, one a line")
    ap.add_argument("junit", help="junit xml of a whole run")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--samples", type=int, default=400)
    ap.add_argument("--jitter", type=float, default=0.3)
    ap.add_argument("--limit", type=float, default=1470.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    order = [ln.strip() for ln in open(args.order) if "::" in ln]
    seconds = junit_durations(args.junit)
    print(f"replayed wall time {replay(order, seconds, args.workers):.1f} s"
          f" ({len(order)} items, {sum(o in seconds for o in order)} timed)")
    rng = random.Random(args.seed)
    walls = sorted(
        replay(order, {k: v * rng.uniform(1 - args.jitter, 1 + args.jitter)
                       for k, v in seconds.items()}, args.workers)
        for _ in range(args.samples))
    past = sum(w > args.limit for w in walls) / len(walls)
    print(f"jitter {args.jitter}: median {walls[len(walls) // 2]:.1f} s, "
          f"90th percentile {walls[int(0.9 * (len(walls) - 1))]:.1f} s, "
          f"{past:.1%} past {args.limit:.0f} s ({args.samples} samples)")


if __name__ == "__main__":
    main()
