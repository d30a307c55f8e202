"""The measured window: the program's step in a closed loop.

Each step is enqueued as soon as the previous one is, as ``make_run``
and the apps step; nothing waits for the device inside the window except
what the program itself waits for. A CUDA event recorded on the stream
after each step gives the time between consecutive steps, read once the
window has closed. A seeded reservoir keeps a few steps' inputs and
outputs (references to the program's tensors, which a step never
writes) for the check against the plain reference.
"""
from __future__ import annotations

import random
import time

import torch


class Sampler:
    """A uniform sample of ``k`` steps of the window, drawn from the seed
    (reservoir sampling): (index, state before, state after)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.kept = k, random.Random(seed), []

    def offer(self, i: int, before, after):
        if len(self.kept) < self.k:
            self.kept.append((i, before, after))
        else:
            j = self.rng.randrange(i + 1)
            if j < self.k:
                self.kept[j] = (i, before, after)


class Events:
    """Timing events recorded on the current stream, made during set-up
    (the traffic file's ``events_per_s`` times the window's seconds),
    then in blocks if the window outruns them."""

    BLOCK = 1024

    def __init__(self, n: int):
        self.free = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
        self.used = []

    def record(self):
        if not self.free:
            self.free = [torch.cuda.Event(enable_timing=True) for _ in range(self.BLOCK)]
        ev = self.free.pop()
        ev.record()
        self.used.append(ev)

    def intervals_ms(self):
        return [a.elapsed_time(b) for a, b in zip(self.used, self.used[1:])]


def warm_up(step, state, traffic: dict, sync):
    """The traffic's warm-up steps, at least two more than twice the
    check's samples, all kept alive until the last: the caching
    allocator then holds blocks for the states the window's sampler
    keeps, and the window calls no cudaMalloc for them."""
    kept = []
    for _ in range(max(traffic["warmup_steps"], 2 * traffic["check_steps"] + 2)):
        state, _ = step(state)
        kept.append(state)
    sync()
    return state


def run(step, state, sync, *, seconds=None, steps=None, sampler=None, events=None):
    """Step until ``seconds`` of wall time have passed (the step that
    crosses it is the last) or ``steps`` steps have run, then wait for
    the device (``sync``). ``events`` (an Events, on a CUDA card) times
    the steps; without it the host's clock stamps them. Returns (state,
    steps run, wall seconds from the first enqueue to the device's last
    result, the times between consecutive steps in ms)."""
    on_cuda = events is not None
    stamps = []
    sync()
    t0 = time.perf_counter()
    if on_cuda:
        events.record()
    n = 0
    while True:
        new, _ = step(state)
        if sampler is not None:
            sampler.offer(n, state, new)
        state = new
        n += 1
        if on_cuda:
            events.record()
        else:
            stamps.append(time.perf_counter())
        if (seconds is not None and time.perf_counter() - t0 >= seconds) or (
                steps is not None and n >= steps):
            break
    sync()
    wall = time.perf_counter() - t0
    if on_cuda:
        gaps = events.intervals_ms()
    else:
        gaps = [1e3 * (b - a) for a, b in zip([t0] + stamps, stamps)]
    return state, n, wall, gaps
