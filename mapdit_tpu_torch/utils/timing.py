"""Times of one call on a CUDA device, three ways: the device time of CUDA
graph replays, the host time of launching, and the eager time of a
host-launched loop (what a path that launches the call eagerly sees)."""

from __future__ import annotations

import time

import torch


def eager_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """ms a call of ``iters`` calls launched from the host one after
    another, between two events: the larger of the device's time and the
    host's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time of one call: ``iters`` calls captured in a CUDA graph,
    replayed ``replays`` times between two events. A call whose host side
    (checks, allocation, launch) outlasts its kernels is timed by what the
    card does, not by the host's launch rate."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def host_ms(fn, iters: int = 200) -> float:
    """Host time of one call: ``iters`` calls on the host clock with no
    synchronisation between them (the card runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * seconds / iters
