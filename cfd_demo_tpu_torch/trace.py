"""The port's spans and counters.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler records, and otherwise one flag read and a shared null context:
the ranges land in the profiler's Chrome trace (category
``user_annotation``) on the clock of the device's operations, and cost
nothing else. ``traced(name)`` wraps a function in one. The step's spans
are ``cfd.step``, its phases ``cfd.predict``, ``cfd.solve`` and
``cfd.correct``, and each kernel wrapper's ``cfd.kernel.<function>``;
inside ``cfd.solve``, ``cfd.sor.layout`` marks the colour-split SOR
chain's split of p' and rhs and its join.

``host_reads`` counts the program's reads of CUDA tensors back to the
host (:func:`read_host`); ``vcycles`` the multigrid V-cycles run;
``sor_iterations`` the red/black iterations the SOR kernel chains ran
(``kernels/sor.py`` ``sor_chain``, ``sor_chain_rb2``: a host int they
already keep, added with no read; the plain ``ops.poisson.sor`` counts
its iterations on the device and is not counted here);
``rounds`` keeps, while a profiler records, the (outer rounds, sweeps)
count tensor each single-scene ``piso._substep_jnp`` returns
(:func:`keep_rounds`); a reader takes its window's out of the list and
sums them after the window (:func:`rounds_total`). ``dropped`` keeps
the same way the count of speculative sweeps each launch of the rounds
kernel's slab form dropped, an int32 (1,) tensor the kernel writes
(:func:`keep_dropped`, :func:`dropped_total`); ``counts`` leaves them out.
"""
from __future__ import annotations

import contextlib
import functools

import torch
import torch.autograd.profiler as _profiler

_NULL = contextlib.nullcontext()
host_reads = 0
vcycles = 0
sor_iterations = 0
rounds: list = []
dropped: list = []


def span(name: str):
    """A profiler range named ``name`` while a profiler records, else
    a null context."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return torch.profiler.record_function(name)


def traced(name: str):
    """Decorator: each call of the function inside ``span(name)``. The
    wrapper carries the function's name, module and attributes."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def read_host(t: torch.Tensor):
    """``t.item()`` of a 0-d tensor, counted in ``host_reads`` when
    ``t`` is on a CUDA device (a read that waits for the device)."""
    global host_reads
    if t.is_cuda:
        host_reads += 1
    return t.item()


def keep_rounds(counts: torch.Tensor):
    """Keep ``counts`` (an int32 (2,) tensor: outer rounds, sweeps) in
    ``rounds`` while a profiler records: a reference, no device
    operation and no read."""
    if _profiler._is_profiler_enabled:
        rounds.append(counts)


def rounds_total(kept) -> tuple:
    """(outer rounds, sweeps) summed over the count tensors ``kept`` (a
    slice of ``rounds``): one read of the device, made by the caller
    after its window; (0, 0) for none."""
    if not kept:
        return 0, 0
    return tuple(torch.stack(list(kept)).to(torch.int64).sum(dim=0).tolist())


def keep_dropped(count: torch.Tensor):
    """Keep ``count`` (an int32 (1,) tensor: the speculative sweeps a
    launch of the rounds kernel's slab form dropped) in ``dropped``
    while a profiler records: a reference, no device operation and no
    read."""
    if _profiler._is_profiler_enabled:
        dropped.append(count)


def dropped_total(kept) -> int:
    """The dropped sweeps summed over the count tensors ``kept`` (a
    slice of ``dropped``): one read of the device, made by the caller
    after its window; 0 for none."""
    if not kept:
        return 0
    return int(torch.cat(list(kept)).to(torch.int64).sum())
