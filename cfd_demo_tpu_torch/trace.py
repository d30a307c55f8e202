"""The port's spans and counters.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler records, and otherwise one flag read and a shared null context:
the ranges land in the profiler's Chrome trace (category
``user_annotation``) on the clock of the device's operations, and cost
nothing else. ``traced(name)`` wraps a function in one. The step's spans
are ``cfd.step``, its phases ``cfd.predict``, ``cfd.solve`` and
``cfd.correct``, and each kernel wrapper's ``cfd.kernel.<function>``;
inside ``cfd.solve``, ``cfd.sor.layout`` marks the colour-split SOR
chain's split of p' and rhs and its join; ``cfd.read`` is each read of
a device value back to the host (:func:`read_host`), wherever it is
made.

``host_reads`` counts the program's reads of CUDA tensors back to the
host (:func:`read_host`; a tolerance exit starts its read with
:func:`read_soon` and queues the next launch before it waits);
``vcycles`` the multigrid V-cycles run;
``sor_iterations`` the red/black iterations the SOR kernel chains ran
(``kernels/sor.py`` ``sor_chain``, ``sor_chain_rb2``: a host int they
already keep, added with no read; the plain ``ops.poisson.sor`` counts
its iterations on the device and is not counted here);
``chain_sweeps`` the sweeps the Jacobi kernel chain ran
(``kernels/jacobi.py`` ``jacobi_chain``, on every schedule: a host int it
already keeps, added with no read); ``outer_rounds`` the outer corrector
rounds the host-read round loops ran (``solver/piso.py``
``_outer_rounds``' early-exit branch and ``piso_substep``'s
``rounds_impl="pallas"`` loop, each a host int they keep; the rounds
kernel's rounds are in ``rounds``, the masked loops' are not counted);
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
chain_sweeps = 0
outer_rounds = 0
rounds: list = []
dropped: list = []


def profiling() -> bool:
    """Whether a profiler records."""
    return _profiler._is_profiler_enabled


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


class Soon:
    """A read that :func:`read_soon` started: the value's pinned host
    copy, the event recorded after the copy was queued, the threshold
    the value is tested against (or None) and the pool the copy and
    event go back to once read."""

    __slots__ = ("host", "event", "at_least", "pool")

    def __init__(self, host: torch.Tensor, event, at_least=None, pool=None):
        self.host, self.event, self.at_least = host, event, at_least
        self.pool = [] if pool is None else pool


# (dtype, device) -> free (pinned 0-d host tensor, event) pairs: a pair
# goes back only after its event has passed, so a copy is never
# overwritten before it is read
_soon_pool: dict = {}


@functools.lru_cache(maxsize=None)
def _rounded(tol: float, dtype) -> float:
    """``tol`` rounded to ``dtype``, as ``t >= tol`` compares on a
    ``dtype`` tensor."""
    return torch.tensor(tol, dtype=dtype).item()


def read_soon(t: torch.Tensor, at_least=None):
    """Start reading a 0-d tensor: on a CUDA device, queue its copy into
    pinned host memory and record an event after it, so that
    :func:`read_host` waits for the work queued before this call and
    not for what the caller queues after it; elsewhere ``t`` itself.
    With ``at_least``, the read gives ``t >= at_least`` (compared in
    ``t``'s dtype: on a CUDA device on the host, after the copy, with no
    comparison queued on the device)."""
    if not t.is_cuda:
        return t if at_least is None else t >= at_least
    pool = _soon_pool.setdefault((t.dtype, t.device), [])
    if pool:
        host, event = pool.pop()
    else:
        host, event = torch.empty((), dtype=t.dtype, pin_memory=True), torch.cuda.Event()
    host.copy_(t, non_blocking=True)
    event.record(torch.cuda.current_stream(t.device))
    return Soon(host, event, None if at_least is None else _rounded(at_least, t.dtype),
                pool)


def read_host(t):
    """``t.item()`` of a 0-d tensor, or the value of a read that
    :func:`read_soon` started once its event has passed, inside a
    ``cfd.read`` span; counted in ``host_reads`` when the value is on a
    CUDA device (a read that waits for the device)."""
    global host_reads
    if isinstance(t, Soon):
        host_reads += 1
        with span("cfd.read"):
            t.event.synchronize()
            value = t.host.item()
        t.pool.append((t.host, t.event))
        return value if t.at_least is None else value >= t.at_least
    if t.is_cuda:
        host_reads += 1
    with span("cfd.read"):
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
