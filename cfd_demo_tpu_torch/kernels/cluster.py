"""The cluster plan of the kernels that hold a scene in a thread-block
cluster (kernels 4, 12 and 20), in pure Python.

The rounds kernel's cluster form (kernels.rounds), the batched Jacobi
solve (kernels.jacobi_batch) and the whole-substep ensemble kernel
(kernels.ensemble) run one thread-block cluster of C CTAs per scene, B
clusters a launch, on csrc/cluster.cuh's machinery. How C CTAs split a
scene is :func:`slab_plan`, the mirror of cluster.cuh's ``slab_plan``;
which C a launch takes is :func:`cluster_ctas`, from how many clusters
of each C the card holds at once (``cudaOccupancyMaxActiveClusters``,
read once per kernel, device and shape by :func:`admitted_clusters`).
It takes only the C whose slabs all hold rows (:func:`tight`) and keep
ar * rhs in shared memory (rhs from L2 and its 6-row strips ran the
8x800x264 solve at 10 µs a sweep, against 2.9 with 4-row strips and rhs
on chip: PERF.md); of those, the least ``waves x (EXCHANGE_ROWS + rows a
thread)``: a batch beyond what the card holds at once runs in waves,
each as long as an exchange's fixed cost and its strip's rows; ties go
to the smaller C (more rows a CTA, fewer CTAs in each exchange).

C takes any value up to 16, not only powers of two: an NVIDIA H100 80GB
HBM3 holds 7 clusters of 16 CTAs of 1024 threads at once, 7 of 14 and 15
of 8 (PERF.md), so 8 scenes of 800x264 take 14 CTAs each (20-row slabs,
two waves, and still the fastest), one 800x264 scene (the rounds kernel)
14 as well, 16 scenes of 256x96 take 6 and 64 take 2, each batch in one
wave.

The route is chosen before the launch: the cluster form where
:func:`pick_ctas` finds a C the card admits, the kernel's other form
where it finds none (a scene no cluster holds, or a card that admits no
such cluster). A forced ``ctas`` may take any C that slab_plan splits
the scene over. A launch or an admission query the card refuses raises,
and never falls back to another form.

The rounds kernel's slab form, for a grid no cluster holds, lays the
same slabs over the whole card, one block an SM: :func:`grid_slab_plan`
mirrors csrc/rounds.cu's, on the card's SM count (:func:`sm_count`,
read once per device).
"""
from __future__ import annotations

import functools

import torch

# csrc/cluster.cuh: threads a CTA, columns at most, CTAs a cluster at
# most, dynamic shared memory a CTA at most, rows a thread (kSlabStrips).
THREADS, MAX_COLS, MAX_CLUSTER, SMEM_BYTES = 1024, 1024, 16, 231424
SLAB_STRIPS = (1, 2, 3, 4, 6)
CTAS = tuple(range(1, MAX_CLUSTER + 1))
# An exchange's fixed cost in strip rows: ~1.4 µs (the barrier, the max's
# round trip) against ~0.54 µs a row of 4 cells, kernel 4's cluster form
# on an NVIDIA H100 80GB HBM3, 700 W (PERF.md).
EXCHANGE_ROWS = 2.6


@functools.cache
def slab_plan(ny: int, nx: int, ctas: int):
    """(rows a thread, rows a slab, ar * rhs in shared memory) of the
    cluster form at ``ctas`` CTAs a scene: the first of SLAB_STRIPS whose
    row groups (1024 threads of 4 columns) cover ceil(ny / ctas) rows,
    slabs of that rounded up to whole strips, p' twice with two halo rows
    in the shared memory, ar * rhs beside it where that fits; None where
    the scene is beyond the form at that size."""
    if nx > MAX_COLS or ny < 3 or nx < 3 or ctas not in CTAS:
        return None
    n4 = -(-nx // 4)
    groups, width = THREADS // n4, 4 * n4
    rows = -(-ny // ctas)
    need = -(-rows // groups)
    rt = next((r for r in SLAB_STRIPS if r >= need), None)
    if rt is None:
        return None
    rp = rt * -(-rows // rt)
    base = (2 * (rp + 2) * width + 2 * MAX_CLUSTER) * 4
    if base > SMEM_BYTES:
        return None
    return rt, rp, base + rp * width * 4 <= SMEM_BYTES


@functools.cache
def grid_slab_plan(ny: int, nx: int, sms: int):
    """(rows a thread, rows a block, blocks, ar * rhs in shared memory)
    of the rounds kernel's slab form (csrc/rounds.cu ``grid_slab_plan``)
    on a card of ``sms`` SMs, one block of 1024 threads an SM: the first
    of SLAB_STRIPS whose row groups cover ceil(ny / sms) rows, slabs of
    that rounded up to whole strips, as many blocks as the slabs, p'
    twice with two halo rows in the shared memory and ar * rhs beside it
    where that fits; None where the grid is beyond the form (nx > 1024,
    or strips of 6 rows short of a block's rows)."""
    if nx > MAX_COLS or ny < 3 or nx < 3 or sms < 1:
        return None
    n4 = -(-nx // 4)
    groups, width = THREADS // n4, 4 * n4
    rows = -(-ny // sms)
    need = -(-rows // groups)
    rt = next((r for r in SLAB_STRIPS if r >= need), None)
    if rt is None:
        return None
    rp = rt * -(-rows // rt)
    base = 2 * (rp + 2) * width * 4
    if base > SMEM_BYTES:
        return None
    return rt, rp, -(-ny // rp), base + rp * width * 4 <= SMEM_BYTES


def sm_count(device) -> int:
    """The SMs of ``device``'s card, read once per device."""
    device = torch.device(device)
    return _sms(torch.cuda.current_device() if device.index is None else device.index)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def tight(ny: int, nx: int, ctas: int) -> bool:
    """Whether slab_plan splits an (ny, nx) scene over ``ctas`` CTAs with
    rows in every one (a slab rounded up to whole strips can leave the
    last CTAs empty)."""
    plan = slab_plan(ny, nx, ctas)
    return plan is not None and -(-ny // plan[1]) == ctas


@functools.cache
def candidates(ny: int, nx: int) -> tuple:
    """The C of CTAS the pick may take for an (ny, nx) scene: slabs with
    rows in every CTA (:func:`tight`) and ar * rhs in shared memory."""
    return tuple(c for c in CTAS if tight(ny, nx, c) and slab_plan(ny, nx, c)[2])


def cluster_fits(ny: int, nx: int) -> bool:
    """Whether the cluster form can take an (ny, nx) scene on a card that
    admits its clusters: some C of :func:`candidates`."""
    return bool(candidates(ny, nx))


def cluster_ctas(batch: int, ny: int, nx: int, admitted: dict):
    """CTAs a scene for a batch of ``batch`` (ny, nx) scenes, given
    ``admitted``: {C: clusters of C CTAs the card holds at once}. Of the
    :func:`candidates` that the card admits, the least ``waves x
    (EXCHANGE_ROWS + rows a thread)``, waves = ceil(batch / admitted[C]),
    and the smaller C of equals; None if there is none."""
    fit = [c for c in candidates(ny, nx) if admitted.get(c, 0) >= 1]
    if not fit:
        return None

    def cost(c):
        return -(-batch // admitted[c]) * (EXCHANGE_ROWS + slab_plan(ny, nx, c)[0]), c

    return min(fit, key=cost)


def admitted_clusters(entry: str, device, ny: int, nx: int, *extra) -> dict:
    """{C: clusters of C CTAs the card holds at once} for each C of
    :func:`candidates`, from the C entry point ``entry`` (its kernel's
    admission, ``cudaOccupancyMaxActiveClusters``; ``extra`` its further
    arguments), read once per entry, device, shape and arguments. Needs
    the card; raises on a CUDA error."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    return _admitted(entry, index, ny, nx, extra)


@functools.cache
def _admitted(entry, index, ny, nx, extra) -> dict:
    from ._build import check, load  # the library builds on first use
    fn, out = getattr(load(), entry), {}
    with torch.cuda.device(index):
        for c in candidates(ny, nx):
            n = fn(ny, nx, c, *extra)
            if n < 0:
                check(-n, f"{entry} at {ny}x{nx}, {c} CTAs")
            out[c] = n
    return out


@functools.cache
def pick_ctas(entry: str, batch: int, ny: int, nx: int, device, *extra):
    """:func:`cluster_ctas` on the card's own admission, kept per entry,
    device, batch and shape (a launch's host cost otherwise): the CTAs a
    scene the cluster form takes, or
    None where it takes no cluster (the kernel's other form then runs).
    Asks the card nothing for a scene no cluster holds."""
    if not cluster_fits(ny, nx):
        return None
    return cluster_ctas(batch, ny, nx, admitted_clusters(entry, device, ny, nx, *extra))


def check_route(what: str, form, cluster_form: str, other_form: str, ny: int, nx: int,
                ctas) -> None:
    """A wrapper's checks of ``form`` and ``ctas`` before any launch, on
    the shape alone: ValueError for a form that is neither None,
    ``cluster_form`` nor ``other_form``, for ``cluster_form`` where no
    cluster holds the scene (:func:`cluster_fits`), and for a ``ctas``
    that slab_plan cannot split the scene over or given with
    ``other_form``."""
    if form not in (None, cluster_form, other_form):
        raise ValueError(f"form must be None, {cluster_form!r} or {other_form!r}, "
                         f"got {form!r}")
    if form == cluster_form and ctas is None and not cluster_fits(ny, nx):
        raise ValueError(f"{what}: the cluster form cannot take a {ny}x{nx} scene, no "
                         f"cluster holds it (kernels.cluster.cluster_fits)")
    if ctas is not None and (form == other_form or slab_plan(ny, nx, ctas) is None):
        raise ValueError(f"{what}: the cluster form cannot split a {ny}x{nx} scene "
                         f"over {ctas} CTAs (slab_plan)")


def route_ctas(what: str, form, other_form: str, batch: int, ny: int, nx: int, ctas,
               entry: str, device, *extra):
    """The CTAs a scene a wrapper launches its cluster form with, or None
    for its other form, after :func:`check_route`: None for
    ``other_form``; else ``ctas`` if given, else :func:`pick_ctas`. The
    cluster form asked for by name raises where the pick finds none."""
    if form == other_form:
        return None
    c = ctas or pick_ctas(entry, batch, ny, nx, device, *extra)
    if c is None and form is not None:
        raise ValueError(f"{what}: the card admits no cluster for a {ny}x{nx} scene "
                         f"(clusters at once by CTAs: "
                         f"{admitted_clusters(entry, device, ny, nx, *extra)})")
    return c
