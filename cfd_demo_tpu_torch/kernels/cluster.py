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

The rounds kernel's slab form, for a grid no cluster holds, lays the
same slabs over the whole card, one block an SM: :func:`grid_slab_plan`
mirrors csrc/rounds.cu's, on the card's SM count (:func:`sm_count`,
read once per device).

:func:`plan` decides the form of each launch of the three kernels, and
is the only code that does: it asks the card for its admission and its
SM count, applies the gates (:func:`cluster_fits`, :func:`grid_slab_plan`
and kernel 20's :func:`block_fits`), and checks a caller's ``form`` or
``ctas`` override. The wrappers make one call to it before a launch and
branch on the form it returns; kernel 20's route test
(kernels.ensemble ``substep_batch_takes``) asks whether it returns one.
The choice is made before the launch: a launch or an admission query the
card refuses raises, and never falls back to another form.
"""
from __future__ import annotations

import dataclasses
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
# Kernel 20's block form: shared memory one block may opt in to on the
# H100 (227 KB), and the kernel's 33-float reduction scratch.
SMEM_OPTIN_BYTES = 232_448
BLOCK_SMEM_STATIC = 33 * 4


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


def pick_ctas(entry: str, batch: int, ny: int, nx: int, device, *extra):
    """:func:`cluster_ctas` on the card's own admission: the CTAs a scene
    the cluster form takes, or None where it takes no cluster (the
    kernel's other form then runs). Asks the card nothing for a scene no
    cluster holds."""
    if not cluster_fits(ny, nx):
        return None
    return cluster_ctas(batch, ny, nx, admitted_clusters(entry, device, ny, nx, *extra))


def block_fits(ny: int, nx: int) -> bool:
    """Whether kernel 20's block form takes an (ny, nx) scene: both p'
    buffers in one block's shared memory (up to 29,039 cells)."""
    return nx >= 3 and ny >= 3 and 2 * 4 * ny * nx + BLOCK_SMEM_STATIC <= SMEM_OPTIN_BYTES


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch's form: ``form`` ("cluster", "slab", "cooperative" or
    "block"), ``ctas`` the cluster form's CTAs a scene, ``sms`` and
    ``slab`` the SMs the slab form spreads over and its
    :func:`grid_slab_plan`."""
    form: str
    ctas: int | None = None
    sms: int | None = None
    slab: tuple | None = None


# kernel: (its wrapper, its admission's C entry point, its forms besides
# the cluster form, the last the one that takes what the others do not)
KERNELS = {
    "rounds": ("solve_correct_rounds", "cfd_rounds_cluster_admit", ("slab", "cooperative")),
    "jacobi_batch": ("jacobi_batch", "cfd_jacobi_batch_cluster_admit", ("cooperative",)),
    "substep_batch": ("substep_batch", "cfd_substep_batch_cluster_admit", ("block",)),
}


@functools.cache
def plan(kernel: str, batch: int, ny: int, nx: int, device, *, cavity: bool = False,
         sor: bool = False, form: str | None = None, ctas: int | None = None):
    """The form a launch of ``kernel`` ("rounds": kernel 4; "jacobi_batch":
    kernel 12; "substep_batch": kernel 20, ``sor`` its SOR solve) takes for
    ``batch`` (ny, nx) scenes on ``device``, ``cavity`` kernel 4's CAVITY
    instance: a :class:`Plan`, or None where no form of the kernel takes
    the scenes (kernel 20 beyond its block form's gate, :func:`block_fits`,
    for a SOR solve, a scene no cluster holds, or a card that admits no
    such cluster).

    The cluster form where :func:`pick_ctas` finds a C the card admits;
    else kernel 4's slab form where :func:`grid_slab_plan` takes the grid
    on the card's SMs; else the cooperative form (kernels 4 and 12) or
    the block form (kernel 20 within its gate). On a device that is not a
    card the shapes alone decide, as on a card with room for every
    cluster the shapes allow and an SM a row.

    ``form`` and ``ctas`` override the choice, to hold the forms against
    each other: ``form`` one of the kernel's forms; ``ctas`` the cluster
    form at that C, one that :func:`slab_plan` splits the scene over.
    An override the scenes or the card rule out raises ValueError, before
    any launch; a choice is never a fallback from a failed launch. Kept
    per argument (a launch's host cost otherwise)."""
    what, entry, others = KERNELS[kernel]
    if form not in (None, "cluster", *others):
        raise ValueError(f"{what}: form must be None or one of {('cluster', *others)}, "
                         f"got {form!r}")
    beyond = kernel == "substep_batch" and not block_fits(ny, nx)  # the block form's gate
    if beyond and (sor or form == "block" or not cluster_fits(ny, nx)):
        if form is None and ctas is None:
            return None
        raise ValueError(f"{what}: a {nx}x{ny} scene does not fit one block's shared memory "
                         f"(block_fits); beyond it only the Jacobi cluster form runs, where "
                         f"kernels.cluster.cluster_fits holds the scene")
    if form == "slab" and (ctas is not None or grid_slab_plan(ny, nx, ny) is None):
        raise ValueError(f"{what}: the slab form cannot take a {ny}x{nx} grid"
                         f"{' with ctas' if ctas is not None else ''} "
                         f"(kernels.cluster.grid_slab_plan)")
    if form == "cluster" and ctas is None and not cluster_fits(ny, nx):
        raise ValueError(f"{what}: the cluster form cannot take a {ny}x{nx} scene, no "
                         f"cluster holds it (kernels.cluster.cluster_fits)")
    if ctas is not None:
        if form in others or slab_plan(ny, nx, ctas) is None:
            raise ValueError(f"{what}: the cluster form cannot split a {ny}x{nx} scene "
                             f"over {ctas} CTAs (slab_plan)")
        return Plan("cluster", ctas)
    if form in ("cooperative", "block"):
        return Plan(form)
    card = torch.device(device).type == "cuda"
    extra = {"rounds": (int(cavity),), "substep_batch": (int(sor),)}.get(kernel, ())
    c = None
    if form != "slab" and cluster_fits(ny, nx):
        c = (pick_ctas(entry, batch, ny, nx, device, *extra) if card
             else cluster_ctas(batch, ny, nx, dict.fromkeys(candidates(ny, nx), batch)))
    if c is not None:
        return Plan("cluster", c)
    if form == "cluster" or beyond:
        if form is None:
            return None
        raise ValueError(f"{what}: the card admits no cluster for a {ny}x{nx} scene "
                         f"(clusters at once by CTAs: "
                         f"{admitted_clusters(entry, device, ny, nx, *extra)})")
    if kernel == "rounds":
        sms = sm_count(device) if card else ny
        slab = grid_slab_plan(ny, nx, sms)
        if slab is not None:
            return Plan("slab", sms=sms, slab=slab)
        if form == "slab":
            raise ValueError(f"{what}: the slab form cannot take a {ny}x{nx} grid on {sms} "
                             f"SMs (kernels.cluster.grid_slab_plan)")
    return Plan(others[-1])
