"""The cluster plan of kernels 4, 12 and 20, on the CPU.

csrc/cluster.cuh splits a scene over C CTAs of one thread-block cluster
(``slab_plan``), and kernels/cluster.py picks C for a batch from how many
clusters of each C the card holds at once (``cluster_ctas``). Both are
pure functions of the shapes and the admission numbers, so they are held
here with made-up admission limits; the kernels themselves are held to
their parent forms bit for bit by tests/test_torch_cuda.py on the card.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import cfd_demo_tpu_torch as tc
from cfd_demo_tpu_torch.kernels import cluster as kcl
from cfd_demo_tpu_torch.kernels import ensemble as kens
from cfd_demo_tpu_torch.kernels import jacobi_batch as kjb
from cfd_demo_tpu_torch.ops.poisson import _apply_pprime_bcs



def gpc_admission(gpcs):
    """{C: clusters of C CTAs a card holds at once}, one CTA of 1024
    threads an SM, for a card whose GPCs (graphics processing clusters,
    which a cluster may not span) have ``gpcs`` SMs: a made-up model."""
    return {c: sum(n // c for n in gpcs) for c in kcl.CTAS}


# 132 SMs in GPCs of 18, 16 and 14: 7 clusters of 16 and 15 of 8 at once,
# as an NVIDIA H100 80GB HBM3 admits them (PERF.md); a card whose GPCs
# hold eight clusters of 16; and a smaller one.
H100_LIKE = gpc_admission((18, 18, 18, 16, 16, 16, 16, 14))
SIXTEEN_BY_8 = gpc_admission((18, 18, 16, 16, 16, 16, 16, 16))
SMALLER = gpc_admission((16,) * 6 + (12, 12))
SHAPES = {"256x96": (96, 256), "800x264": (264, 800)}


def test_the_model_admits_what_the_card_does():
    assert (H100_LIKE[16], H100_LIKE[8], H100_LIKE[2], H100_LIKE[1]) == (7, 15, 66, 132)


@pytest.mark.parametrize("shape,batch,want", [
    ("256x96", 1, 6),      # 16-row slabs, one row a thread: more CTAs buy nothing
    ("256x96", 8, 6),
    ("256x96", 16, 6),     # 96 CTAs at once: the SOR ensemble
    ("256x96", 64, 2),     # 128 CTAs at once, 3-row strips: the Jacobi ensemble
    ("256x96", 132, 2),    # two waves of 3-row strips, not one of 6 rows with rhs in L2
    ("256x96", 256, 2),
    ("800x264", 1, 14),    # 20-row slabs of 4-row strips, rhs on chip
    ("800x264", 8, 14),    # 7 clusters of 14 at once: two waves, still the least
    ("800x264", 16, 14),
    ("800x264", 64, 14),
    ("800x264", 132, 14),
    ("800x264", 256, 14),
])
def test_ctas_h100_like(shape, batch, want):
    ny, nx = SHAPES[shape]
    assert kcl.cluster_ctas(batch, ny, nx, H100_LIKE) == want


@pytest.mark.parametrize("admitted", ["SIXTEEN_BY_8", "THE_CARD"])
@pytest.mark.parametrize("shape,batch,want", [
    ("256x96", 1, 6), ("256x96", 8, 6), ("256x96", 16, 6), ("256x96", 64, 2),
    ("256x96", 132, 2), ("256x96", 256, 2),
    ("800x264", 1, 14), ("800x264", 8, 14), ("800x264", 16, 14), ("800x264", 64, 14),
    ("800x264", 132, 14), ("800x264", 256, 14),
])
def test_ctas_on_other_admissions(admitted, shape, batch, want):
    """A card that holds eight clusters of 16, and the admission an NVIDIA
    H100 80GB HBM3 reported (PERF.md), pick as the model does."""
    ny, nx = SHAPES[shape]
    assert kcl.cluster_ctas(batch, ny, nx, globals()[admitted]) == want


# What an NVIDIA H100 80GB HBM3 (700 W) reported for kernel 20 at 256x96
# (PERF.md), and for 800x264 (9: 9, 11: 7, 14: 7).
THE_CARD = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15, 9: 9, 10: 7, 11: 7,
            12: 7, 14: 7, 16: 7}


@pytest.mark.parametrize("shape,batch,want", [
    ("256x96", 1, 6), ("256x96", 16, 6),
    ("256x96", 64, 3),    # 38 clusters of 3: two waves of 2-row strips beat two of 3 rows
    ("256x96", 132, 2), ("800x264", 8, 14),
])
def test_ctas_on_a_smaller_card(shape, batch, want):
    ny, nx = SHAPES[shape]
    assert kcl.cluster_ctas(batch, ny, nx, SMALLER) == want


def _cost(batch, ny, nx, admitted, c):
    return -(-batch // admitted[c]) * (kcl.EXCHANGE_ROWS + kcl.slab_plan(ny, nx, c)[0])


@pytest.mark.parametrize("admitted", [H100_LIKE, SIXTEEN_BY_8, SMALLER])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("batch", [1, 8, 16, 64, 132, 256])
def test_the_pick_is_the_least_cost(admitted, shape, batch):
    """The pick splits the scene with rows in every CTA and rhs on chip,
    and no other such C the card admits costs less; where such a C holds
    the whole batch at once with strips no longer than the pick's, the
    pick runs in one wave too (B x C within the CTAs the card admits)."""
    ny, nx = SHAPES[shape]
    c = kcl.cluster_ctas(batch, ny, nx, admitted)
    assert kcl.tight(ny, nx, c) and kcl.slab_plan(ny, nx, c)[2]
    fit = [k for k in kcl.candidates(ny, nx) if admitted[k] >= 1]
    for k in fit:
        assert _cost(batch, ny, nx, admitted, c) <= _cost(batch, ny, nx, admitted, k)
    rt = kcl.slab_plan(ny, nx, c)[0]
    if any(batch <= admitted[k] and kcl.slab_plan(ny, nx, k)[0] <= rt for k in fit):
        assert batch * c <= admitted[c] * c


@pytest.mark.parametrize("ny,nx,batch,want", [
    (24, 40, 1, 1),     # a small scene: one CTA of 1024 threads holds it
    (37, 53, 8, 1),
    (96, 256, 1, 6),    # 16 row groups of one row: 16 rows a CTA
    (264, 800, 1, 14),  # 5 row groups of 4 rows: 20 rows a CTA
    (3, 40, 1, 1),
])
def test_min_rows_a_cta(ny, nx, batch, want):
    """Of equal costs the smaller C wins, so a CTA keeps every row group
    busy: at least min(ny, row groups x rows a thread) rows."""
    c = kcl.cluster_ctas(batch, ny, nx, H100_LIKE)
    assert c == want
    rt, rows, _ = kcl.slab_plan(ny, nx, c)
    groups = kcl.THREADS // -(-nx // 4)
    assert rows >= min(ny, groups * rt) or c == 1


@pytest.mark.parametrize("ny,nx,want", [(264, 800, None), (96, 256, 6)])
def test_a_refused_size_is_never_picked(ny, nx, want):
    """A C the card admits no cluster of, or that leaves CTAs without
    rows, is not chosen; with no such C left that keeps rhs on chip the
    pick refuses (800x264: only 14 CTAs split it with rhs on chip), and
    the kernel's other form runs."""
    admitted = {**H100_LIKE, 14: 0, 16: 0}
    assert kcl.cluster_ctas(1, ny, nx, admitted) == want
    assert kcl.cluster_ctas(1, ny, nx, {}) is None
    assert kcl.cluster_ctas(1, ny, nx, {17: 50}) is None
    assert kcl.cluster_ctas(1, 264, 800, {16: 8}) is None  # 16 CTAs leave two empty
    assert kcl.cluster_ctas(1, 264, 800, {9: 8}) is None   # 9 CTAs read rhs from L2


@pytest.mark.parametrize("ny,nx,ctas,plan", [
    (96, 256, 1, (6, 96, False)),    # 16 row groups of 6 rows; rhs from L2
    (96, 256, 2, (3, 48, True)),
    (96, 256, 4, (2, 24, True)),
    (96, 256, 8, (1, 12, True)),
    (96, 256, 16, (1, 6, True)),
    (96, 256, 7, (1, 14, True)),
    (264, 800, 14, (4, 20, True)),   # the rounds kernel's slabs: 5 row groups of 4
    (264, 800, 16, (4, 20, True)),   # 17 rows rounded up to whole strips: 2 CTAs empty
    (264, 800, 9, (6, 30, False)),   # 6 rows a thread, rhs from L2
    (264, 800, 8, None),             # 33 rows: past the strips
    (264, 800, 1, None),
    (37, 53, 16, (1, 3, True)),      # 13 CTAs hold the rows, 3 stay empty
    (16, 1024, 16, (1, 1, True)),    # four row groups of 1024 columns
    (16, 1025, 16, None),            # past the columns
    (2, 40, 1, None),                # fewer than 3 rows
    (40, 40, 17, None),              # more CTAs than a cluster has
])
def test_slab_plan(ny, nx, ctas, plan):
    assert kcl.slab_plan(ny, nx, ctas) == plan


@pytest.mark.parametrize("ny,nx,ctas,tight", [
    (264, 800, 14, True), (264, 800, 16, False), (264, 800, 15, False), (264, 800, 9, True),
    (96, 256, 16, True), (37, 53, 16, False), (37, 53, 13, True), (24, 40, 12, True),
])
def test_tight(ny, nx, ctas, tight):
    assert kcl.tight(ny, nx, ctas) is tight


@pytest.mark.parametrize("ny,nx", [(3, 3), (24, 40), (37, 53), (96, 256), (264, 800),
                                   (321, 800), (120, 240), (28, 1024), (9000, 3)])
@pytest.mark.parametrize("ctas", [1, 2, 3, 4, 7, 8, 9, 14, 16])
def test_slab_plan_holds_the_slab(ny, nx, ctas):
    """Where the plan splits a scene: its row groups cover a slab, the
    slabs cover the scene, and the buffers fit the shared memory; where
    it refuses, the strips of 6 rows cannot cover ceil(ny / C) rows."""
    plan = kcl.slab_plan(ny, nx, ctas)
    n4 = -(-nx // 4)
    if plan is None:
        assert -(-ny // ctas) > 6 * (kcl.THREADS // n4)
        return
    rt, rows, rhs_smem = plan
    assert rt * (kcl.THREADS // n4) >= rows
    assert rows % rt == 0  # whole strips: no strip crosses into the halo row
    assert rows * ctas >= ny > (rows - rt) * ctas
    smem = (2 * (rows + 2) * 4 * n4 + 2 * kcl.MAX_CLUSTER + rows * 4 * n4 * rhs_smem) * 4
    assert smem <= kcl.SMEM_BYTES
    assert rhs_smem == (smem + (1 - rhs_smem) * rows * 4 * n4 * 4 <= kcl.SMEM_BYTES)


@pytest.mark.parametrize("ny,nx,fits", [
    (264, 800, True), (96, 256, True), (321, 800, False), (700, 800, False),
    (28, 1024, True), (12, 1100, False), (9000, 3, True), (257, 1024, False),
])
def test_cluster_fits(ny, nx, fits):
    """The cluster form holds a scene when some C splits it with rows in
    every CTA and rhs on chip (321x800 and 257x1024 only with rhs from
    L2); beyond, kernel 4 and 12 take their cooperative forms and kernel
    20 its block form."""
    assert kcl.cluster_fits(ny, nx) is fits


def test_every_ensemble_scene_the_gate_takes_has_a_cluster_up_to_1024_columns():
    """substep_batch_fits (two p' buffers in one block) admits no scene
    up to 1024 columns that 16 CTAs cannot split."""
    for nx in (3, 4, 17, 64, 256, 511, 800, 1024):
        ny = (kcl.SMEM_OPTIN_BYTES - kcl.BLOCK_SMEM_STATIC) // (8 * nx)
        grid = tc.Grid(nx=nx, ny=ny, lx=1.0, ly=1.0, obstacles=())
        assert kens.substep_batch_fits(grid)
        assert kcl.cluster_fits(ny, nx)


def test_plan_constants_match_the_source():
    """kernels/cluster.py mirrors csrc/cluster.cuh's constants."""
    src = (Path(kcl.__file__).parent.parent / "csrc" / "cluster.cuh").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("kCThreads") == kcl.THREADS
    assert const("kMaxCols") == kcl.MAX_COLS
    assert const("kMaxCluster") == kcl.MAX_CLUSTER
    assert const("kSmemMax") == kcl.SMEM_BYTES
    strips = re.search(r"kSlabStrips\[\] = \{([^}]*)\}", src).group(1)
    assert tuple(int(x) for x in strips.split(",")) == kcl.SLAB_STRIPS


def _batch(shape, seed=1):
    rng = np.random.default_rng(seed)
    pp = _apply_pprime_bcs(torch.from_numpy(0.1 * rng.standard_normal(shape).astype(np.float32)))
    rhs = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return pp, rhs


@pytest.mark.parametrize("kwargs", [{}, {"form": "cooperative"}, {"form": "cluster"},
                                    {"ctas": 1}, {"ctas": 4}])
def test_jacobi_batch_forms_on_the_cpu_are_the_plain_version(kwargs):
    """On CPU tensors every form and C takes the plain version."""
    pp, rhs = _batch((3, 16, 24))
    args = (pp, rhs, 1 / 24, 1 / 16, 0.75, 1e-4, 30)
    got, ref = kjb.jacobi_batch(*args, **kwargs), kjb.jacobi_batch_plain(*args)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kwargs,match", [
    ({"form": "tiled"}, "form must be"),
    ({"form": "cluster", "shape": (2, 16, 1100)}, "no cluster holds"),
    ({"ctas": 17}, "cannot split"),
    ({"ctas": 14, "shape": (2, 264, 800), "form": "cooperative"}, "cannot split"),
    ({"ctas": 8, "shape": (2, 264, 800)}, "cannot split"),
])
def test_jacobi_batch_refuses_before_any_launch(kwargs, match):
    kwargs = dict(kwargs)
    pp, rhs = _batch(kwargs.pop("shape", (3, 16, 24)))
    n = kjb.jacobi_batch.launches
    with pytest.raises(ValueError, match=match):
        kjb.jacobi_batch(pp, rhs, 0.1, 0.1, 0.75, 1e-4, 30, **kwargs)
    assert kjb.jacobi_batch.launches == n


def _ensemble(nx, ny, batch, solver="JACOBI"):
    grid = tc.Grid(nx=nx, ny=ny, lx=3.0 * nx / 40, ly=1.5 * ny / 24,
                   obstacles=(tc.Cylinder(0.9, 0.75, 0.3),))
    scene = tc.make_scene(grid, tc.SimulationParams(
        dt=0.002, viscosity=1e-4, pressure_solver=tc.PressureSolver[solver]),
        tc.solver_options_for(tc.Semantics.RUST, early_exit=False))
    rng = np.random.default_rng(3)
    mk = lambda *shape: torch.from_numpy(0.05 * rng.standard_normal(shape).astype(np.float32))
    u, v, p = mk(batch, ny, nx + 1), mk(batch, ny, nx), mk(batch, ny, nx)
    return (u, v, p, torch.zeros(batch, ny, nx), torch.full((batch,), 0.002),
            torch.logspace(-5, -3, batch), torch.linspace(0.5, 1.5, batch), scene)


@pytest.mark.parametrize("solver", ["JACOBI", "SOR"])
@pytest.mark.parametrize("kwargs", [{"form": "block"}, {"form": "cluster"}, {"ctas": 2}])
def test_substep_batch_forms_on_the_cpu_are_the_plain_version(solver, kwargs):
    args = _ensemble(40, 24, 2, solver)
    got, ref = kens.substep_batch(*args, **kwargs), kens.substep_batch_plain(*args)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kwargs,match", [
    ({"form": "cooperative"}, "form must be"),
    ({"ctas": 0}, "cannot split"),
    ({"ctas": 2, "form": "block"}, "cannot split"),
])
def test_substep_batch_refuses_before_any_launch(kwargs, match):
    args = _ensemble(40, 24, 2)
    n = kens.substep_batch.launches
    with pytest.raises(ValueError, match=match):
        kens.substep_batch(*args, **kwargs)
    assert kens.substep_batch.launches == n


def test_a_wide_ensemble_scene_takes_the_block_form():
    """No cluster holds 1100 columns: the route's rule names the block form
    there, and asking for the cluster form raises."""
    args = _ensemble(1100, 12, 2)
    assert not kcl.cluster_fits(12, 1100)
    with pytest.raises(ValueError, match="no cluster holds"):
        kens.substep_batch(*args, form="cluster")


# The planner's choices, as the route helpers it replaced made them,
# for each shape under each column's (kernel, batch, admission, SMs): "cC"
# the cluster form at C CTAs a scene, "sRT.RP.BLOCKS.RHS" kernel 4's slab
# form with that grid_slab_plan, "co" the cooperative form, "bl" kernel
# 20's block form, "-" no form (the wrapper raises).
NO_14_16 = {**H100_LIKE, 14: 0, 16: 0}
NONE = {}
ONE_EACH = {c: 1 for c in kcl.CTAS}
PLAN_COLUMNS = (
    [("rounds", 1, a, s) for a, s in (("H100_LIKE", 132), ("THE_CARD", 132), ("NONE", 132),
                                      ("NO_14_16", 132), ("ONE_EACH", 114), ("NONE", 114))]
    + [(k, b, a, 132) for k in ("jacobi_batch", "substep_batch")
       for b, a in ((1, "H100_LIKE"), (8, "THE_CARD"), (64, "H100_LIKE"), (64, "SMALLER"),
                    (256, "SIXTEEN_BY_8"), (8, "NONE"))]
    + [("substep_batch_sor", b, a, 132) for b, a in ((16, "THE_CARD"), (8, "NONE"))])
PLAN_TABLE = """
   3    3          c1          c1    s1.1.3.1          c1          c1    s1.1.3.1  c1  c1  c1  c1  c1 co  c1  c1  c1  c1  c1 bl c1 bl
   3   40          c1          c1    s1.1.3.1          c1          c1    s1.1.3.1  c1  c1  c1  c1  c1 co  c1  c1  c1  c1  c1 bl c1 bl
  24   40          c1          c1   s1.1.24.1          c1          c1   s1.1.24.1  c1  c1  c1  c1  c1 co  c1  c1  c1  c1  c1 bl c1 bl
  37   53          c1          c1   s1.1.37.1          c1          c1   s1.1.37.1  c1  c1  c1  c1  c1 co  c1  c1  c1  c1  c1 bl c1 bl
  96  256          c6          c6   s1.1.96.1          c6          c6   s1.1.96.1  c6  c6  c2  c3  c2 co  c6  c6  c2  c3  c2 bl c6 bl
 120  241          c8          c8  s1.1.120.1          c8          c8   s1.2.60.1  c8  c8  c2  c3  c2 co  c8  c8  c2  c3  c2 bl c4 bl
 120  242          c8          c8  s1.1.120.1          c8          c8   s1.2.60.1  c8  c8  c2  c3  c2 co  c8  c8  c2  c3  c2  -  -  -
 132  400         c14         c14  s1.1.132.1         c15         c14   s1.2.66.1 c14  c7  c5  c5  c4 co c14  c7  c5  c5  c4  -  -  -
 165  500         c11         c11   s1.2.83.1         c11         c11   s1.2.83.1 c11  c7  c7  c5  c7 co c11  c7  c7  c5  c7  -  -  -
 198  600         c11         c11   s1.2.99.1         c11         c11   s1.2.99.1 c11  c9  c7  c7  c7 co c11  c9  c7  c7  c7  -  -  -
 231  700         c16         c16  s1.2.116.1         c12         c16   s1.3.77.1 c16 c16 c12 c12 c16 co c16 c16 c12 c12 c16  -  -  -
 264  800         c14         c14  s1.2.132.1  s1.2.132.1         c14   s1.3.88.1 c14 c14 c14 c14 c14 co c14 c14 c14 c14 c14  -  -  -
 320  800         c16         c16  s1.3.107.1  s1.3.107.1         c16  s1.3.107.1 c16 c16 c16 c16 c16 co c16 c16 c16 c16 c16  -  -  -
 321  800  s1.3.107.1  s1.3.107.1  s1.3.107.1  s1.3.107.1  s1.3.107.1  s1.3.107.1  co  co  co  co  co co   -   -   -   -   -  -  -  -
 700  800  s2.6.117.1  s2.6.117.1  s2.6.117.1  s2.6.117.1   s2.8.88.1   s2.8.88.1  co  co  co  co  co co   -   -   -   -   -  -  -  -
  16 1024          c4          c4   s1.1.16.1          c4          c4   s1.1.16.1  c4  c4  c2  c1  c1 co  c4  c4  c2  c1  c1 bl c4 bl
  28 1024          c7          c7   s1.1.28.1          c7          c7   s1.1.28.1  c7  c7  c2  c3  c2 co  c7  c7  c2  c3  c2 bl c4 bl
 256 1024         c16         c16  s1.2.128.1  s1.2.128.1         c16   s1.3.86.1 c16 c16 c16 c16 c16 co c16 c16 c16 c16 c16  -  -  -
 257 1024  s1.2.129.1  s1.2.129.1  s1.2.129.1  s1.2.129.1   s1.3.86.1   s1.3.86.1  co  co  co  co  co co   -   -   -   -   -  -  -  -
 512  512         c16         c16  s1.4.128.1         c15         c16  s1.5.103.1 c16 c16 c16 c16 c16 co c16 c16 c16 c16 c16  -  -  -
 512 1024  s1.4.128.1  s1.4.128.1  s1.4.128.1  s1.4.128.1   s2.6.86.1   s2.6.86.1  co  co  co  co  co co   -   -   -   -   -  -  -  -
1001 1024  s2.8.126.1  s2.8.126.1  s2.8.126.1  s2.8.126.1  s3.9.112.1  s3.9.112.1  co  co  co  co  co co   -   -   -   -   -  -  -  -
1024 1024  s2.8.128.1  s2.8.128.1  s2.8.128.1  s2.8.128.1  s3.9.114.1  s3.9.114.1  co  co  co  co  co co   -   -   -   -   -  -  -  -
1320 1024 s3.12.110.1 s3.12.110.1 s3.12.110.1 s3.12.110.1 s3.12.110.1 s3.12.110.1  co  co  co  co  co co   -   -   -   -   -  -  -  -
2000 1024 s4.16.125.1 s4.16.125.1 s4.16.125.1 s4.16.125.1 s6.18.112.0 s6.18.112.0  co  co  co  co  co co   -   -   -   -   -  -  -  -
3000 1024 s6.24.125.0 s6.24.125.0 s6.24.125.0 s6.24.125.0          co          co  co  co  co  co  co co   -   -   -   -   -  -  -  -
3169 1024          co          co          co          co          co          co  co  co  co  co  co co   -   -   -   -   -  -  -  -
9000    3          c9          c9 s1.69.131.1          c9          c9 s1.79.114.1  c9  c9  c2  c3  c2 co  c9  c9  c2  c3  c2 bl c5 bl
  12 1100          co          co          co          co          co          co  co  co  co  co  co co  bl  bl  bl  bl  bl bl bl bl
  30 1100          co          co          co          co          co          co  co  co  co  co  co co   -   -   -   -   -  -  -  -
 512 1100          co          co          co          co          co          co  co  co  co  co  co co   -   -   -   -   -  -  -  -
  24 2048          co          co          co          co          co          co  co  co  co  co  co co   -   -   -   -   -  -  -  -
2048 2048          co          co          co          co          co          co  co  co  co  co  co co   -   -   -   -   -  -  -  -
"""


def _token(route):
    """A Plan as PLAN_TABLE writes it."""
    if route is None:
        return "-"
    if route.form == "slab":
        return "s" + ".".join(str(int(x)) for x in route.slab)
    return {"cluster": f"c{route.ctas}", "cooperative": "co", "block": "bl"}[route.form]


@pytest.fixture
def fake_card(monkeypatch):
    """kernels.cluster asking a made-up card: ``set(admitted, sms)`` makes
    its admission ``admitted`` (a dict, as gpc_admission gives) and its SM
    count ``sms``; the plan's cache is cleared around each."""
    def set_card(admitted, sms):
        kcl.plan.cache_clear()
        monkeypatch.setattr(kcl, "admitted_clusters", lambda entry, device, ny, nx, *extra: {
            c: admitted.get(c, 0) for c in kcl.candidates(ny, nx)})
        monkeypatch.setattr(kcl, "sm_count", lambda device: sms)
    yield set_card
    kcl.plan.cache_clear()


CARD = torch.device("cuda", 0)


@pytest.mark.parametrize("line", PLAN_TABLE.strip().splitlines(),
                         ids=lambda line: "x".join(line.split()[:2]))
def test_plan_table(fake_card, line):
    """kernels.cluster.plan chooses for every shape, kernel, batch,
    admission and SM count what the route helpers it replaced chose
    (kernel 4's choice for its CAVITY instance too), the benchmark's
    shapes among them: 264x800 the cluster form at 14 CTAs for one scene
    and for 8, 1024x1024 the slab form of 8-row blocks, wider than 1024
    columns the cooperative form."""
    ny, nx, *want = line.split()
    ny, nx = int(ny), int(nx)
    got, cavity_got = [], []
    for kernel, batch, admitted, sms in PLAN_COLUMNS:
        fake_card(globals()[admitted], sms)
        sor = kernel == "substep_batch_sor"
        got.append(_token(kcl.plan(kernel.removesuffix("_sor"), batch, ny, nx, CARD, sor=sor)))
        if kernel == "rounds":
            cavity_got.append(_token(kcl.plan(kernel, 1, ny, nx, CARD, cavity=True)))
    assert got == want
    assert cavity_got == want[:len(cavity_got)]
