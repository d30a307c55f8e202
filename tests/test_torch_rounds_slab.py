"""Kernel 4's slab form, on the CPU: its plan and its route.

Where no thread-block cluster holds a grid (1024², 1024x512), the rounds
kernel runs its slab form (csrc/rounds.cu ``rounds_slab_kernel``): the
cluster form's slabs in shared memory spread over the whole card, one
block an SM, the edge rows through device memory under each block's
edge flags and the max read one sweep late, with no grid barrier a
sweep. How it splits a grid is ``grid_slab_plan``, a pure function of
(ny, nx, SMs) that kernels/cluster.py mirrors; which form a grid takes
is kernels/cluster.py ``plan``'s, here on a made-up card. Both are held
here; the kernel itself is held to the cooperative form bit for bit by
tests/test_torch_cuda.py on the card.
"""
import re
from pathlib import Path

import pytest
import torch

import cfd_demo_tpu_torch as tc
from cfd_demo_tpu_torch.kernels import cluster as kcl
from cfd_demo_tpu_torch.kernels import rounds as krounds
from test_torch_ensemble_plan import CARD, fake_card  # noqa: F401 (a fixture)

H100_SMS = 132
# every cluster size admitted: the pick then takes any C the plan offers
ANY_CLUSTER = {c: 1 for c in kcl.CTAS}


@pytest.mark.parametrize("ny,nx,sms,plan", [
    (1024, 1024, H100_SMS, (2, 8, 128, True)),   # the cavity cell: 8-row slabs of 2-row strips
    (512, 1024, H100_SMS, (1, 4, 128, True)),    # chip_smoke's 1024x512 channel
    (264, 800, H100_SMS, (1, 2, 132, True)),     # the default scene: 2 rows a block
    (132, 400, H100_SMS, (1, 1, 132, True)),
    (1001, 1024, H100_SMS, (2, 8, 126, True)),   # an odd row count: the last slab 1 row
    (37, 53, H100_SMS, (1, 1, 37, True)),
    (1320, 1024, H100_SMS, (3, 12, 110, True)),
    (2000, 1024, H100_SMS, (4, 16, 125, True)),  # the buffers just inside the shared memory
    (3000, 1024, H100_SMS, (6, 24, 125, False)), # 6-row strips, rhs from L2
    (3169, 1024, H100_SMS, None),                # 25 rows a block: past the strips
    (1024, 1024, 114, (3, 9, 114, True)),        # a card of 114 SMs
    (16, 1100, H100_SMS, None),                  # past the columns
    (2, 40, H100_SMS, None),                     # fewer than 3 rows
    (40, 40, 0, None),
])
def test_grid_slab_plan(ny, nx, sms, plan):
    """(rows a thread, rows a block, blocks, ar * rhs in shared memory)."""
    assert kcl.grid_slab_plan(ny, nx, sms) == plan


@pytest.mark.parametrize("ny,nx", [(3, 3), (24, 40), (37, 53), (264, 800), (512, 1024),
                                   (1001, 1024), (1024, 1024), (2047, 2), (3000, 1024),
                                   (2500, 700), (9000, 3), (5000, 260)])
@pytest.mark.parametrize("sms", [1, 8, 78, 114, 132])
def test_grid_slab_plan_holds_the_grid(ny, nx, sms):
    """Where the plan takes a grid: at most one block an SM, whole strips
    a slab, the row groups cover a slab, the slabs cover the grid with
    rows in every block, and the buffers fit the shared memory; where it
    refuses, the columns are too many or 6-row strips cannot cover
    ceil(ny / SMs) rows."""
    plan = kcl.grid_slab_plan(ny, nx, sms)
    n4 = -(-nx // 4)
    if plan is None:
        assert nx < 3 or nx > kcl.MAX_COLS or -(-ny // sms) > 6 * (kcl.THREADS // n4)
        return
    rt, rows, blocks, rhs_smem = plan
    assert blocks <= sms and rt in kcl.SLAB_STRIPS
    assert rows % rt == 0 and rt * (kcl.THREADS // n4) >= rows
    assert rows * blocks >= ny > rows * (blocks - 1)
    base = 2 * (rows + 2) * 4 * n4 * 4
    assert base <= kcl.SMEM_BYTES
    assert rhs_smem == (base + rows * 4 * n4 * 4 <= kcl.SMEM_BYTES)
    # the fewest whole-strip rows that keep the blocks within the SMs
    assert rows - rt < -(-ny // sms)


def _function(src: str, name: str) -> str:
    """The body of the C++ function ``name`` in ``src``, up to the first
    line that closes it."""
    start = re.search(rf"\b{name}\(int ny, int nx, int \w+\) \{{", src).end()
    return src[start:src.index("\n}\n", start)]


def test_plan_mirrors_the_source():
    """kernels/cluster.py grid_slab_plan mirrors csrc/rounds.cu's: the
    same constants (cluster.cuh's, which test_plan_constants_match_the_source
    holds to kernels/cluster.py), the same shared-memory sums, and the
    wrapper's halo and handoff buffers are the sizes the entry point
    requires."""
    csrc = Path(kcl.__file__).parent.parent / "csrc"
    body = re.sub(r"\s+", " ", _function((csrc / "rounds.cu").read_text(), "grid_slab_plan"))
    for name in ("kMaxCols", "kCThreads", "kSlabStrips", "kSmemMax"):
        assert name in body, name
    assert "const int rows = (ny + sms - 1) / sms" in body
    assert "const size_t base = 2 * (size_t)(rp + 2) * P * sizeof(float);" in body
    assert "const size_t with_rhs = base + (size_t)rp * P * sizeof(float);" in body
    assert "(ny + rp - 1) / rp" in body
    entry = (csrc / "rounds.cu").read_text()
    assert "halo_n < 4LL * pl.blocks * ((nx + 3) & ~3)" in entry
    wrapper = Path(krounds.__file__).read_text()
    assert "torch.empty(4 * route.slab[2] * 4 * -(-nx // 4)" in wrapper
    assert "sync_n < handoff_ints(pl.blocks)" in entry
    assert "(long long)kLineInts * (3 + 2 * blocks)" in entry
    assert "constexpr int kLineInts = 32;" in entry
    assert "torch.empty(32 * (3 + 2 * route.slab[2]), dtype=torch.int32" in wrapper


@pytest.mark.parametrize("ny,nx,form", [
    (264, 800, "cluster"),      # the default scene: 14 CTAs
    (132, 400, "cluster"),
    (512, 512, "cluster"),
    (1024, 1024, "slab"),       # the cavity cell: no cluster holds it
    (512, 1024, "slab"),
    (321, 800, "slab"),         # one row past 16 CTAs' strips
    (3000, 1024, "slab"),
    (3169, 1024, "cooperative"),  # past 132 SMs' 6-row strips
    (512, 1100, "cooperative"),   # past 1024 columns
    (24, 2048, "cooperative"),
])
def test_route_on_shapes_alone(fake_card, ny, nx, form):
    """The cluster form where the pick finds a cluster, else the slab form
    where its plan takes the grid on the card's SMs, else the cooperative
    form (kernels.cluster.plan, on a card that admits every cluster)."""
    fake_card(ANY_CLUSTER, H100_SMS)
    assert kcl.plan("rounds", 1, ny, nx, CARD).form == form


@pytest.mark.parametrize("ny,nx,admitted,sms,form", [
    (264, 800, {}, H100_SMS, "slab"),
    (3000, 1024, {}, H100_SMS, "slab"),
    (3000, 1024, {}, 114, "cooperative"),
])
def test_route_follows_the_card(fake_card, ny, nx, admitted, sms, form):
    """A card that admits no cluster sends a grid a cluster holds to the
    slab form; fewer SMs send a tall grid to the cooperative form."""
    fake_card(admitted, sms)
    assert kcl.plan("rounds", 1, ny, nx, CARD).form == form


def _scene(ny, nx, cavity=False):
    grid = tc.Grid(nx=nx, ny=ny, lx=3.0 * nx / ny, ly=3.0,
                   obstacles=(tc.Cylinder(1.0, 1.5, 0.3),))
    return tc.make_scene(grid, tc.SimulationParams(
        dt=0.002, viscosity=1e-4,
        flow_case=tc.FlowCase.CAVITY if cavity else tc.FlowCase.CHANNEL),
        tc.solver_options_for(tc.Semantics.RUST, jacobi_iters=6, outer_corrector_rounds=2))


def _args(scene, seed=3):
    g = torch.Generator().manual_seed(seed)
    ny, nx = scene.grid.ny, scene.grid.nx
    mk = lambda *shape: 0.1 * torch.randn(*shape, generator=g)
    return (mk(ny, nx + 1), mk(ny, nx), mk(ny, nx), torch.zeros(ny, nx), 10 * mk(ny, nx),
            0.002, 1.0, scene)


@pytest.mark.parametrize("cavity", [False, True])
def test_slab_form_on_the_cpu_is_the_plain_version(cavity):
    """On CPU tensors the slab form, like every form, runs the plain
    version and launches nothing."""
    args = _args(_scene(12, 20, cavity))
    n = krounds.solve_correct_rounds.launches
    got = krounds.solve_correct_rounds(*args, form="slab")
    ref = krounds.solve_correct_rounds_plain(*args)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert krounds.solve_correct_rounds.launches == n


@pytest.mark.parametrize("ny,nx,kwargs,match", [
    (12, 1100, {"form": "slab"}, "slab form cannot take"),
    (12, 20, {"form": "slab", "ctas": 2}, "slab form cannot take"),
    (12, 1025, {"form": "slab"}, "slab form cannot take"),
    (12, 20, {"form": "tiled"}, "form must be"),
    (12, 1100, {"form": "cluster"}, "no cluster holds"),
])
def test_forms_refused_before_any_launch(ny, nx, kwargs, match):
    args = _args(_scene(ny, nx))
    n = krounds.solve_correct_rounds.launches
    with pytest.raises(ValueError, match=match):
        krounds.solve_correct_rounds(*args, **kwargs)
    assert krounds.solve_correct_rounds.launches == n
