"""The port's sharded pressure solves against cfd_demo_tpu's on the CPU:
the plain wide-halo Jacobi (``jacobi_shmap``) and the fused forms over
kernels 11 and 14 (``jacobi_kernel_shmap``, ``sor_kernel_shmap``), on
global 64x64 arrays cut into the 8 shards of tests/conftest.py's virtual
CPU mesh (the JAX side) and of a CPU ``RowMesh`` (the port), from the
same numpy inputs. Tolerances as tests/test_torch_shard_kernels.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_demo_tpu.shard import jacobi_shmap as jjs
from cfd_demo_tpu.shard import sor_shmap as jss
from cfd_demo_tpu.shard.mesh import make_mesh as jax_mesh

from cfd_demo_tpu_torch.ops import poisson as tpois
from cfd_demo_tpu_torch.shard import jacobi_shmap as tjs
from cfd_demo_tpu_torch.shard import sor_shmap as tss
from cfd_demo_tpu_torch.shard.mesh import join_rows, make_mesh, split_rows

from test_torch_shard_kernels import T, assert_fields, cpu_mesh

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8,
    reason="needs the 8-device virtual CPU mesh (CFD_TEST_PLATFORM=cpu)")

torch.set_num_threads(1)



def _pp_rhs(seed, n=64):
    rng = np.random.default_rng(seed)
    pp = tpois._apply_pprime_bcs(T(0.1 * rng.standard_normal((n, n)).astype(np.float32)))
    return pp.numpy(), rng.standard_normal((n, n)).astype(np.float32)


@pytest.mark.parametrize("k", [1, 4, 5])
def test_jacobi_shmap_plain_matches_jax(k):
    pp, rhs = _pp_rhs(0)
    want, werr = jax.jit(lambda p, r: jjs.jacobi_shmap(p, r, jax_mesh(), 1 / 64, 1 / 64,
                                                        0.75, 20, k=k))(pp, rhs)
    got, gerr = tjs.jacobi_shmap(T(pp), T(rhs), cpu_mesh(), 1 / 64, 1 / 64, 0.75, 20, k=k)
    assert_fields(got.numpy(), want)
    assert np.isclose(float(gerr), float(werr), rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("k,tol", [(4, 0.0), (8, 0.0), (8, 1e-3), (8, 1e-2)])
def test_jacobi_kernel_shmap_matches_jax(k, tol):
    """The fused form, fixed and early-exiting (the same launches)."""
    pp, rhs = _pp_rhs(1)
    want, werr = jjs.jacobi_pallas_shmap(jnp.asarray(pp), jnp.asarray(rhs), jax_mesh(),
                                         1 / 64, 1 / 64, 0.75, 48, k=k, interpret=True,
                                         tol=tol, early_exit=tol > 0)
    got, gerr = tjs.jacobi_kernel_shmap(T(pp), T(rhs), cpu_mesh(), 1 / 64, 1 / 64, 0.75,
                                        48, k=k, tol=tol, early_exit=tol > 0)
    assert_fields(got.numpy(), want)
    assert np.isclose(float(gerr), float(werr), rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("k", [2, 4])
def test_sor_kernel_shmap_matches_jax(k):
    pp, rhs = _pp_rhs(2)
    want, werr = jss.sor_pallas_shmap(jnp.asarray(pp), jnp.asarray(rhs), jax_mesh(),
                                      1 / 64, 1 / 64, 1.7, 20, k=k, interpret=True)
    got, gerr = tss.sor_kernel_shmap(T(pp), T(rhs), cpu_mesh(), 1 / 64, 1 / 64, 1.7, 20,
                                     k=k)
    assert_fields(got.numpy(), want)
    assert np.isclose(float(gerr), float(werr), rtol=1e-4, atol=1e-7)


def test_shard_bodies_refuse_a_bad_split():
    mesh = cpu_mesh(4)
    blocks = split_rows(torch.zeros(40, 16), mesh)  # 10 rows a shard
    with pytest.raises(ValueError, match="multiple of 8"):
        tjs.jacobi_shard_body(blocks, blocks, mesh, 40, 0.1, 0.1, 0.8, 20, 10)
    with pytest.raises(ValueError, match="multiple of k"):
        tss.sor_shard_body(blocks, blocks, mesh, 40, 0.1, 0.1, 1.7, 21, 5)
    assert join_rows(blocks, "cpu").shape == (40, 16)
