"""The ICP nearest-neighbour kernel's plain version against the JAX package's
Pallas kernel (interpret mode) and dense ``nearest_neighbors``.

Indices must be identical (the first index at the minimum, 0 for an
all-invalid target); distances within rtol 1e-6 (one square root of the
same float32 sum on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastslam_tpu.core.pallas_kernels import icp_correspondences as jax_icp_correspondences
from fastslam_tpu.proposal.icp import nearest_neighbors as jax_nearest_neighbors

from fastslam_tpu_torch.core import cuda_kernels
from fastslam_tpu_torch.proposal.icp import nearest_neighbors

torch.set_num_threads(1)


def jax_both(src, tgt, tvalid):
    """(dist, idx) of the Pallas kernel and of the dense JAX function; the
    two must agree with each other first."""
    args = (jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(tvalid))
    d_k, i_k = jax_icp_correspondences(*args, interpret=True)
    d_n, i_n = jax_nearest_neighbors(*args)
    np.testing.assert_array_equal(np.asarray(i_k), np.asarray(i_n))
    return np.asarray(d_n), np.asarray(i_n)


def port(src, tgt, tvalid):
    d, i = cuda_kernels.icp_correspondences_ref(
        torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(tvalid))
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    return d.numpy(), i.numpy()


def assert_matches_jax(src, tgt, tvalid):
    d_want, i_want = jax_both(src, tgt, tvalid)
    d_got, i_got = port(src, tgt, tvalid)
    np.testing.assert_array_equal(i_got, i_want)
    np.testing.assert_allclose(d_got, d_want, rtol=1e-6)
    return d_got, i_got


def clouds(n, mt, seed, p_valid=0.8):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 2, (n, 2)).astype(np.float32),
            rng.normal(0, 2, (mt, 2)).astype(np.float32),
            rng.random(mt) < p_valid)


def test_pallas_test_inputs():
    """The inputs of ``tests/test_pallas.py::test_icp_correspondences_match_dense_nn``."""
    rng = np.random.default_rng(3)
    src = rng.normal(0, 2, (64, 2)).astype(np.float32)
    tgt = rng.normal(0, 2, (96, 2)).astype(np.float32)
    tvalid = rng.random(96) > 0.2
    assert_matches_jax(src, tgt, tvalid)


def test_duplicate_targets_keep_the_first_index():
    src, tgt, tvalid = clouds(40, 24, 1, p_valid=1.0)
    # every target twice, and a source point on a target (distance 0)
    tgt = np.concatenate([tgt, tgt])
    tvalid = np.concatenate([tvalid, tvalid])
    src[5] = tgt[7]
    d, i = assert_matches_jax(src, tgt, tvalid)
    assert (i < 24).all() and i[5] == 7 and d[5] == 0.0
    # with the first copy invalid, the second one wins
    tvalid[:24] = False
    _, i = assert_matches_jax(src, tgt, tvalid)
    assert (i >= 24).all()


def test_all_invalid_target_gives_index_zero_and_inf():
    src, tgt, _ = clouds(16, 20, 2)
    d, i = assert_matches_jax(src, tgt, np.zeros(20, bool))
    assert (i == 0).all() and np.isinf(d).all()


@pytest.mark.parametrize("n,mt", [(7, 300), (257, 33)])
def test_source_and_target_sizes_differ(n, mt):
    assert_matches_jax(*clouds(n, mt, 4))


def test_batched_pairs_match_a_loop_of_the_jax_call():
    b, n, mt = 5, 50, 70
    pairs = [clouds(n, mt, 10 + k) for k in range(b)]
    pairs[2] = (pairs[2][0], pairs[2][1], np.zeros(mt, bool))   # one empty target
    src, tgt, tvalid = (np.stack(x) for x in zip(*pairs))
    d_got, i_got = port(src, tgt, tvalid)
    assert d_got.shape == i_got.shape == (b, n)
    for k in range(b):
        d_want, i_want = jax_both(*pairs[k])
        np.testing.assert_array_equal(i_got[k], i_want)
        np.testing.assert_allclose(d_got[k], d_want, rtol=1e-6)


def test_cpu_tensors_run_the_plain_version():
    src, tgt, tvalid = (torch.from_numpy(a) for a in clouds(30, 40, 5))
    launches = dict(cuda_kernels.LAUNCHES)
    d, i = nearest_neighbors(src, tgt, tvalid)
    assert cuda_kernels.LAUNCHES == launches
    d_ref, i_ref = cuda_kernels.icp_correspondences_ref(src, tgt, tvalid)
    assert torch.equal(d, d_ref) and torch.equal(i, i_ref)


def test_wrapper_refuses_bad_inputs():
    src, tgt, tvalid = (torch.from_numpy(a) for a in clouds(8, 9, 6))
    with pytest.raises(ValueError, match="float32"):
        cuda_kernels.icp_correspondences(src.double(), tgt, tvalid)
    with pytest.raises(ValueError, match="target_valid"):
        cuda_kernels.icp_correspondences(src, tgt, tvalid.to(torch.int32))
    with pytest.raises(ValueError, match="target must be"):
        cuda_kernels.icp_correspondences(src[None], tgt, tvalid)
