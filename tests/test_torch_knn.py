"""The port's KNN (`gaussian_splatting_torch/ops/knn.py`) against the JAX
package's named forms, on the CPU.

Tolerances: the Morton codes are integers and must be equal; the mean
squared distances within rtol 1e-6 (float32 sums of three squares and a
mean of three, which the two libraries may round in another order). The
comparisons call JAX's named forms, not its dispatcher, which would take
the native host sweep if that extension were built.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.ops import knn as jknn
from gaussian_splatting_torch.ops import knn


def random_points(P, seed):
    return np.random.default_rng(seed).normal(size=(P, 3)).astype(np.float32)


def lattice_points():
    """A 15^3 lattice with its first 500 points repeated: many points share
    a Morton code, so the stable sort decides their candidates."""
    g = np.stack(np.meshgrid(*[np.arange(15)] * 3), -1).reshape(-1, 3).astype(np.float32) * 0.1
    return np.concatenate([g, g[:500]])


CLOUDS = {"random 3000": lambda: random_points(3000, 0), "lattice with ties": lattice_points}


@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_morton_codes_equal_jax(cloud):
    pts = CLOUDS[cloud]()
    want = np.asarray(jknn.morton_codes(jnp.asarray(pts))).astype(np.int64)
    got = knn.morton_codes(torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_morton_form_matches_jax(cloud):
    pts = CLOUDS[cloud]()
    want = np.asarray(jknn.mean_knn_dist2_morton(jnp.asarray(pts)))
    got = knn.mean_knn_dist2_morton(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_exact_form_matches_jax_on_a_ragged_chunk_with_duplicates():
    pts = random_points(300, 1)
    pts[10:20] = pts[:10]  # distance 0 to a twin: the self mask must not take it
    want = np.asarray(jknn.mean_knn_dist2_exact(jnp.asarray(pts), chunk=128))
    got = knn.mean_knn_dist2_exact(torch.from_numpy(pts), chunk=128).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("P,form", [(20_000, "exact"), (20_001, "morton")])
def test_dispatch_is_exact_up_to_20000_points(monkeypatch, P, form):
    taken = []
    monkeypatch.setattr(knn, "mean_knn_dist2_exact",
                        lambda pts, k: taken.append("exact") or torch.zeros(pts.shape[0]))
    monkeypatch.setattr(knn, "mean_knn_dist2_morton",
                        lambda pts, k: taken.append("morton") or torch.zeros(pts.shape[0]))
    out = knn.mean_knn_dist2(np.zeros((P, 3), np.float32), device="cpu")
    assert taken == [form] and out.shape == (P,)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        knn.mean_knn_dist2(random_points(10, 0))
