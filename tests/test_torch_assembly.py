"""Port's batched element assembly (xfemm_tpu_torch/ops/assembly.py)
against the JAX package's, in f64, on NumPy and on torch inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xfemm_tpu.ops import assembly as jasm
from xfemm_tpu_torch.ops import assembly as tasm


def _mesh(seed=0, n=60, T=90):
    rng = np.random.default_rng(seed)
    xy = rng.random((n, 2)) * 10.0
    tris = np.stack([rng.choice(n, 3, replace=False) for _ in range(T)])
    return xy, tris


def _bh(seed=1, T=90, K=7):
    rng = np.random.default_rng(seed)
    kB = np.cumsum(rng.random((T, K)) * 0.5 + 0.05, axis=1)
    kB[:, 0] = 0.0
    kH = np.cumsum(rng.random((T, K)) * 300.0, axis=1)
    kS = rng.random((T, K)) * 500.0 + 10.0
    B = rng.random(T) * 4.0
    B[::9] = 0.0                     # the b == 0 branches
    return B, kB, kH, kS


def _np(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_geometry_and_curl_match_jax(kind):
    xy, tris = _mesh()
    g_ref = jasm.tri_geometry(jnp.asarray(xy), jnp.asarray(tris))
    m_ref = jasm.curl_matrices(g_ref)
    if kind == "torch":
        g = tasm.tri_geometry(torch.as_tensor(xy), torch.as_tensor(tris))
    else:
        g = tasm.tri_geometry(xy, tris)
    for a, b in zip(g, g_ref):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-12,
                                   atol=1e-12)
    for a, b in zip(tasm.curl_matrices(g), m_ref):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_hermite_vdv_matches_jax(kind):
    B, kB, kH, kS = _bh()
    v_ref, dv_ref = jasm.hermite_vdv(*[jnp.asarray(a) for a in
                                       (B, kB, kH, kS)])
    args = (B, kB, kH, kS) if kind == "numpy" else \
        tuple(torch.as_tensor(a) for a in (B, kB, kH, kS))
    v, dv = tasm.hermite_vdv(*args)
    np.testing.assert_allclose(_np(v), np.asarray(v_ref), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(_np(dv), np.asarray(dv_ref), rtol=1e-12,
                               atol=1e-12)
