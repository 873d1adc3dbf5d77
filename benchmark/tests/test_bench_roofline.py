"""op_roofline counts the operator's own nonzeros: those of the
Dirichlet-eliminated CSR of the mesh, as scipy builds it."""

import numpy as np
import scipy.sparse as sp

from benchmark import roofline
from benchmark.problems import coil_cylinder, heated_core
from benchmark.reference import fem


def _mesh(module, params):
    from xfemm_tpu_torch.mesh import mesher
    return mesher.mesh_problem(module.build(params))


def _scipy_nnz(mesh, fixed):
    n = len(mesh.nodes)
    b, c, area = fem.gradients(mesh.nodes, mesh.elements)
    K = fem.scatter_matrix(mesh.elements, fem.stiffness(b, c, area),
                           np.arange(n), np.ones(n), n).tocsr()
    K.sum_duplicates()
    D = sp.diags((~fixed).astype(float))
    E = (D @ K @ D + sp.diags(fixed.astype(float))).tocsr()
    E.eliminate_zeros()
    return E.nnz


def test_nnz_equals_scipy_csr(small_params):
    for module, params in small_params:
        mesh = _mesh(module, params)
        fixed = module.reference(params, mesh.nodes, mesh.elements,
                                 mesh.element_labels).fixed
        assert fixed.any()
        nnz = roofline.csr_nnz(mesh.elements, len(mesh.nodes), fixed)
        assert nnz == _scipy_nnz(mesh, fixed)
        n = len(mesh.nodes)
        assert roofline.csr_apply_bytes(mesh.elements, n, fixed) == \
            8 * nnz + 4 * (n + 1) + 8 * n


def test_peaks():
    assert roofline.peak("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == \
        3.35e12
    assert roofline.peak("cpu") is None


def test_sweep_bytes():
    import torch
    G = torch.zeros(3, 4, 4)
    r = torch.zeros(4, 4)
    assert roofline.sweep_bytes([G], [r, r]) == 4 * (48 + 32)


def test_modules_agree_on_label_order():
    assert coil_cylinder.LABELS[1] == "steel"
    assert heated_core.LABELS[1] == "core"
