"""The port's copy of the mesher (its own C++ build under the package's
_build directory) produces the JAX package's mesh exactly."""

import numpy as np

from xfemm_tpu.mesh import mesher as jmesher
from xfemm_tpu.models import benchprob as jbench
from xfemm_tpu_torch.mesh import mesher as tmesher
from xfemm_tpu_torch.models import benchprob as tbench


def test_benchprob_mesh_identical():
    mt = tmesher.mesh_problem(tbench.build(3000))
    mj = jmesher.mesh_problem(jbench.build(3000))
    assert mt.num_nodes > 2000
    for f in ("nodes", "node_markers", "elements", "element_labels",
              "edges", "edge_markers", "pbc_pairs"):
        a, b = getattr(mt, f), getattr(mj, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
