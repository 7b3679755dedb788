"""pyfocusr_tpu — FOCUSR spectral surface registration in JAX, accelerated
on NVIDIA GPUs.

A from-scratch JAX/XLA re-design of FOCUSR (Lombaert et al. 2013,
Feature-Oriented Correspondence Using Spectral Regularization) with the same
capabilities as the reference implementation gattia/pyfocusr: dense point
correspondences between triangle-mesh surfaces via feature-weighted graph
Laplacians, spectral-coordinate alignment, and Coherent Point Drift.

Public surface mirrors the reference's ``pyfocusr/__init__.py:1-5``
(``Focusr``, ``Graph``, ``eigsort``, ``recursive_eig``, ``print_header``,
the ``vtk_functions`` module) plus the accelerator extensions: mesh pytrees,
jit pipeline entry points, and sharded cohort registration.
"""

from . import vtk_functions  # noqa: F401  (parity: submodule export)
from .focusr import Focusr  # noqa: F401
from .main import print_header  # noqa: F401
from .mesh import (  # noqa: F401
    TriMesh,
    as_trimesh,
    build_topology,
    load_mesh,
    save_mesh,
)
from .pipeline import (  # noqa: F401
    GraphArrays,
    PipelineConfig,
    mesh_to_graph_arrays,
    prepare_source,
    prepare_target,
    register_pair,
    register_pair_prepared,
    register_pair_prepared_source,
    warm_block_from_prepared,
)
from .metrics import registration_quality, surface_distance  # noqa: F401
from .spectral.eigsort import eigsort  # noqa: F401
from .spectral.graph import Graph, features_dictionary  # noqa: F401
from .transfer import (  # noqa: F401
    cohort_point_data_matrix,
    mesh_with_transferred_data,
    transfer_point_data,
)


def recursive_eig(matrix, k, n_k_needed, k_buffer=1, sigma=1e-10, which="LM"):
    """Compatibility export matching reference ``graph.py:357-389``: the k
    smallest eigenpairs with eigenvalue > 1e-10 of an explicit (sparse or
    dense) matrix, growing k on shortfall.

    This shim exists for API parity with code that called the reference's
    ``recursive_eig`` on a scipy matrix directly; the accelerated path is
    ``Graph.get_graph_spectrum`` (matrix-free deflated shift-invert Lanczos,
    ``ops/eigen.py``), which never materializes the Laplacian.

    SMALL MATRICES ONLY: this shim densifies and runs O(N^3)
    ``np.linalg.eig`` — fine for the few-hundred-row matrices such callers
    pass, unusable at mesh scale (5k+).  Use ``Graph.get_graph_spectrum``
    there.
    """
    import numpy as np

    MIN_EIG_VAL = 1e-10
    dense = matrix.toarray() if hasattr(matrix, "toarray") else np.asarray(matrix)
    vals, vecs = np.linalg.eig(dense)
    order = np.argsort(np.abs(vals - sigma))
    vals, vecs = vals[order], vecs[:, order]
    keep = np.where(vals.real > MIN_EIG_VAL)[0][: max(k, n_k_needed)]
    keep = keep[np.argsort(vals.real[keep])][:n_k_needed]
    return np.real(vals[keep]), np.real(vecs[:, keep])


__version__ = "0.1.0"
