"""The ``pyfocusr`` drop-in alias package: every import style the reference
supported (``/root/reference/pyfocusr/__init__.py:1-5`` star-imports +
submodules) must resolve to the pyfocusr_tpu implementations unchanged."""


def test_flat_imports_match_reference_surface():
    import pyfocusr
    import pyfocusr_tpu

    assert pyfocusr.Focusr is pyfocusr_tpu.Focusr
    assert pyfocusr.Graph is pyfocusr_tpu.Graph
    assert pyfocusr.eigsort is pyfocusr_tpu.eigsort
    assert pyfocusr.recursive_eig is pyfocusr_tpu.recursive_eig
    assert pyfocusr.print_header is pyfocusr_tpu.print_header
    assert pyfocusr.__version__ == pyfocusr_tpu.__version__


def test_submodule_import_styles():
    from pyfocusr.eigsort import eigsort
    from pyfocusr.focusr import Focusr
    from pyfocusr.graph import Graph, features_dictionary, recursive_eig
    from pyfocusr.main import print_header
    from pyfocusr.vtk_functions import read_vtk_mesh

    import pyfocusr.vtk_functions as vf
    import pyfocusr_tpu

    assert Focusr is pyfocusr_tpu.Focusr
    assert Graph is pyfocusr_tpu.Graph
    assert eigsort is pyfocusr_tpu.eigsort
    assert callable(recursive_eig) and callable(print_header)
    assert set(features_dictionary) == {
        "curvature",
        "min_curvature",
        "max_curvature",
    }
    assert vf.read_vtk_mesh is read_vtk_mesh


def test_reference_style_usage_runs():
    """The reference notebook's import + construction pattern, verbatim
    module paths, on a tiny synthetic pair."""
    import sys

    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    from test_curvature_icp import make_sphere

    from pyfocusr import Focusr, TriMesh

    p1, t1 = make_sphere(n_theta=8, n_phi=16)
    p2 = p1 * (1.0 + 0.04 * np.sin(3 * p1[:, [1]]))
    reg = Focusr(
        vtk_mesh_target=TriMesh(jnp.asarray(p1, jnp.float32), jnp.asarray(t1)),
        vtk_mesh_source=TriMesh(
            jnp.asarray(p2.astype(np.float32)), jnp.asarray(t1)
        ),
        get_weighted_spectral_coords=False,
        non_rigid_max_iterations=10,
        graph_smoothing_iterations=5,
        projection_smooth_iterations=2,
        n_coords_spectral_registration=100,
        seed=0,
    )
    reg.align_maps()
    corr = np.asarray(reg.corresponding_target_idx_for_each_source_pt)
    assert corr.shape == (len(p1),)
    assert len(np.unique(corr)) > 0.5 * len(p1)
