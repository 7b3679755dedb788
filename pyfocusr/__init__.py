"""Drop-in alias for the reference package name ``pyfocusr``.

Code written against gattia/pyfocusr imports the JAX framework
unchanged::

    from pyfocusr import Focusr, Graph
    from pyfocusr.vtk_functions import read_vtk_mesh, icp_transform
    from pyfocusr.graph import recursive_eig, features_dictionary
    from pyfocusr.eigsort import eigsort

The reference's ``__init__`` (``/root/reference/pyfocusr/__init__.py:1-5``)
star-imports ``focusr`` and ``graph`` and exposes the ``vtk_functions``
submodule; this alias reproduces that surface by re-exporting
:mod:`pyfocusr_tpu` and registering submodule aliases for every module the
reference had (``focusr``, ``graph``, ``eigsort``, ``vtk_functions``,
``main``), so both the flat and the submodule import styles work.

Only install this alongside the real ``pyfocusr`` if you are NOT using the
original — the two packages share the import name by design (that is the
point of a drop-in).
"""

import sys as _sys

from pyfocusr_tpu import (  # noqa: F401
    Focusr,
    Graph,
    GraphArrays,
    PipelineConfig,
    TriMesh,
    as_trimesh,
    eigsort,
    features_dictionary,
    load_mesh,
    mesh_to_graph_arrays,
    print_header,
    recursive_eig,
    register_pair,
    save_mesh,
    vtk_functions,
)
from pyfocusr_tpu import focusr, main  # noqa: F401
from pyfocusr_tpu.spectral import eigsort as _eigsort_module
from pyfocusr_tpu.spectral import graph  # noqa: F401

# ``from pyfocusr.graph import recursive_eig`` worked in the reference
# (``graph.py:357``); our module-level shim lives in the package root, so
# mirror it onto the alias target too.
if not hasattr(graph, "recursive_eig"):
    graph.recursive_eig = recursive_eig

for _name, _mod in {
    "focusr": focusr,
    "graph": graph,
    "eigsort": _eigsort_module,
    "vtk_functions": vtk_functions,
    "main": main,
}.items():
    _sys.modules[__name__ + "." + _name] = _mod

# Reference version was "0.0.14"; advertise the rebuild's own version.
from pyfocusr_tpu import __version__  # noqa: F401,E402
