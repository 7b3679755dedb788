"""Execute the example notebook headless (CI `notebook` job).

The notebook is the reference's de facto main() (SURVEY §3.5); running it
end-to-end in CI makes the documentation executable.  On runners without
the bundled reference checkout the synthetic fixture pair (the same one
tests/conftest.py uses) is written to a temp data dir and the notebook's
DATA constant is patched to it.

Env:
  PYFOCUSR_NOTEBOOK_FAST=1   shrink iteration counts ~10x (CI default
                             here keeps the true config; set this locally
                             for a quick smoke)

Usage:  python tools/run_notebook.py  [notebook.ipynb]
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

DATA = "/root/reference/data"


def _ensure_data() -> str:
    if os.path.isdir(DATA):
        return DATA
    # Synthetic fixture pair (conftest._synthetic_bone) stands in.
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from conftest import _synthetic_bone

    from pyfocusr_tpu.mesh import save_mesh

    d = tempfile.mkdtemp(prefix="pyfocusr_nb_data_")
    save_mesh(os.path.join(d, "source_mesh.vtk"), _synthetic_bone(1))
    save_mesh(os.path.join(d, "target_mesh.vtk"), _synthetic_bone(2))
    return d


def main() -> int:
    nb_path = (
        sys.argv[1]
        if len(sys.argv) > 1
        else os.path.join(ROOT, "examples",
                          "Example_registering_two_bone_meshes.ipynb")
    )
    import nbformat
    from nbconvert.preprocessors import ExecutePreprocessor

    nb = nbformat.read(nb_path, as_version=4)
    data_dir = _ensure_data()
    fast = os.environ.get("PYFOCUSR_NOTEBOOK_FAST") == "1"
    for cell in nb.cells:
        if cell.cell_type != "code":
            continue
        cell.source = cell.source.replace(
            'DATA = "/root/reference/data"', f'DATA = "{data_dir}"'
        )
        if fast:
            cell.source = (
                cell.source
                .replace("non_rigid_max_iterations=300",
                         "non_rigid_max_iterations=30")
                .replace("graph_smoothing_iterations=600",
                         "graph_smoothing_iterations=60")
            )
    # Prepend a backend guard so an accelerator-pinned environment cannot
    # leak into the CI run.
    nb.cells.insert(0, nbformat.v4.new_code_cell(
        # Repo path first: locally the package may not be pip-installed
        # (CI does `pip install -e .`, but the tool must work both ways).
        f"import sys; sys.path.insert(0, {ROOT!r})\n"
        "import jax\n"
        "try:\n"
        "    jax.config.update('jax_platforms', 'cpu')\n"
        "except Exception:\n"
        "    pass\n"
    ))

    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="pyfocusr_nb_run_") as run_dir:
        ep = ExecutePreprocessor(timeout=1800, kernel_name="python3")
        ep.preprocess(nb, {"metadata": {"path": run_dir}})
    n_code = sum(1 for c in nb.cells if c.cell_type == "code")
    print(json.dumps({
        "notebook": os.path.basename(nb_path),
        "code_cells_executed": n_code,
        "seconds": round(time.time() - t0, 1),
        "data": "bundled" if data_dir == DATA else "synthetic",
        "fast": fast,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
