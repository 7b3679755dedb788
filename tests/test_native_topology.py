"""Native C++ topology builder (native/fast_topology.cpp) vs the numpy
reference implementation: byte-identical outputs on real and adversarial
meshes.  Skips when the shared library is not built."""

import numpy as np
import pytest

from pyfocusr_tpu.native import get_lib


def _numpy_topology(tris, n_points, **kw):
    """Run build_topology with the native path disabled."""
    import pyfocusr_tpu.mesh as mesh_mod
    import pyfocusr_tpu.native as native_mod

    orig = native_mod.topology_native
    native_mod.topology_native = lambda *a, **k: None
    try:
        return mesh_mod.build_topology(tris, n_points, **kw)
    finally:
        native_mod.topology_native = orig


def _native_topology(tris, n_points, **kw):
    import pyfocusr_tpu.mesh as mesh_mod

    return mesh_mod.build_topology(tris, n_points, **kw)


requires_native = pytest.mark.skipif(
    get_lib() is None or not hasattr(get_lib(), "topo_edges"),
    reason="native library not built",
)


def _assert_equal(a, b):
    np.testing.assert_array_equal(a.edges, b.edges)
    np.testing.assert_array_equal(a.edge_faces, b.edge_faces)
    np.testing.assert_array_equal(a.neighbors, b.neighbors)
    np.testing.assert_array_equal(a.nbr_mask, b.nbr_mask)
    np.testing.assert_array_equal(a.component_labels, b.component_labels)
    np.testing.assert_array_equal(a.overflow_edges, b.overflow_edges)
    assert a.max_degree == b.max_degree
    assert a.n_components == b.n_components


@requires_native
def test_bundled_meshes_identical(mesh_5k_target):
    """The bundled target mesh and the 15k source (isolated vertices), or
    without the reference data the synthetic bone at two sizes."""
    from conftest import DATA, SYNTHETIC_FIXTURES
    from pyfocusr_tpu import load_mesh
    from pyfocusr_tpu.synthetic import synthetic_bone

    big = (synthetic_bone(1, subdivisions=5) if SYNTHETIC_FIXTURES
           else load_mesh(f"{DATA}/source_mesh_15k.vtk"))
    for m in (mesh_5k_target, big):
        tris = np.asarray(m.triangles)
        _assert_equal(
            _native_topology(tris, m.n_points),
            _numpy_topology(tris, m.n_points),
        )


@requires_native
def test_random_soup_and_degenerates_identical():
    rng = np.random.default_rng(0)
    cases = []
    for n, f in ((50, 120), (200, 500)):
        cases.append((rng.integers(0, n, size=(f, 3)), n))
    # disconnected: two islands + isolated vertices
    t1 = rng.integers(0, 20, size=(30, 3))
    t2 = rng.integers(30, 50, size=(30, 3))
    cases.append((np.concatenate([t1, t2]), 60))
    for tris, n in cases:
        _assert_equal(
            _native_topology(tris, n), _numpy_topology(tris, n)
        )


@requires_native
def test_degree_cap_and_padding_identical():
    rng = np.random.default_rng(1)
    # hub: vertex 0 touches everyone
    ring = np.arange(1, 40)
    tris = np.stack([np.zeros_like(ring[:-1]), ring[:-1], ring[1:]], axis=1)
    for kw in ({"degree_cap": 8}, {"degree_cap": 8, "pad_degree": 12},
               {"degree_cap": None}):
        _assert_equal(
            _native_topology(tris, 40, **kw), _numpy_topology(tris, 40, **kw)
        )


@requires_native
def test_speed_sanity():
    """Native must not be slower than numpy at scale (soft gate: the host
    is noisy, so just require it completes and returns the same counts)."""
    import time

    from pyfocusr_tpu.multires import subdivide
    from pyfocusr_tpu.synthetic import synthetic_bone

    m = subdivide(synthetic_bone(2, subdivisions=6))
    tris = np.asarray(m.triangles)
    t0 = time.perf_counter()
    topo = _native_topology(tris, m.n_points)
    dt = time.perf_counter() - t0
    assert topo.edges.shape[0] > 0
    assert dt < 30.0, dt


def test_mis_greedy_matches_numpy_luby():
    """The native greedy MIS (priority order) must equal the numpy Luby
    rounds byte-for-byte: both construct the lexicographically-first MIS
    for the same static priorities."""
    from pyfocusr_tpu.multires import _luby_mis_numpy
    from pyfocusr_tpu.native import get_lib, mis_greedy_native

    if get_lib() is None:
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(0)
    for n, m in ((10, 15), (100, 300), (1000, 4000), (5000, 0)):
        if m:
            e = rng.integers(0, n, size=(m, 2))
            e = e[e[:, 0] != e[:, 1]]
            e.sort(axis=1)
            key = np.unique(e[:, 0] * np.int64(n) + e[:, 1])
            u, v = (key // n).astype(np.int64), (key % n).astype(np.int64)
        else:  # edge-free graph: every vertex becomes a seed
            u = v = np.zeros(0, np.int64)
        for seed in range(3):
            prio = np.random.default_rng(seed).permutation(n).astype(np.int64)
            a = mis_greedy_native(u, v, n, prio)
            b = _luby_mis_numpy(u, v, n, prio)
            np.testing.assert_array_equal(a, b)
            # MIS sanity: independent and maximal.
            s = a == 1
            if len(u):
                assert not np.any(s[u] & s[v])
                blocked_ok = s | (
                    np.bincount(np.concatenate([u[s[v]], v[s[u]]]), minlength=n) > 0
                )
                assert blocked_ok.all()


def test_stale_native_library_is_rebuilt(tmp_path):
    """A stale/corrupt _native.so must not permanently disable the native
    paths: get_lib rebuilds it in place and retries."""
    import shutil

    import shutil as _sh

    import pyfocusr_tpu.native as native

    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    # The test needs a REBUILD to be possible, not just a loaded library.
    src_dir = native.os.path.join(
        native.os.path.dirname(native.os.path.dirname(native.__file__)),
        "native",
    )
    if (
        (_sh.which("g++") or _sh.which("c++")) is None
        or native.os.environ.get("PYFOCUSR_TPU_NO_AUTOBUILD") == "1"
        or not native.os.path.exists(
            native.os.path.join(src_dir, "fast_topology.cpp")
        )
    ):
        pytest.skip("native rebuild not possible in this environment")
    path = native.os.path.join(
        native.os.path.dirname(native.__file__), "_native.so"
    )
    backup = str(tmp_path / "backup.so")
    shutil.copy(path, backup)
    try:
        # Swap in garbage via a NEW inode (os.replace): truncating the
        # mapped .so in place would SIGBUS every process that dlopened it.
        # The temp lives NEXT TO the target (os.replace needs one fs).
        garbage = path + ".garbage"
        with open(garbage, "wb") as fh:
            fh.write(b"not a shared library")
        native.os.replace(garbage, path)
        native._LIB = None
        native._TRIED = False
        lib = native.get_lib()
        assert lib is not None  # rebuilt from native/*.cpp and loaded
        out = native.mis_greedy_native(
            np.asarray([0], np.int64), np.asarray([1], np.int64), 2,
            np.asarray([0, 1], np.int64),
        )
        assert out is not None and out[0] == 1 and out[1] == -1
    finally:
        # Restore via a new inode + os.replace, for the same SIGBUS reason
        # as the swap-in: the just-rebuilt .so is mapped under this path.
        restore = path + ".restore"
        shutil.copy(backup, restore)
        native.os.replace(restore, path)
        native._LIB = None
        native._TRIED = False
        native.get_lib()
