"""Mesh I/O golden tests against the bundled reference data
(SURVEY §7 stage 1: counts and point-data round-trip on the 4 meshes)."""

import numpy as np
import pytest

from pyfocusr_tpu.io.vtk_io import read_vtk_polydata, write_vtk_polydata

from conftest import DATA, _require_data


@pytest.mark.parametrize(
    "name,n_pts,n_tris",
    [
        ("source_mesh.vtk", 5000, 9996),
        ("target_mesh.vtk", 5000, 9996),
        ("source_mesh_15k.vtk", 14996, 29982),
        ("target_mesh_15k.vtk", 14998, 29989),
    ],
)
def test_read_bundled(name, n_pts, n_tris):
    _require_data()
    pts, tris, pd = read_vtk_polydata(f"{DATA}/{name}")
    assert pts.shape == (n_pts, 3)
    assert tris.shape == (n_tris, 3)
    assert tris.min() >= 0 and tris.max() < n_pts
    assert "thickness_change_(mm)" in pd
    assert pd["thickness_change_(mm)"].shape == (n_pts,)


def test_roundtrip(tmp_path, mesh_5k_source):
    src = tmp_path / "source_mesh.vtk"
    write_vtk_polydata(
        src, np.asarray(mesh_5k_source.points, np.float64),
        np.asarray(mesh_5k_source.triangles),
        {k: np.asarray(v, np.float64)
         for k, v in mesh_5k_source.point_data.items()},
    )
    pts, tris, pd = read_vtk_polydata(str(src))
    out = tmp_path / "rt.vtk"
    write_vtk_polydata(out, pts, tris, pd)
    pts2, tris2, pd2 = read_vtk_polydata(str(out))
    np.testing.assert_allclose(pts, pts2, rtol=1e-9)
    np.testing.assert_array_equal(tris, tris2)
    np.testing.assert_allclose(
        pd["thickness_change_(mm)"], pd2["thickness_change_(mm)"], rtol=1e-9
    )


def test_multiple_arrays_roundtrip(tmp_path):
    pts = np.random.default_rng(0).normal(size=(10, 3))
    tris = np.array([[0, 1, 2], [1, 2, 3]])
    pd = {"a": np.arange(10.0), "b": np.arange(10.0) * 2}
    out = tmp_path / "m.vtk"
    write_vtk_polydata(out, pts, tris, pd)
    _, _, pd2 = read_vtk_polydata(str(out))
    np.testing.assert_allclose(pd2["a"], pd["a"])
    np.testing.assert_allclose(pd2["b"], pd["b"])


def test_binary_vtk_read(tmp_path):
    """Legacy big-endian BINARY .vtk files parse identically to ASCII
    (the reference's vtkPolyDataReader handles both; so do we)."""
    import struct

    pts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float64)
    tris = np.array([[0, 1, 2], [0, 1, 3]], np.int32)
    scal = np.array([0.5, 1.5, 2.5, 3.5])
    path = tmp_path / "bin.vtk"
    with open(path, "wb") as f:
        f.write(b"# vtk DataFile Version 4.2\n")
        f.write(b"binary test\n")
        f.write(b"BINARY\n")
        f.write(b"DATASET POLYDATA\n")
        f.write(b"POINTS 4 double\n")
        f.write(pts.astype(">f8").tobytes())
        f.write(b"\n")
        conn = np.column_stack([np.full(2, 3, np.int32), tris]).ravel()
        f.write(b"POLYGONS 2 8\n")
        f.write(conn.astype(">i4").tobytes())
        f.write(b"\n")
        f.write(b"POINT_DATA 4\n")
        f.write(b"SCALARS thickness double\n")
        f.write(b"LOOKUP_TABLE default\n")
        f.write(scal.astype(">f8").tobytes())
        f.write(b"\n")
    p2, t2, pd2 = read_vtk_polydata(str(path))
    np.testing.assert_allclose(p2, pts)
    np.testing.assert_array_equal(t2, tris)
    np.testing.assert_allclose(pd2["thickness"], scal)


def test_native_reader_matches_python(tmp_path, mesh_5k_target, mesh_5k_source):
    """The native C++ fast-path reader (when built) returns byte-identical
    results to the pure-python tokenizer on all bundled meshes (without
    the reference data: on the synthetic pair written as ASCII .vtk)."""
    from conftest import SYNTHETIC_FIXTURES
    from pyfocusr_tpu.io.vtk_io import _read_ascii
    from pyfocusr_tpu.native import get_lib

    if get_lib() is None:
        pytest.skip("native library not built (run `make native`)")
    if SYNTHETIC_FIXTURES:
        paths = []
        for name, m in (("target", mesh_5k_target), ("source", mesh_5k_source)):
            path = str(tmp_path / f"{name}_mesh.vtk")
            write_vtk_polydata(
                path, np.asarray(m.points, np.float64), np.asarray(m.triangles),
                {k: np.asarray(v, np.float64) for k, v in m.point_data.items()},
            )
            paths.append(path)
    else:
        paths = [f"{DATA}/{name}" for name in (
            "source_mesh.vtk", "target_mesh.vtk",
            "source_mesh_15k.vtk", "target_mesh_15k.vtk")]
    for path in paths:
        p1, t1, d1 = read_vtk_polydata(path)
        raw = open(path, "rb").read()
        p2, t2, d2 = _read_ascii(raw.decode("ascii", errors="replace"))
        np.testing.assert_array_equal(p1, p2)
        np.testing.assert_array_equal(t1, t2)
        for k in d2:
            np.testing.assert_array_equal(d1[k], d2[k])


def _tiny_mesh():
    pts = np.array(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0.5]], np.float64
    )
    tris = np.array([[0, 1, 2], [1, 3, 2]], np.int64)
    return pts, tris


def test_ascii_vtk51_offsets_connectivity(tmp_path):
    """VTK >= 5.1 ASCII POLYGONS layout: OFFSETS / CONNECTIVITY sub-blocks
    (io/vtk_io.py ascii reader; the bundled meshes are all 4.2 flat-stream)."""
    pts, tris = _tiny_mesh()
    path = tmp_path / "v51.vtk"
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 5.1\nmesh\nASCII\nDATASET POLYDATA\n")
        f.write("POINTS 4 double\n")
        for p in pts:
            f.write(" ".join(str(v) for v in p) + "\n")
        f.write("POLYGONS 3 6\n")
        f.write("OFFSETS vtktypeint64\n0 3 6\n")
        f.write("CONNECTIVITY vtktypeint64\n0 1 2 1 3 2\n")
    p2, t2, _ = read_vtk_polydata(str(path))
    np.testing.assert_allclose(p2, pts)
    np.testing.assert_array_equal(np.sort(t2, axis=1), np.sort(tris, axis=1))


def test_binary_vtk51_offsets_connectivity(tmp_path):
    """VTK >= 5.1 BINARY POLYGONS layout (big-endian payloads)."""
    pts, tris = _tiny_mesh()
    path = tmp_path / "v51b.vtk"
    with open(path, "wb") as f:
        f.write(b"# vtk DataFile Version 5.1\nmesh\nBINARY\nDATASET POLYDATA\n")
        f.write(b"POINTS 4 double\n")
        f.write(pts.astype(">f8").tobytes() + b"\n")
        f.write(b"POLYGONS 3 6\n")
        f.write(b"OFFSETS vtktypeint64\n")
        f.write(np.array([0, 3, 6], ">i8").tobytes() + b"\n")
        f.write(b"CONNECTIVITY vtktypeint64\n")
        f.write(np.array([0, 1, 2, 1, 3, 2], ">i8").tobytes() + b"\n")
    p2, t2, _ = read_vtk_polydata(str(path))
    np.testing.assert_allclose(p2, pts)
    np.testing.assert_array_equal(np.sort(t2, axis=1), np.sort(tris, axis=1))


def test_binary_field_arrays(tmp_path):
    """BINARY reader FIELD support (round-1 gap: binary FIELD was skipped)."""
    pts, tris = _tiny_mesh()
    thick = np.array([0.1, 0.2, 0.3, 0.4])
    curv = np.array([[1, 2], [3, 4], [5, 6], [7, 8]], np.float64)
    path = tmp_path / "field.vtk"
    with open(path, "wb") as f:
        f.write(b"# vtk DataFile Version 4.2\nmesh\nBINARY\nDATASET POLYDATA\n")
        f.write(b"POINTS 4 float\n")
        f.write(pts.astype(">f4").tobytes() + b"\n")
        f.write(b"POLYGONS 2 8\n")
        f.write(
            np.array([3, 0, 1, 2, 3, 1, 3, 2], ">i4").tobytes() + b"\n"
        )
        f.write(b"POINT_DATA 4\n")
        f.write(b"FIELD FieldData 2\n")
        f.write(b"thickness 1 4 double\n")
        f.write(thick.astype(">f8").tobytes() + b"\n")
        f.write(b"curv2 2 4 double\n")
        f.write(curv.astype(">f8").tobytes() + b"\n")
    p2, t2, pd = read_vtk_polydata(str(path))
    np.testing.assert_allclose(pd["thickness"], thick)
    np.testing.assert_allclose(pd["curv2"], curv)


def test_cell_data_sections_sized_by_cell_count(tmp_path):
    """SCALARS inside CELL_DATA are sized by the CELL count (here 2, not
    n_points=4); a following POINT_DATA array must still parse correctly
    through BOTH ascii paths and the binary reader."""
    pts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float64)
    tris = np.array([[0, 1, 2], [0, 1, 3]], np.int32)
    cell_vals = np.array([7.0, 8.0])
    pt_vals = np.array([0.5, 1.5, 2.5, 3.5])

    ascii_body = (
        "# vtk DataFile Version 4.2\ncells test\nASCII\nDATASET POLYDATA\n"
        "POINTS 4 double\n"
        + "\n".join(" ".join(f"{v:g}" for v in row) for row in pts)
        + "\nPOLYGONS 2 8\n3 0 1 2\n3 0 1 3\n"
        "CELL_DATA 2\nSCALARS area double\nLOOKUP_TABLE default\n7 8\n"
        "POINT_DATA 4\nSCALARS thickness double\nLOOKUP_TABLE default\n"
        "0.5 1.5 2.5 3.5\n"
    )
    path = tmp_path / "cells.vtk"
    path.write_text(ascii_body)
    p2, t2, pd2 = read_vtk_polydata(str(path))
    np.testing.assert_allclose(p2, pts)
    np.testing.assert_array_equal(t2, tris)
    assert "area" not in pd2  # cell data parsed for alignment, not kept
    np.testing.assert_allclose(pd2["thickness"], pt_vals)

    # Pure-python path explicitly (native may or may not be built).
    from pyfocusr_tpu.io.vtk_io import _read_ascii

    p3, t3, pd3 = _read_ascii(ascii_body)
    np.testing.assert_allclose(p3, pts)
    assert "area" not in pd3
    np.testing.assert_allclose(pd3["thickness"], pt_vals)

    # Binary layout with CELL_DATA before POINT_DATA.
    bpath = tmp_path / "cells_bin.vtk"
    with open(bpath, "wb") as f:
        f.write(b"# vtk DataFile Version 4.2\nbin cells\nBINARY\n")
        f.write(b"DATASET POLYDATA\nPOINTS 4 double\n")
        f.write(pts.astype(">f8").tobytes() + b"\n")
        conn = np.column_stack([np.full(2, 3, np.int32), tris]).ravel()
        f.write(b"POLYGONS 2 8\n" + conn.astype(">i4").tobytes() + b"\n")
        f.write(b"CELL_DATA 2\nSCALARS area double\nLOOKUP_TABLE default\n")
        f.write(cell_vals.astype(">f8").tobytes() + b"\n")
        f.write(b"POINT_DATA 4\nSCALARS thickness double\nLOOKUP_TABLE default\n")
        f.write(pt_vals.astype(">f8").tobytes() + b"\n")
    p4, t4, pd4 = read_vtk_polydata(str(bpath))
    np.testing.assert_allclose(p4, pts)
    assert "area" not in pd4
    np.testing.assert_allclose(pd4["thickness"], pt_vals)


def test_scalars_int_data_without_lookup_table(tmp_path):
    """Integer SCALARS whose first value is >= 5, with no numComp and no
    LOOKUP_TABLE line: the first value must parse as DATA (the optional
    numComp is spec-limited to 1..4), not as a component count."""
    body = (
        "# vtk DataFile Version 4.2\nint scalars\nASCII\nDATASET POLYDATA\n"
        "POINTS 3 double\n0 0 0\n1 0 0\n0 1 0\n"
        "POLYGONS 1 4\n3 0 1 2\n"
        "POINT_DATA 3\nSCALARS labels int\n5 3 2\n"
    )
    path = tmp_path / "ints.vtk"
    path.write_text(body)
    _, _, pd = read_vtk_polydata(str(path))
    np.testing.assert_array_equal(pd["labels"], [5, 3, 2])

    from pyfocusr_tpu.io.vtk_io import _read_ascii

    _, _, pd2 = _read_ascii(body)
    np.testing.assert_array_equal(pd2["labels"], [5, 3, 2])


def test_degenerate_polys_keep_triangle_shape():
    from pyfocusr_tpu.io.vtk_io import _triangulate_polys

    out = _triangulate_polys(np.array([2, 0, 1, 2, 1, 2], np.int64))
    assert out.shape == (0, 3)


def test_build_topology_rejects_out_of_range_indices():
    from pyfocusr_tpu.mesh import build_topology

    with pytest.raises(ValueError, match="triangle indices"):
        build_topology(np.array([[0, 5, 12]], np.int32), 10)
    with pytest.raises(ValueError, match="triangle indices"):
        build_topology(np.array([[0, -1, 2]], np.int32), 10)


class TestRobustnessRound3:
    """Round-3 review: malformed/degenerate files fail loudly; wide
    point_data round-trips."""

    def test_wide_point_data_roundtrips_as_field(self, tmp_path):
        """Arrays with >4 components exceed the SCALARS numComp cap and
        must be written as FIELD data (a 6-comp SCALARS was unreadable)."""
        from pyfocusr_tpu.io.vtk_io import read_vtk_polydata, write_vtk_polydata

        rng = np.random.default_rng(0)
        pts = rng.normal(size=(10, 3))
        tris = np.asarray([[0, 1, 2], [3, 4, 5]], np.int32)
        wide = rng.normal(size=(10, 6))
        p = str(tmp_path / "wide.vtk")
        write_vtk_polydata(p, pts, tris, {"spec": wide})
        pts2, tris2, pd = read_vtk_polydata(p)
        np.testing.assert_allclose(pd["spec"], wide, rtol=1e-8)
        np.testing.assert_array_equal(tris2, tris)

    def test_negative_poly_count_raises(self, tmp_path):
        p = str(tmp_path / "neg.vtk")
        open(p, "w").write(
            "# vtk DataFile Version 4.2\nm\nASCII\nDATASET POLYDATA\n"
            "POINTS 3 double\n0 0 0\n1 0 0\n0 1 0\n"
            "POLYGONS 1 4\n-1 0 1 2\n"
        )
        from pyfocusr_tpu.io.vtk_io import read_vtk_polydata

        with pytest.raises(ValueError, match="polygon vertex count"):
            read_vtk_polydata(p)

    def test_truncated_binary_points_raise(self, tmp_path):
        """A binary file declaring more points than it contains must raise,
        not return a silently short mesh."""
        from pyfocusr_tpu.io.vtk_io import read_vtk_polydata

        header = (
            b"# vtk DataFile Version 4.2\nm\nBINARY\nDATASET POLYDATA\n"
            b"POINTS 1000 double\n"
        )
        payload = np.arange(600 * 3, dtype=">f8").tobytes()  # only 600 pts
        p = str(tmp_path / "trunc.vtk")
        open(p, "wb").write(header + payload)
        with pytest.raises(ValueError, match="truncated"):
            read_vtk_polydata(p)
