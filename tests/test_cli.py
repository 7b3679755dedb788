"""CLI surface (register/info) via the module entry point, CPU backend."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import DATA, SYNTHETIC_FIXTURES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory, mesh_5k_target, mesh_5k_source):
    """The bundled reference data, or the seeded synthetic pair (conftest)
    written under the bundled file names."""
    if not SYNTHETIC_FIXTURES:
        return DATA
    from pyfocusr_tpu.mesh import save_mesh

    d = tmp_path_factory.mktemp("data")
    save_mesh(str(d / "target_mesh.vtk"), mesh_5k_target)
    save_mesh(str(d / "source_mesh.vtk"), mesh_5k_source)
    return str(d)


def _run_cli(args, timeout=900):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu'); "
        "import sys; sys.path.insert(0, %r); "
        "from pyfocusr_tpu.cli import main; sys.exit(main(%r))"
    ) % (REPO, args)
    return subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        env=env,
        timeout=timeout,
    )


def test_info(data_dir, mesh_5k_source):
    proc = _run_cli(["info", f"{data_dir}/source_mesh.vtk"])
    assert proc.returncode == 0, proc.stderr[-500:]
    out = json.loads(proc.stdout[proc.stdout.index("{"):])
    assert out["points"] == mesh_5k_source.n_points
    assert out["triangles"] == np.asarray(mesh_5k_source.triangles).shape[0]
    assert out["euler_characteristic"] == 2  # closed genus-0 surface


@pytest.mark.slow
def test_register(tmp_path):
    proc = _run_cli(
        [
            "register",
            f"{DATA}/target_mesh.vtk",
            f"{DATA}/source_mesh.vtk",
            "-o",
            str(tmp_path),
            "--non-rigid-max-iterations",
            "30",
            "--graph-smoothing-iterations",
            "30",
            "--n-coords-spectral-registration",
            "500",
        ]
    )
    assert proc.returncode == 0, proc.stderr[-800:]
    assert (tmp_path / "transformed_source.vtk").exists()
    assert (tmp_path / "average_mesh.vtk").exists()
    corr = np.load(tmp_path / "correspondences.npy")
    assert corr.shape == (5000,)


@pytest.mark.slow
def test_register_multires(tmp_path):
    """--multires COARSE_N: decimate -> coarse register -> refine."""
    proc = _run_cli(
        [
            "register",
            f"{DATA}/target_mesh.vtk",
            f"{DATA}/source_mesh.vtk",
            "-o",
            str(tmp_path),
            "--multires",
            "1500",
            "--non-rigid-max-iterations",
            "30",
            "--graph-smoothing-iterations",
            "30",
            "--n-coords-spectral-registration",
            "500",
        ]
    )
    assert proc.returncode == 0, proc.stderr[-800:]
    corr = np.load(tmp_path / "correspondences.npy")
    assert corr.shape == (5000,)
    assert len(np.unique(corr)) > 0.4 * 5000


@pytest.mark.slow
def test_ssm_command(tmp_path):
    """`pyfocusr-tpu ssm`: groupwise template + PCA shape modes."""
    import sys as _sys

    _sys.path.insert(0, __file__.rsplit("/", 1)[0])
    import jax.numpy as jnp
    from test_curvature_icp import make_sphere

    from pyfocusr_tpu.mesh import TriMesh, save_mesh

    pts, tris = make_sphere(n_theta=10, n_phi=20)
    paths = []
    for i in range(2):
        w = pts * (1.0 + 0.05 * (i + 1) * np.sin(3 * pts[:, [1]]))
        p = tmp_path / f"subj{i}.vtk"
        save_mesh(str(p), TriMesh(jnp.asarray(w, jnp.float32), jnp.asarray(tris)))
        paths.append(str(p))
    proc = _run_cli(
        [
            "ssm", *paths, "-o", str(tmp_path),
            "--iterations", "2",
            "--sample", "2",
            "--html",
            "--non-rigid-max-iterations", "10",
            "--graph-smoothing-iterations", "10",
            "--n-coords-spectral-registration", "100",
        ]
    )
    assert proc.returncode == 0, proc.stderr[-800:]
    assert (tmp_path / "ssm_template.vtk").exists()
    html = (tmp_path / "ssm_viewer.html").read_text()
    assert "mode0_mag" in html  # mode-magnitude coloring present
    z = np.load(tmp_path / "ssm_modes.npz")
    assert z["modes"].shape[1] == pts.shape[0]
    assert np.all(np.isfinite(z["variances"]))
    # --sample: synthesized shapes on the template topology.
    from pyfocusr_tpu.mesh import load_mesh

    for si in range(2):
        samp = load_mesh(str(tmp_path / f"ssm_sample_{si}.vtk"))
        assert samp.n_points == pts.shape[0]
        assert np.all(np.isfinite(np.asarray(samp.points)))


def test_ssm_project_flag(tmp_path):
    """`ssm --project held_out.vtk`: out-of-sample fit reports per-mode
    coefficients + residual and writes the reconstruction mesh."""
    import json as _json
    import sys as _sys

    _sys.path.insert(0, __file__.rsplit("/", 1)[0])
    import jax.numpy as jnp
    from test_curvature_icp import make_sphere

    from pyfocusr_tpu.mesh import TriMesh, save_mesh

    pts, tris = make_sphere(n_theta=10, n_phi=20)
    paths = []
    for i in range(3):
        w = pts * (1.0 + 0.04 * (i + 1) * np.sin(3 * pts[:, [1]]))
        p = tmp_path / f"subj{i}.vtk"
        save_mesh(str(p), TriMesh(jnp.asarray(w, jnp.float32), jnp.asarray(tris)))
        paths.append(str(p))
    held = tmp_path / "held_out.vtk"
    w = pts * (1.0 + 0.1 * np.sin(3 * pts[:, [1]]))
    save_mesh(str(held), TriMesh(jnp.asarray(w, jnp.float32), jnp.asarray(tris)))
    proc = _run_cli(
        [
            "ssm", *paths[:2], "-o", str(tmp_path),
            "--project", str(held),
            "--iterations", "1",
            "--non-rigid-max-iterations", "10",
            "--graph-smoothing-iterations", "10",
            "--n-coords-spectral-registration", "100",
        ]
    )
    assert proc.returncode == 0, proc.stderr[-800:]
    out = _json.loads(proc.stdout.strip().splitlines()[-1])
    # Keyed by disambiguated stem (collision-safe across directories); the
    # original path is carried in the record.
    proj = out["projections"]["held_out"]
    assert proj["path"] == str(held)
    assert "coefficients" in proj and "residual_rms_mm" in proj
    assert np.isfinite(proj["residual_rms_mm"])
    assert (tmp_path / proj["output"]).exists()


def test_warmup_command(tmp_path):
    """`pyfocusr-tpu warmup`: precompile + optional AOT export artifact."""
    import sys as _sys

    _sys.path.insert(0, __file__.rsplit("/", 1)[0])
    import jax.numpy as jnp
    from test_curvature_icp import make_sphere

    from pyfocusr_tpu.mesh import TriMesh, save_mesh

    pts, tris = make_sphere(n_theta=10, n_phi=20)
    t = tmp_path / "t.vtk"; s = tmp_path / "s.vtk"
    save_mesh(str(t), TriMesh(jnp.asarray(pts, jnp.float32), jnp.asarray(tris)))
    w = pts * (1.0 + 0.05 * np.sin(3 * pts[:, [1]]))
    save_mesh(str(s), TriMesh(jnp.asarray(w, jnp.float32), jnp.asarray(tris)))
    exp_path = tmp_path / "reg.jaxexp"
    proc = _run_cli(
        [
            "warmup", str(t), str(s), "--export", str(exp_path),
            "--non-rigid-max-iterations", "10",
            "--graph-smoothing-iterations", "10",
            "--n-coords-spectral-registration", "100",
            "--n-coords-spectral-ordering", "150",
        ]
    )
    assert proc.returncode == 0, proc.stderr[-800:]
    import json as _json

    out = _json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["compile_plus_first_run_s"] > 0
    assert exp_path.exists() and exp_path.stat().st_size > 10000


@pytest.mark.slow
def test_register_multi_source_prepared(tmp_path):
    """Several sources against one target: the prepared-template path
    writes per-source-stem outputs and a JSON list summary."""
    proc = _run_cli(
        [
            "register",
            f"{DATA}/target_mesh.vtk",
            f"{DATA}/source_mesh.vtk",
            f"{DATA}/target_mesh.vtk",  # self-registration as 2nd source
            "-o",
            str(tmp_path),
            "--non-rigid-max-iterations",
            "30",
            "--graph-smoothing-iterations",
            "30",
            "--n-coords-spectral-registration",
            "500",
        ]
    )
    assert proc.returncode == 0, proc.stderr[-800:]
    out = json.loads(proc.stdout[proc.stdout.index("["):])
    assert isinstance(out, list) and len(out) == 2
    assert (tmp_path / "source_mesh_transformed_source.vtk").exists()
    assert (tmp_path / "target_mesh_correspondences.npy").exists()
    # self-registration correspondences should be near-identity
    self_corr = np.load(tmp_path / "target_mesh_correspondences.npy")
    assert (self_corr == np.arange(len(self_corr))).mean() > 0.5


def test_register_multi_source_rejects_multires(tmp_path):
    proc = _run_cli(
        [
            "register",
            f"{DATA}/target_mesh.vtk",
            f"{DATA}/source_mesh.vtk",
            f"{DATA}/source_mesh.vtk",
            "--multires", "1000",
            "-o", str(tmp_path),
        ]
    )
    assert proc.returncode == 2
    assert "single source" in proc.stderr


@pytest.mark.slow
def test_register_prepared_state_roundtrip(tmp_path):
    """--save-prepared then --prepared reproduces the direct run exactly
    (same seed -> same key split -> bit-identical correspondences)."""
    common = [
        "--non-rigid-max-iterations", "30",
        "--graph-smoothing-iterations", "30",
        "--n-coords-spectral-registration", "500",
    ]
    d1, d2 = tmp_path / "a", tmp_path / "b"
    d1.mkdir(); d2.mkdir()
    prep_npz = str(tmp_path / "prep.npz")
    p1 = _run_cli(
        ["register", f"{DATA}/target_mesh.vtk", f"{DATA}/source_mesh.vtk",
         "-o", str(d1), "--save-prepared", prep_npz] + common
    )
    assert p1.returncode == 0, p1.stderr[-800:]
    assert os.path.exists(prep_npz)
    p2 = _run_cli(
        ["register", f"{DATA}/target_mesh.vtk", f"{DATA}/source_mesh.vtk",
         "-o", str(d2), "--prepared", prep_npz] + common
    )
    assert p2.returncode == 0, p2.stderr[-800:]
    c1 = np.load(d1 / "correspondences.npy")
    c2 = np.load(d2 / "correspondences.npy")
    np.testing.assert_array_equal(c1, c2)


@pytest.mark.slow
def test_register_warm_from_class_template(tmp_path):
    """--warm-from NPZ: class-template warm start on the CLI (VERDICT r4
    #7).  The template here is the pair's own target (the strongest
    template), saved via --save-prepared; the warm run must land on
    (near-)identical physical picks as the cold run — the same gate as
    test_class_template_warm_block."""
    from pyfocusr_tpu.mesh import load_mesh

    common = [
        "--non-rigid-max-iterations", "30",
        "--graph-smoothing-iterations", "30",
        "--n-coords-spectral-registration", "500",
    ]
    d_cold, d_warm = tmp_path / "cold", tmp_path / "warm"
    d_cold.mkdir(); d_warm.mkdir()
    prep_npz = str(tmp_path / "template.npz")
    p1 = _run_cli(
        ["register", f"{DATA}/target_mesh.vtk", f"{DATA}/source_mesh.vtk",
         "-o", str(d_cold), "--save-prepared", prep_npz] + common
    )
    assert p1.returncode == 0, p1.stderr[-800:]
    p2 = _run_cli(
        ["register", f"{DATA}/target_mesh.vtk", f"{DATA}/source_mesh.vtk",
         "-o", str(d_warm), "--warm-from", prep_npz] + common
    )
    assert p2.returncode == 0, p2.stderr[-800:]
    c_cold = np.load(d_cold / "correspondences.npy")
    c_warm = np.load(d_warm / "correspondences.npy")
    tp = np.asarray(load_mesh(f"{DATA}/target_mesh.vtk").points)
    d = np.linalg.norm(tp[c_cold] - tp[c_warm], axis=1)
    assert np.median(d) < 1e-6, np.median(d)
    assert d.mean() < 0.5, d.mean()


def test_register_warm_from_fast_failures(tmp_path):
    """--warm-from flag validation fails fast (exit 2, no mesh parse)."""
    missing = str(tmp_path / "nope.npz")
    proc = _run_cli(
        ["register", f"{DATA}/target_mesh.vtk", f"{DATA}/source_mesh.vtk",
         "--warm-from", missing, "--multires", "1000", "-o", str(tmp_path)]
    )
    assert proc.returncode == 2 and "--warm-from is incompatible" in proc.stderr
    proc = _run_cli(
        ["register", f"{DATA}/target_mesh.vtk", f"{DATA}/source_mesh.vtk",
         "--warm-from", missing, "--prepared", missing, "-o", str(tmp_path)]
    )
    assert proc.returncode == 2 and "--warm-from is incompatible" in proc.stderr


def test_output_stems_disambiguate_equal_basenames():
    from pyfocusr_tpu.cli import _output_stems

    assert _output_stems(["a/mesh.vtk", "b/mesh.vtk", "c/other.ply"]) == [
        "mesh", "mesh_1", "other",
    ]
    assert _output_stems(["x.vtk"]) == ["x"]


def test_output_stems_counter_cannot_collide_with_real_basename():
    from pyfocusr_tpu.cli import _output_stems

    stems = _output_stems(["a/mesh.vtk", "b/mesh.vtk", "c/mesh_1.vtk"])
    assert len(set(stems)) == 3, stems
    assert stems[2] == "mesh_1"  # real basename keeps its own stem


class TestLandmarkParsing:
    def test_index_format(self, tmp_path):
        from pyfocusr_tpu.cli import _parse_landmark_file

        p = tmp_path / "lm.txt"
        p.write_text("# header comment\n3 17\n5, 2  # trailing comment\n\n")
        kind, rows = _parse_landmark_file(str(p))
        assert kind == "index"
        np.testing.assert_array_equal(rows, [[3, 17], [5, 2]])

    def test_position_format(self, tmp_path):
        from pyfocusr_tpu.cli import _parse_landmark_file

        p = tmp_path / "lm.txt"
        p.write_text("0 0 0 1 1 1\n0.5, 0.5, 0.5, 2, 2, 2\n")
        kind, rows = _parse_landmark_file(str(p))
        assert kind == "position"
        assert rows.shape == (2, 6)

    def test_bad_width_raises(self, tmp_path):
        from pyfocusr_tpu.cli import _parse_landmark_file

        p = tmp_path / "lm.txt"
        p.write_text("1 2 3\n")
        with pytest.raises(ValueError, match="expected 2 .* or 6"):
            _parse_landmark_file(str(p))

    def test_mixed_widths_raise(self, tmp_path):
        from pyfocusr_tpu.cli import _parse_landmark_file

        p = tmp_path / "lm.txt"
        p.write_text("1 2\n0 0 0 1 1 1\n")
        with pytest.raises(ValueError, match="mixed"):
            _parse_landmark_file(str(p))

    def test_empty_raises(self, tmp_path):
        from pyfocusr_tpu.cli import _parse_landmark_file

        p = tmp_path / "lm.txt"
        p.write_text("# only comments\n")
        with pytest.raises(ValueError, match="no landmarks"):
            _parse_landmark_file(str(p))

    def test_index_range_validation(self):
        import jax.numpy as jnp

        from pyfocusr_tpu.cli import _landmark_pairs_for
        from pyfocusr_tpu.mesh import TriMesh

        tri = np.array([[0, 1, 2]], np.int32)
        m3 = TriMesh(jnp.zeros((3, 3), jnp.float32), jnp.asarray(tri), {})
        m5 = TriMesh(jnp.zeros((5, 3), jnp.float32), jnp.asarray(tri), {})
        rows = np.array([[4, 0]])
        with pytest.raises(ValueError, match="source index out of range"):
            _landmark_pairs_for("index", rows, target=m5, source=m3)
        with pytest.raises(ValueError, match="target index out of range"):
            _landmark_pairs_for("index", np.array([[0, 4]]), target=m3, source=m5)
        pairs, snap = _landmark_pairs_for(
            "index", np.array([[2, 4]]), target=m5, source=m3
        )
        assert snap is None
        np.testing.assert_array_equal(pairs, [[2, 4]])


def test_register_landmark_flag_validation(tmp_path):
    proc = _run_cli(
        ["register", f"{DATA}/target_mesh.vtk", f"{DATA}/source_mesh.vtk",
         "--landmark-weight", "50", "-o", str(tmp_path)]
    )
    assert proc.returncode == 2
    assert "requires --landmarks" in proc.stderr


@pytest.mark.slow
def test_register_multires_with_landmarks(tmp_path):
    """Fine-resolution landmark pairs map through the decimation clusters
    into coarse MAP-CPD priors; the run completes and reports them."""
    lm = tmp_path / "lm.txt"
    lm.write_text("10 10\n2500 2500\n")
    proc = _run_cli(
        ["register", f"{DATA}/target_mesh.vtk", f"{DATA}/source_mesh.vtk",
         "--multires", "1500", "--landmarks", str(lm),
         "--landmark-weight", "200", "-o", str(tmp_path),
         "--non-rigid-max-iterations", "30",
         "--graph-smoothing-iterations", "30",
         "--n-coords-spectral-registration", "500"]
    )
    assert proc.returncode == 0, proc.stderr[-800:]
    out = json.loads(proc.stdout[proc.stdout.index("{"):])
    assert out["landmarks"] == 2
    corr = np.load(tmp_path / "correspondences.npy")
    assert len(np.unique(corr)) > 0.4 * 5000


@pytest.mark.slow
def test_register_with_landmarks(tmp_path):
    """Index-pair landmarks flow through to the CPD prior: the run succeeds,
    reports the landmark count, and pins the landmarked vertices closer to
    their targets than the unconstrained run does."""
    lm_idx = [10, 500, 2500, 4000]
    lm = tmp_path / "lm.txt"
    lm.write_text("".join(f"{i} {i}\n" for i in lm_idx))
    common = [
        "--non-rigid-max-iterations", "30",
        "--graph-smoothing-iterations", "30",
        "--n-coords-spectral-registration", "500",
    ]
    d1, d2 = tmp_path / "free", tmp_path / "pinned"
    d1.mkdir(); d2.mkdir()
    p1 = _run_cli(
        ["register", f"{DATA}/target_mesh.vtk", f"{DATA}/source_mesh.vtk",
         "-o", str(d1)] + common
    )
    assert p1.returncode == 0, p1.stderr[-800:]
    p2 = _run_cli(
        ["register", f"{DATA}/target_mesh.vtk", f"{DATA}/source_mesh.vtk",
         "-o", str(d2), "--landmarks", str(lm),
         "--landmark-weight", "200"] + common
    )
    assert p2.returncode == 0, p2.stderr[-800:]
    out = json.loads(p2.stdout[p2.stdout.index("{"):])
    assert out["landmarks"] == len(lm_idx)
    from pyfocusr_tpu.mesh import load_mesh

    tgt_pts = np.asarray(load_mesh(f"{DATA}/target_mesh.vtk").points, np.float64)
    free = np.asarray(load_mesh(str(d1 / "transformed_source.vtk")).points)
    pinned = np.asarray(load_mesh(str(d2 / "transformed_source.vtk")).points)
    d_free = np.linalg.norm(free[lm_idx] - tgt_pts[lm_idx], axis=1).mean()
    d_pin = np.linalg.norm(pinned[lm_idx] - tgt_pts[lm_idx], axis=1).mean()
    assert d_pin < d_free, (d_pin, d_free)


def test_cfg_fingerprint_ignores_landmark_weight():
    """--landmark-weight is per-run: it must not invalidate prepared state
    saved under a different weight (review finding)."""
    import dataclasses

    from pyfocusr_tpu.pipeline import PipelineConfig, _cfg_fingerprint

    cfg = PipelineConfig()
    assert _cfg_fingerprint(cfg) == _cfg_fingerprint(
        dataclasses.replace(cfg, landmark_weight=777.0)
    )
    # ...but every other field still invalidates.
    assert _cfg_fingerprint(cfg) != _cfg_fingerprint(
        dataclasses.replace(cfg, non_rigid_beta=3.0)
    )


def test_cfg_fingerprint_stable_across_field_additions():
    """Fingerprints saved under a PREVIOUS PipelineConfig field set must
    stay loadable: the canonical form only records non-default fields,
    and _fingerprint_matches parses legacy full-repr fingerprints
    (which baked in every field, so adding a knob used to invalidate
    every persisted template — advisor finding r4)."""
    import dataclasses

    from pyfocusr_tpu.pipeline import (
        _FP_SKIP,
        PipelineConfig,
        _cfg_fingerprint,
        _fingerprint_matches,
    )

    cfg = dataclasses.replace(
        PipelineConfig(), non_rigid_beta=3.0, n_spectral_features=4
    )

    # A legacy (pre-r5) fingerprint: the full dataclass repr with the
    # _FP_SKIP knobs normalized to defaults — exactly what r4 wrote.
    fields = PipelineConfig.__dataclass_fields__
    legacy = repr(dataclasses.replace(
        cfg, **{n: fields[n].default for n in _FP_SKIP}
    ))
    assert legacy != _cfg_fingerprint(cfg)  # format changed...
    assert _fingerprint_matches(legacy, cfg)  # ...but still accepted.

    # An even OLDER save, from before eig_wide_degree_warm /
    # eig_warm_resid_tol existed: simulate by textually removing those
    # keywords from the repr (they sit at defaults in `legacy`).
    for name in ("eig_wide_degree_warm", "eig_warm_resid_tol"):
        val = fields[name].default
        for sep in (f", {name}={val!r}", f"{name}={val!r}, "):
            legacy_older = legacy.replace(sep, "", 1)
            if legacy_older != legacy:
                break
        legacy = legacy_older
    assert "eig_wide_degree_warm" not in legacy
    assert _fingerprint_matches(legacy, cfg)

    # Mismatches still mismatch, in both formats.
    other = dataclasses.replace(cfg, non_rigid_beta=50.0)
    assert not _fingerprint_matches(legacy, other)
    assert not _fingerprint_matches(_cfg_fingerprint(cfg), other)
    # Unknown field names (newer version / removed knob) are conservative.
    assert not _fingerprint_matches(
        "PipelineConfig(non_rigid_beta=3.0, n_spectral_features=4, "
        "some_future_knob=1)", cfg
    )
    # Garbage never matches (and never raises).
    assert not _fingerprint_matches("not a fingerprint (", cfg)


def test_prepared_state_loads_across_fingerprint_format(tmp_path, data_dir):
    """End-to-end: a prepared-target .npz whose embedded fingerprint was
    written in the legacy full-repr format still loads under the same
    config (and still fails loudly under a different one)."""
    import dataclasses

    import numpy as np

    from pyfocusr_tpu.mesh import load_mesh
    from pyfocusr_tpu.pipeline import (
        _FP_SKIP,
        PipelineConfig,
        load_prepared_target,
        mesh_to_graph_arrays,
        prepare_target,
        save_prepared_target,
    )

    import jax

    cfg = PipelineConfig()
    mesh = load_mesh(f"{data_dir}/target_mesh.vtk")
    tgt = mesh_to_graph_arrays(mesh)
    prep = prepare_target(tgt, cfg, jax.random.PRNGKey(0))
    path = str(tmp_path / "prep.npz")
    save_prepared_target(path, prep, cfg=cfg, target=tgt)

    # Rewrite the embedded fingerprint leaf to the legacy full-repr
    # format, in place, preserving the npz key layout.
    fields = PipelineConfig.__dataclass_fields__
    legacy = repr(dataclasses.replace(
        cfg, **{n: fields[n].default for n in _FP_SKIP}
    ))
    with np.load(path, allow_pickle=False) as data:
        keys = [str(k) for k in data["__keys__"]]
        leaves = {f"leaf_{i}": data[f"leaf_{i}"] for i in range(len(keys))}
    idx = keys.index("['cfg_fingerprint']")
    leaves[f"leaf_{idx}"] = np.frombuffer(
        legacy.encode(), dtype=np.uint8
    ).copy()
    np.savez_compressed(path, __keys__=np.array(keys), **leaves)

    loaded = load_prepared_target(path, cfg=cfg, target=tgt)
    assert loaded is not None
    with pytest.raises(ValueError, match="different PipelineConfig"):
        load_prepared_target(
            path, cfg=dataclasses.replace(cfg, non_rigid_beta=3.0)
        )


def test_register_landmark_fast_failures(tmp_path):
    """Bad landmark flags fail with a message and exit code 2 BEFORE any
    mesh is parsed (all run in well under a mesh-load)."""
    missing = str(tmp_path / "nope.txt")
    proc = _run_cli(
        ["register", f"{DATA}/target_mesh.vtk", f"{DATA}/source_mesh.vtk",
         "--landmarks", missing, "-o", str(tmp_path)]
    )
    assert proc.returncode == 2 and "--landmarks:" in proc.stderr

    badint = tmp_path / "badint.txt"
    badint.write_text("3.5 2\n")
    proc = _run_cli(
        ["register", f"{DATA}/target_mesh.vtk", f"{DATA}/source_mesh.vtk",
         "--landmarks", str(badint), "-o", str(tmp_path)]
    )
    assert proc.returncode == 2 and "integer vertex indices" in proc.stderr

    lm = tmp_path / "lm.txt"
    lm.write_text("0 0\n")
    proc = _run_cli(
        ["register", f"{DATA}/target_mesh.vtk", f"{DATA}/source_mesh.vtk",
         "--landmarks", str(lm), "--landmark-weight", "0",
         "-o", str(tmp_path)]
    )
    assert proc.returncode == 2 and "must be positive" in proc.stderr

    many = tmp_path / "many.txt"
    many.write_text("".join(f"{i} {i}\n" for i in range(600)))
    proc = _run_cli(
        ["register", f"{DATA}/target_mesh.vtk", f"{DATA}/source_mesh.vtk",
         "--landmarks", str(many),
         "--n-coords-spectral-registration", "500", "-o", str(tmp_path)]
    )
    assert proc.returncode == 2 and "CPD subsample" in proc.stderr


@pytest.mark.slow
def test_register_prepared_with_landmark_weight(tmp_path):
    """Prepared state saved WITHOUT landmarks serves a later run WITH
    --landmarks --landmark-weight (the fingerprint normalizes the weight
    out — review finding: this used to fail with a config mismatch)."""
    common = [
        "--non-rigid-max-iterations", "30",
        "--graph-smoothing-iterations", "30",
        "--n-coords-spectral-registration", "500",
    ]
    prep_npz = str(tmp_path / "prep.npz")
    p1 = _run_cli(
        ["register", f"{DATA}/target_mesh.vtk", f"{DATA}/source_mesh.vtk",
         "-o", str(tmp_path), "--save-prepared", prep_npz] + common
    )
    assert p1.returncode == 0, p1.stderr[-800:]
    lm = tmp_path / "lm.txt"
    lm.write_text("10 10\n2500 2500\n")
    p2 = _run_cli(
        ["register", f"{DATA}/target_mesh.vtk", f"{DATA}/source_mesh.vtk",
         "-o", str(tmp_path), "--prepared", prep_npz,
         "--landmarks", str(lm), "--landmark-weight", "200"] + common
    )
    assert p2.returncode == 0, p2.stderr[-800:]
    out = json.loads(p2.stdout[p2.stdout.index("{"):])
    assert out["landmarks"] == 2


class TestFeaturesFlag:
    def test_compute_node_features_shapes(self):
        import sys as _sys

        _sys.path.insert(0, __file__.rsplit("/", 1)[0])
        import jax.numpy as jnp
        from test_curvature_icp import make_sphere

        from pyfocusr_tpu.cli import _compute_node_features
        from pyfocusr_tpu.mesh import TriMesh

        pts, tris = make_sphere(n_theta=10, n_phi=20)
        m = TriMesh(
            jnp.asarray(pts, jnp.float32),
            jnp.asarray(tris),
            {"t": jnp.asarray(pts[:, 0] ** 2, jnp.float32)},
        )
        f = _compute_node_features(m, ["curvature"])  # min+max principal
        assert f.shape == (pts.shape[0], 2)
        f = _compute_node_features(m, ["t", "max_curvature"])
        assert f.shape == (pts.shape[0], 2)
        assert f.min() >= 0.0 and f.max() <= 1.0  # Graph normalization

    def test_flag_validation(self, tmp_path, data_dir):
        proc = _run_cli(
            ["register", f"{data_dir}/target_mesh.vtk", f"{data_dir}/source_mesh.vtk",
             "--features-in-adjacency", "-o", str(tmp_path)]
        )
        assert proc.returncode == 2
        assert "requires --features" in proc.stderr
        proc = _run_cli(
            ["register", f"{data_dir}/target_mesh.vtk", f"{data_dir}/source_mesh.vtk",
             "--features", "no_such_array", "-o", str(tmp_path)]
        )
        assert proc.returncode == 2
        assert "no_such_array" in proc.stderr
        assert "thickness_change_(mm)" in proc.stderr  # lists what IS there

    @pytest.mark.slow
    def test_register_with_features(self, tmp_path):
        """--features appends the named channels as registration
        coordinates (the F in FOCUSR) end to end."""
        proc = _run_cli(
            ["register", f"{DATA}/target_mesh.vtk", f"{DATA}/source_mesh.vtk",
             "--features", "thickness_change_(mm)", "--quality",
             "-o", str(tmp_path),
             "--non-rigid-max-iterations", "30",
             "--graph-smoothing-iterations", "30",
             "--n-coords-spectral-registration", "500"]
        )
        assert proc.returncode == 0, proc.stderr[-800:]
        out = json.loads(proc.stdout[proc.stdout.index("{"):])
        assert out["quality"]["unique_fraction"] > 0.5
        assert (tmp_path / "transformed_source.vtk").exists()

    @pytest.mark.slow
    def test_register_multires_with_features(self, tmp_path):
        proc = _run_cli(
            ["register", f"{DATA}/target_mesh.vtk", f"{DATA}/source_mesh.vtk",
             "--multires", "1500",
             "--features", "curvature", "--features-in-adjacency",
             "-o", str(tmp_path),
             "--non-rigid-max-iterations", "30",
             "--graph-smoothing-iterations", "30",
             "--n-coords-spectral-registration", "500"]
        )
        assert proc.returncode == 0, proc.stderr[-800:]
        corr = np.load(tmp_path / "correspondences.npy")
        assert len(np.unique(corr)) > 0.3 * 5000


def test_compute_node_features_multicomponent(tmp_path):
    """Vector point_data (e.g. normals) expands into per-component columns
    instead of crashing np.stack (review finding)."""
    import sys as _sys

    _sys.path.insert(0, __file__.rsplit("/", 1)[0])
    import jax.numpy as jnp
    from test_curvature_icp import make_sphere

    from pyfocusr_tpu.cli import _compute_node_features
    from pyfocusr_tpu.mesh import TriMesh

    pts, tris = make_sphere(n_theta=10, n_phi=20)
    m = TriMesh(
        jnp.asarray(pts, jnp.float32),
        jnp.asarray(tris),
        {
            "t": jnp.asarray(pts[:, 0] ** 2, jnp.float32),
            "vec": jnp.asarray(pts, jnp.float32),  # [N, 3]
        },
    )
    f = _compute_node_features(m, ["t", "vec"])
    assert f.shape == (pts.shape[0], 4)  # 1 scalar + 3 components
    assert np.all(np.isfinite(f)) and f.min() >= 0 and f.max() <= 1


def test_convert_command(tmp_path, data_dir, mesh_5k_source):
    """`pyfocusr-tpu convert`: format round-trip through every writer."""
    proc = _run_cli(
        ["convert", f"{data_dir}/source_mesh.vtk", str(tmp_path / "m.vtp")]
    )
    assert proc.returncode == 0, proc.stderr[-500:]
    out = json.loads(proc.stdout[proc.stdout.index("{"):])
    assert out["points"] == mesh_5k_source.n_points
    assert "thickness_change_(mm)" in out["point_data"]
    proc = _run_cli(["convert", str(tmp_path / "m.vtp"), str(tmp_path / "m.ply")])
    assert proc.returncode == 0
    from pyfocusr_tpu import load_mesh

    back = load_mesh(str(tmp_path / "m.ply"))
    orig = load_mesh(f"{data_dir}/source_mesh.vtk")
    np.testing.assert_allclose(
        np.asarray(back.points), np.asarray(orig.points), atol=1e-4
    )
    proc = _run_cli(["convert", f"{data_dir}/source_mesh.vtk", str(tmp_path / "m.xyz")])
    assert proc.returncode == 2 and "unsupported output extension" in proc.stderr


def test_cohort_command(tmp_path):
    """`pyfocusr-tpu cohort`: template -> N subjects, mean shape +
    per-subject correspondences + quality in the summary."""
    import sys as _sys

    _sys.path.insert(0, __file__.rsplit("/", 1)[0])
    import jax.numpy as jnp
    from test_curvature_icp import make_sphere

    from pyfocusr_tpu.mesh import TriMesh, save_mesh

    pts, tris = make_sphere(n_theta=10, n_phi=20)
    tpl = tmp_path / "tpl.vtk"
    save_mesh(str(tpl), TriMesh(jnp.asarray(pts, jnp.float32), jnp.asarray(tris)))
    paths = []
    for i in range(2):
        w = pts * (1.0 + 0.04 * (i + 1) * np.sin(3 * pts[:, [1]]))
        p = tmp_path / f"subj{i}.vtk"
        save_mesh(str(p), TriMesh(jnp.asarray(w, jnp.float32), jnp.asarray(tris)))
        paths.append(str(p))
    proc = _run_cli(
        ["cohort", str(tpl), *paths, "-o", str(tmp_path),
         "--non-rigid-max-iterations", "10",
         "--graph-smoothing-iterations", "10",
         "--n-coords-spectral-registration", "100"]
    )
    assert proc.returncode == 0, proc.stderr[-800:]
    out = json.loads(proc.stdout[proc.stdout.index("{"):])
    assert out["n_subjects"] == 2
    assert len(out["unique_fraction_per_subject"]) == 2
    corr = np.load(tmp_path / "cohort_correspondences.npy")
    assert corr.shape[0] == 2
    from pyfocusr_tpu import load_mesh

    mean = load_mesh(str(tmp_path / "mean_shape.vtk"))
    assert mean.n_points == pts.shape[0]
    assert np.all(np.isfinite(np.asarray(mean.points)))


def test_landmark_nonfinite_positions_rejected(tmp_path):
    from pyfocusr_tpu.cli import _parse_landmark_file

    p = tmp_path / "lm.txt"
    p.write_text("0 0 0 1 1 1\nnan nan nan 2 2 2\n")
    with pytest.raises(ValueError, match="must be finite"):
        _parse_landmark_file(str(p))


def test_landmarks_exceeding_effective_subsample(tmp_path):
    """The pipeline bounds the CPD subsample by the MESH sizes too; the CLI
    must catch counts between the config bound and the mesh bound (review
    finding: used to escape as a deep traceback)."""
    import sys as _sys

    _sys.path.insert(0, __file__.rsplit("/", 1)[0])
    import jax.numpy as jnp
    from test_curvature_icp import make_sphere

    from pyfocusr_tpu.mesh import TriMesh, save_mesh

    pts, tris = make_sphere(n_theta=10, n_phi=20)  # 182 vertices
    t = tmp_path / "t.vtk"
    save_mesh(str(t), TriMesh(jnp.asarray(pts, jnp.float32), jnp.asarray(tris)))
    lm = tmp_path / "lm.txt"
    lm.write_text("0 0\n" * 200)  # 200 pins > 182 mesh verts, < default 1000
    proc = _run_cli(
        ["register", str(t), str(t), "--landmarks", str(lm), "-o", str(tmp_path)]
    )
    assert proc.returncode == 2, proc.stderr[-500:]
    assert "effective CPD subsample" in proc.stderr


def test_features_width_mismatch_between_meshes(tmp_path):
    """Same-named point_data with different component counts on target vs
    source must exit 2 naming the offender, not crash at jit-trace time."""
    import sys as _sys

    _sys.path.insert(0, __file__.rsplit("/", 1)[0])
    import jax.numpy as jnp
    from test_curvature_icp import make_sphere

    from pyfocusr_tpu.mesh import TriMesh, save_mesh

    pts, tris = make_sphere(n_theta=10, n_phi=20)
    t = tmp_path / "t.vtk"
    s = tmp_path / "s.vtk"
    save_mesh(str(t), TriMesh(
        jnp.asarray(pts, jnp.float32), jnp.asarray(tris),
        {"disp": jnp.asarray(pts, jnp.float32)},  # [N, 3]
    ))
    save_mesh(str(s), TriMesh(
        jnp.asarray(pts, jnp.float32), jnp.asarray(tris),
        {"disp": jnp.asarray(pts[:, 0], jnp.float32)},  # [N]
    ))
    proc = _run_cli(
        ["register", str(t), str(s), "--features", "disp", "-o", str(tmp_path)]
    )
    assert proc.returncode == 2, proc.stderr[-500:]
    assert "feature columns" in proc.stderr


def test_checkpoint_dir_requires_multires(tmp_path):
    proc = _run_cli(
        ["register", f"{DATA}/target_mesh.vtk", f"{DATA}/source_mesh.vtk",
         "-o", str(tmp_path), "--checkpoint-dir", str(tmp_path / "ck")]
    )
    assert proc.returncode == 2
    assert "--checkpoint-dir requires --multires" in proc.stderr


@pytest.mark.slow
def test_register_multires_checkpoint_resume(tmp_path):
    """--checkpoint-dir: the second identical invocation resumes from the
    saved coarse stage and reproduces the first run's correspondences."""
    args = [
        "register", f"{DATA}/target_mesh.vtk", f"{DATA}/source_mesh.vtk",
        "-o", str(tmp_path), "--multires", "1500",
        "--checkpoint-dir", str(tmp_path / "ck"),
        "--non-rigid-max-iterations", "30",
        "--graph-smoothing-iterations", "30",
        "--n-coords-spectral-registration", "500",
    ]
    proc = _run_cli(args)
    assert proc.returncode == 0, proc.stderr[-800:]
    assert (tmp_path / "ck" / "coarse.npz").exists()
    corr1 = np.load(tmp_path / "correspondences.npy")
    proc = _run_cli(args)
    assert proc.returncode == 0, proc.stderr[-800:]
    corr2 = np.load(tmp_path / "correspondences.npy")
    np.testing.assert_array_equal(corr1, corr2)


def test_register_aot_flag(tmp_path):
    """`register --aot FILE`: first invocation exports the program, second
    serves through the loaded artifact (no re-tracing) with identical
    outputs; incompatible-flag combinations are rejected up front."""
    import sys as _sys

    _sys.path.insert(0, __file__.rsplit("/", 1)[0])
    import jax.numpy as jnp
    from test_curvature_icp import make_sphere

    from pyfocusr_tpu.mesh import TriMesh, save_mesh

    pts, tris = make_sphere(n_theta=10, n_phi=20)
    t = tmp_path / "t.vtk"; s = tmp_path / "s.vtk"
    save_mesh(str(t), TriMesh(jnp.asarray(pts, jnp.float32), jnp.asarray(tris)))
    w = pts * (1.0 + 0.05 * np.sin(3 * pts[:, [1]]))
    save_mesh(str(s), TriMesh(jnp.asarray(w, jnp.float32), jnp.asarray(tris)))
    art = tmp_path / "reg.jaxexp"
    fast = [
        "--non-rigid-max-iterations", "10",
        "--graph-smoothing-iterations", "10",
        "--n-coords-spectral-registration", "100",
        "--n-coords-spectral-ordering", "150",
    ]

    proc = _run_cli(
        ["register", str(t), str(s), "-o", str(tmp_path / "o1"),
         "--aot", str(art)] + fast
    )
    assert proc.returncode == 0, proc.stderr[-800:]
    assert art.exists() and (tmp_path / "reg.jaxexp.meta.json").exists()

    proc2 = _run_cli(
        ["register", str(t), str(s), "-o", str(tmp_path / "o2"),
         "--aot", str(art)] + fast
    )
    assert proc2.returncode == 0, proc2.stderr[-800:]
    c1 = np.load(tmp_path / "o1" / "correspondences.npy")
    c2 = np.load(tmp_path / "o2" / "correspondences.npy")
    np.testing.assert_array_equal(c1, c2)

    # Mismatched config -> loud failure, exit 2.
    proc3 = _run_cli(
        ["register", str(t), str(s), "-o", str(tmp_path / "o3"),
         "--aot", str(art), "--non-rigid-max-iterations", "11"] + fast[2:]
    )
    assert proc3.returncode == 2
    assert "different PipelineConfig" in proc3.stderr

    # Incompatible flags rejected before any mesh I/O.
    proc4 = _run_cli(
        ["register", str(t), str(s), "--aot", str(art), "--multires", "100"]
    )
    assert proc4.returncode == 2
    assert "incompatible" in proc4.stderr


@pytest.mark.slow
def test_register_feature_mode_g_matrix(tmp_path):
    """--feature-mode g-matrix routes the feature through the weighted G
    matrix (the reference's feature_weights mechanism) instead of
    appending coordinates — the docs/tuning.md recommended setting that
    preserves uniqueness (measured 0.862 vs 0.631 at 15k)."""
    proc = _run_cli(
        ["register", f"{DATA}/target_mesh.vtk", f"{DATA}/source_mesh.vtk",
         "--features", "thickness_change_(mm)",
         "--feature-mode", "g-matrix", "--feature-weight", "0.1",
         "--quality", "-o", str(tmp_path),
         "--non-rigid-max-iterations", "30",
         "--graph-smoothing-iterations", "30",
         "--n-coords-spectral-registration", "500"]
    )
    assert proc.returncode == 0, proc.stderr[-800:]
    out = json.loads(proc.stdout[proc.stdout.index("{"):])
    # The G-matrix route keeps near-featureless uniqueness (the coords
    # route trades it away: ~0.70 at these budgets on the 5k pair).
    assert out["quality"]["unique_fraction"] > 0.75
    assert (tmp_path / "transformed_source.vtk").exists()
