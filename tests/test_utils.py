"""Utility subsystems: checkpointing, timing, logging."""

import jax.numpy as jnp
import numpy as np
import pytest

from pyfocusr_tpu.utils.checkpoint import load_results, save_results
from pyfocusr_tpu.utils.logging import StageTimer, print_header


def test_checkpoint_roundtrip(tmp_path):
    tree = {
        "correspondences": jnp.arange(10, dtype=jnp.int32),
        "points": jnp.ones((5, 3)),
        "nested": {"Q": jnp.asarray([1.0, 2.0])},
    }
    p = str(tmp_path / "ckpt.npz")
    save_results(p, tree)
    flat = load_results(p)
    assert len(flat) == 3
    vals = {k.split("'")[1] if "'" in k else k: v for k, v in flat.items()}
    np.testing.assert_array_equal(
        [v for k, v in flat.items() if "correspondences" in k][0], np.arange(10)
    )
    np.testing.assert_array_equal(
        [v for k, v in flat.items() if "Q" in k][0], [1.0, 2.0]
    )


def test_stage_timer(capsys):
    t = StageTimer()
    with t.span("stage_a"):
        pass
    with t.span("stage_a"):
        pass
    with t.span("stage_b"):
        pass
    totals = t.totals()
    assert set(totals) == {"stage_a", "stage_b"}
    t.report()
    out = capsys.readouterr().out
    assert "stage_a" in out and "stage_b" in out


def test_print_header(capsys):
    print_header("Hello")
    out = capsys.readouterr().out
    assert "Hello" in out and "=" * 72 in out


def test_stage_timer_profiler_annotations():
    """enable_profiler=True wraps spans in jax.profiler.TraceAnnotation."""
    t = StageTimer(enable_profiler=True)
    with t.span("annotated"):
        pass
    assert "annotated" in t.totals()


def test_focusr_state_checkpoint_roundtrip(tmp_path):
    """focusr_state_dict -> save -> load -> restore re-populates the
    reference-named result attributes (SURVEY §5.4 checkpoint/resume)."""
    import jax.numpy as jnp

    from pyfocusr_tpu.utils.checkpoint import (
        focusr_state_dict,
        load_results,
        restore_focusr_state,
        save_results,
    )

    class FakeReg:
        Q = jnp.asarray([1.0, 2.0])
        corresponding_target_idx_for_each_source_pt = jnp.arange(5)
        weighted_avg_transformed_points = jnp.ones((5, 3))

    state = focusr_state_dict(FakeReg())
    assert set(state) == {
        "Q",
        "corresponding_target_idx_for_each_source_pt",
        "weighted_avg_transformed_points",
    }
    p = str(tmp_path / "focusr.npz")
    save_results(p, state)
    loaded = load_results(p)

    class Empty:
        pass

    reg2 = Empty()
    restore_focusr_state(reg2, loaded)
    np.testing.assert_array_equal(np.asarray(reg2.Q), [1.0, 2.0])
    np.testing.assert_array_equal(
        np.asarray(reg2.corresponding_target_idx_for_each_source_pt), np.arange(5)
    )


class TestAOTExport:
    """Serving path: exported registration programs round-trip through
    serialization and reproduce register_pair exactly (utils/aot.py)."""

    def test_export_load_roundtrip(self, tmp_path):
        import sys as _sys

        _sys.path.insert(0, __file__.rsplit("/", 1)[0])
        import jax
        import jax.numpy as jnp
        from test_curvature_icp import make_sphere

        from pyfocusr_tpu.mesh import TriMesh
        from pyfocusr_tpu.pipeline import (
            PipelineConfig,
            mesh_to_graph_arrays,
            register_pair,
        )
        from pyfocusr_tpu.utils.aot import export_registration, load_registration

        pts, tris = make_sphere(n_theta=10, n_phi=20)
        t = TriMesh(jnp.asarray(pts * 1.0, jnp.float32), jnp.asarray(tris))
        s = TriMesh(
            jnp.asarray(pts * (1.0 + 0.05 * np.sin(3 * pts[:, [1]])), jnp.float32),
            jnp.asarray(tris),
        )
        tg, sg = mesh_to_graph_arrays(t), mesh_to_graph_arrays(s)
        cfg = PipelineConfig(
            icp_iterations=10,
            n_coords_spectral_ordering=150,
            n_coords_spectral_registration=100,
            non_rigid_max_iterations=10,
            non_rigid_n_eigens=30,
            graph_smoothing_iterations=10,
            projection_smooth_iterations=2,
            eig_cg_iters=60,
        )
        path = export_registration(cfg, tg, sg, str(tmp_path / "reg.jaxexp"))
        runner = load_registration(path)
        key = jax.random.PRNGKey(3)
        out = runner(tg, sg, key)
        ref = register_pair(tg, sg, cfg, key)
        np.testing.assert_array_equal(
            np.asarray(out["correspondences"]), np.asarray(ref["correspondences"])
        )
        np.testing.assert_allclose(
            np.asarray(out["weighted_points"]),
            np.asarray(ref["weighted_points"]),
            atol=1e-6,
        )

    def test_sidecar_validation(self, tmp_path):
        """The .meta.json sidecar: loading with a mismatched config or
        shape class fails loudly instead of serving a stale program
        (VERDICT r3 task #2 — deployed AOT serving needs auditability)."""
        import dataclasses
        import os as _os
        import sys as _sys

        _sys.path.insert(0, __file__.rsplit("/", 1)[0])
        import jax.numpy as jnp
        from test_curvature_icp import make_sphere

        from pyfocusr_tpu.mesh import TriMesh
        from pyfocusr_tpu.pipeline import PipelineConfig, mesh_to_graph_arrays
        from pyfocusr_tpu.utils.aot import export_registration, load_registration

        pts, tris = make_sphere(n_theta=10, n_phi=20)
        m = TriMesh(jnp.asarray(pts, jnp.float32), jnp.asarray(tris))
        g = mesh_to_graph_arrays(m)
        cfg = PipelineConfig(
            icp_iterations=5,
            n_coords_spectral_ordering=100,
            n_coords_spectral_registration=80,
            non_rigid_max_iterations=5,
            non_rigid_n_eigens=20,
            graph_smoothing_iterations=5,
            projection_smooth_iterations=1,
            eig_cg_iters=40,
        )
        path = export_registration(cfg, g, g, str(tmp_path / "reg.jaxexp"))
        assert _os.path.exists(path + ".meta.json")

        # Matching inputs validate cleanly.
        load_registration(path, cfg=cfg, target=g, source=g)
        # landmark_weight is fingerprint-normalized: still valid.
        load_registration(
            path, cfg=dataclasses.replace(cfg, landmark_weight=7.0)
        )
        # A config that changes the program is rejected.
        with pytest.raises(ValueError, match="different PipelineConfig"):
            load_registration(
                path, cfg=dataclasses.replace(cfg, non_rigid_beta=10.0)
            )
        # A different shape class is rejected.
        g_pad = mesh_to_graph_arrays(m, pad_n_points=m.n_points + 64)
        with pytest.raises(ValueError, match="shapes"):
            load_registration(path, source=g_pad)
        # Sidecar-less artifacts (pre-metadata exports) skip validation.
        _os.remove(path + ".meta.json")
        load_registration(path, cfg=cfg, target=g, source=g_pad)

    def test_export_rejects_padded_hungarian(self, tmp_path):
        """Review regression: exporting a padded-graph 'hungarian' program
        must raise like register_pair does, not serve corrupt assignments."""
        import dataclasses
        import sys as _sys

        _sys.path.insert(0, __file__.rsplit("/", 1)[0])
        import jax.numpy as jnp
        from test_curvature_icp import make_sphere

        from pyfocusr_tpu.mesh import TriMesh
        from pyfocusr_tpu.pipeline import PipelineConfig, mesh_to_graph_arrays
        from pyfocusr_tpu.utils.aot import export_registration

        pts, tris = make_sphere(n_theta=10, n_phi=20)
        m = TriMesh(jnp.asarray(pts, jnp.float32), jnp.asarray(tris))
        g_pad = mesh_to_graph_arrays(m, pad_n_points=m.n_points + 64)
        cfg = PipelineConfig(
            initial_correspondence_type="hungarian",
            n_coords_spectral_ordering=100,
            n_coords_spectral_registration=80,
        )
        with pytest.raises(ValueError, match="unpadded"):
            export_registration(cfg, g_pad, g_pad, str(tmp_path / "x.jaxexp"))


def test_stage_timer_records_on_exception():
    """A span whose body raises still records its (partial) duration —
    the failing stage is the one a crash diagnosis needs."""
    t = StageTimer()
    with pytest.raises(RuntimeError):
        with t.span("exploding"):
            raise RuntimeError("boom")
    assert "exploding" in t.totals()


class TestAOTExecutableFormat:
    """Executable-level AOT (round 4): the compiled XLA executable itself
    round-trips through serialization — zero-compile serving (the
    StableHLO format re-compiles per process).

    The serialize/deserialize round-trip runs in a SUBPROCESS: this
    jaxlib's XLA:CPU ``executable.serialize()`` / cache-deserialize pair
    segfaults late in long-lived processes (the same upstream bug the
    Makefile shards around), and this suite position is exactly that
    regime.  Production serving is on a GPU, which does not share it.
    Sidecar-REJECTION checks raise before any executable bytes are
    touched and stay in-process."""

    def _write_pair(self, tmp_path):
        import sys as _sys

        _sys.path.insert(0, __file__.rsplit("/", 1)[0])
        import jax.numpy as jnp
        from test_curvature_icp import make_sphere

        from pyfocusr_tpu.mesh import TriMesh, save_mesh

        pts, tris = make_sphere(n_theta=10, n_phi=20)
        save_mesh(str(tmp_path / "t.vtk"),
                  TriMesh(jnp.asarray(pts, jnp.float32), jnp.asarray(tris)))
        save_mesh(str(tmp_path / "s.vtk"),
                  TriMesh(jnp.asarray(pts * 1.03, jnp.float32),
                          jnp.asarray(tris)))

    CFG = (
        "PipelineConfig(icp_iterations=5, n_coords_spectral_ordering=100, "
        "n_coords_spectral_registration=80, non_rigid_max_iterations=5, "
        "non_rigid_n_eigens=20, graph_smoothing_iterations=5, "
        "projection_smooth_iterations=1, eig_cg_iters=40)"
    )

    def test_exec_roundtrip_and_validation(self, tmp_path):
        import json as _json
        import os as _os
        import subprocess
        import sys as _sys

        self._write_pair(tmp_path)
        repo = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
        code = f"""
import jax; jax.config.update('jax_platforms', 'cpu')
# Whole-process cache OFF: an XLA:CPU executable DESERIALIZED into a
# process that also loads cache-hit executables fails at execute time
# ("Buffer Definition Event: Function ... not found" — observed on the
# second run, once the sibling register_pair program became a cache
# hit).  CPU tests sidestep it.
jax.config.update('jax_enable_compilation_cache', False)
import sys; sys.path.insert(0, {repo!r})
import numpy as np
from pyfocusr_tpu.mesh import load_mesh
from pyfocusr_tpu.pipeline import PipelineConfig, mesh_to_graph_arrays, register_pair
from pyfocusr_tpu.utils.aot import export_registration_exec, load_registration_exec
tg = mesh_to_graph_arrays(load_mesh({str(tmp_path / 't.vtk')!r}))
sg = mesh_to_graph_arrays(load_mesh({str(tmp_path / 's.vtk')!r}))
cfg = {self.CFG}
path = export_registration_exec(cfg, tg, sg, {str(tmp_path / 'reg.jaxexec')!r})
runner = load_registration_exec(path, cfg=cfg, target=tg, source=sg)
key = jax.random.PRNGKey(3)
out = runner(tg, sg, key)
ref = register_pair(tg, sg, cfg, key)
np.testing.assert_array_equal(np.asarray(out['correspondences']),
                              np.asarray(ref['correspondences']))
print('ROUNDTRIP_OK')
"""
        env = dict(_os.environ)
        env.pop("JAX_PLATFORMS", None)
        proc = subprocess.run(
            [_sys.executable, "-c", code], capture_output=True, text=True,
            env=env, timeout=900,
        )
        assert proc.returncode == 0, proc.stderr[-800:]
        assert "ROUNDTRIP_OK" in proc.stdout
        assert (tmp_path / "reg.jaxexec.meta.json").exists()

        # Sidecar rejections raise BEFORE any executable bytes are read —
        # safe in-process.
        import dataclasses

        from pyfocusr_tpu.pipeline import PipelineConfig
        from pyfocusr_tpu.utils.aot import load_registration_exec

        cfg = eval(self.CFG)
        path = str(tmp_path / "reg.jaxexec")
        with pytest.raises(ValueError, match="different PipelineConfig"):
            load_registration_exec(
                path, cfg=dataclasses.replace(cfg, non_rigid_beta=9.0)
            )
        meta = _json.loads((tmp_path / "reg.jaxexec.meta.json").read_text())
        meta["device_kind"] = "Imaginary Accelerator v9"
        (tmp_path / "reg.jaxexec.meta.json").write_text(_json.dumps(meta))
        with pytest.raises(ValueError, match="device kind"):
            load_registration_exec(path)

    def test_exec_magic_header_checked_before_unpickle(self, tmp_path):
        """.jaxexec is a pickle payload (trust boundary — advisor finding
        r4): a file without the magic header must be rejected BEFORE any
        pickle bytes are read, so arbitrary files can never reach
        pickle.loads through this loader."""
        import pickle

        from pyfocusr_tpu.utils.aot import _EXEC_MAGIC, load_registration_exec

        class Boom:
            def __reduce__(self):
                return (pytest.fail, ("pickle payload was executed",))

        bad = tmp_path / "evil.jaxexec"
        bad.write_bytes(pickle.dumps(Boom()))
        with pytest.raises(ValueError, match="missing .* header"):
            load_registration_exec(str(bad))

        # A headered artifact reaches the unpickle step (here: garbage
        # after the header fails in pickle, proving the gate passed).
        garbled = tmp_path / "garbled.jaxexec"
        garbled.write_bytes(_EXEC_MAGIC + b"not a pickle")
        with pytest.raises(Exception) as exc:
            load_registration_exec(str(garbled))
        assert not isinstance(exc.value, ValueError) or "header" not in str(
            exc.value
        )


@pytest.mark.parametrize("env_set", [True, False], ids=["env_set", "env_unset"])
def test_compile_cache_location(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR set: code sets no directory (JAX reads the
    variable itself).  Unset: the fixed <checkout>/.jax_cache."""
    import os

    import jax

    from pyfocusr_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            jax.config.update("jax_compilation_cache_dir", "untouched")
            assert compile_cache.enable_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == "untouched"
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            want = os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                ".jax_cache",
            )
            assert compile_cache.default_cache_dir() == want
            assert compile_cache.enable_compile_cache() == want
            assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_lowered_pipeline_matmuls_are_highest():
    """Static precision audit of the lowered register_pair program (the
    driver entry point's small pair): every dot_general / convolution runs
    at HIGHEST — on an H100 an f32 matmul without a precision runs in TF32
    — and the KNN stages carry no matmul at all (direct differences)."""
    import sys

    import jax

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parents[1]))
    from __graft_entry__ import entry
    from pyfocusr_tpu.utils.precision import dot_precision_census

    fn, args = entry()
    census = dot_precision_census(jax.jit(fn).lower(*args).as_text())
    assert census.get("HIGHEST", 0) > 50, census
    assert set(census) == {"HIGHEST"}, census


def test_dot_precision_census_parses_stablehlo():
    from pyfocusr_tpu.utils.precision import dot_precision_census

    text = "\n".join([
        "%1 = stablehlo.dot_general %a, %b, contracting_dims = [1] x [0], "
        "precision = [HIGHEST, HIGHEST] : (tensor<2x3xf32>, tensor<3x3xf32>)",
        "%2 = stablehlo.dot_general %a, %b, contracting_dims = [1] x [0], "
        "precision = [HIGH, HIGHEST] : (tensor<2x3xf32>, tensor<3x3xf32>)",
        "%3 = stablehlo.dot_general %a, %b, contracting_dims = [1] x [0] "
        ": (tensor<2x3xf32>, tensor<3x3xf32>)",
        "%4 = stablehlo.add %a, %b : tensor<2x3xf32>",
    ])
    assert dot_precision_census(text) == {"HIGHEST": 1, "HIGH": 1, "DEFAULT": 1}
