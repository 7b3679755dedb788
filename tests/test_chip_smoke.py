"""The CPU-side contract of ``chip_smoke.py``: no GPU means no result, the
last line carries exactly the keys the contract names, and a failing phase
makes the exit code nonzero."""

import json
import os
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def test_device_phase_refuses_cpu(capsys):
    with pytest.raises(chip_smoke.NoAccelerator, match="no GPU"):
        chip_smoke.require_gpu()
    assert chip_smoke.main([]) == 2
    assert capsys.readouterr().out == ""


def test_last_line_has_exactly_the_contract_keys():
    line = chip_smoke.final_line(True, jax.devices())
    assert json.loads(json.dumps(line)) == line
    assert set(line) == {"ok", "device"}
    assert set(line["device"]) == {"platform", "kind", "count"}
    assert line["device"]["count"] == len(jax.devices())


def test_failing_phase_makes_exit_nonzero(monkeypatch, capsys):
    """A failed check, and a phase that raises, each fail the run; later
    phases still run and the last line reports ``ok: false``."""
    monkeypatch.setattr(
        chip_smoke, "require_gpu", lambda: (jax.devices(), "Fake GPU, 1 W")
    )

    def bad_check(ph):
        ph.check("always_false", 0, 1, "==")

    def raises(ph):
        raise RuntimeError("boom")

    ran = []
    monkeypatch.setattr(chip_smoke, "phase_register_40k", bad_check)
    monkeypatch.setattr(chip_smoke, "phase_class_api_10k", raises)
    monkeypatch.setattr(
        chip_smoke, "phase_reference_10k", lambda ph: ran.append(1)
    )
    rc = chip_smoke.main(
        ["--phases", "register_40k,class_api_10k,reference_10k"]
    )
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 1 and ran == [1]
    phases = [json.loads(ln) for ln in out[:-2]]
    assert [p["ok"] for p in phases] == [False, False, True]
    assert phases[1]["error"] == "RuntimeError: boom"
    assert all(p["gpu"] == "Fake GPU, 1 W" for p in phases)
    assert out[-2] == "Fake GPU, 1 W"
    last = json.loads(out[-1])
    assert last["ok"] is False and set(last) == {"ok", "device"}
