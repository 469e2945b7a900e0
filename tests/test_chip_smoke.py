"""``chip_smoke.py`` at tiny sizes on the CPU: each phase's path and its
numpy comparison, the GPU check, and the refusal of ``chip_smoke.py``
and ``bench.py`` to run (or print a result) without a GPU."""
import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

CARD = "test-card, 0 W"


@pytest.fixture
def cpu():
    return jax.devices("cpu")[0]


def test_require_gpu_refuses_cpu(cpu):
    from vacv_tpu.utils.perf import require_gpu

    with pytest.raises(RuntimeError, match="needs a GPU"):
        require_gpu([cpu])


def test_phase_cfg4_tiny(cpu, capsys):
    res = chip_smoke.phase_cfg4(cpu, CARD, batch=2, h=72, w=96,
                                rect=(4, 2, 92, 66), out=32)
    assert res["max_abs_f32"] <= chip_smoke.NORM_ATOL
    out = capsys.readouterr().out
    assert "phase cfg4_1080p:" in out and "u8_mismatches=0" in out
    assert "memory_analysis" in out and f"[card: {CARD}]" in out


def test_phase_nv21_tiny(cpu, capsys):
    res = chip_smoke.phase_nv21(cpu, CARD, batch=2, h=64, w=96,
                                rect=(4, 6, 92, 54), tops=(0, 6, 16),
                                out=32)
    assert res["top_err"] <= chip_smoke.NORM_ATOL
    assert "programs_for_tops=1" in capsys.readouterr().out


def test_phase_cfg5_tiny(cpu, capsys):
    res = chip_smoke.phase_cfg5(cpu, CARD, batch=2, h=96, w=160,
                                rect=(4, 4, 156, 92), dsize=(76, 44),
                                out=32)
    assert res["warp_share"] < chip_smoke.WARP_LSB_SHARE
    assert "phase cfg5_warp:" in capsys.readouterr().out


def test_phase_qcif_tiny(cpu, capsys):
    chip_smoke.phase_qcif(cpu, CARD, batch=4)
    assert "u8_mismatches=0" in capsys.readouterr().out


def test_phase_serve_tiny(cpu, capsys):
    res = chip_smoke.phase_serve(cpu, CARD, n=6, depth=4, h=64, w=96,
                                 rect=(4, 2, 92, 62), out=32)
    assert res["max_abs"] <= 1e-5
    assert "phase serve:" in capsys.readouterr().out


def test_phase_four_tiny(capsys):
    """The sharded phase on four virtual CPU devices."""
    devices = jax.devices("cpu")[:4]
    res = chip_smoke.phase_four(devices, CARD, per_dev=2, h=64, w=96,
                                rect=(4, 2, 92, 62), out=32)
    assert res["max_abs"] <= 1e-5
    assert "devices=4" in capsys.readouterr().out


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_result(proc):
    return proc.returncode != 0 and '"ok": true' not in proc.stdout


def test_main_fails_without_gpu():
    assert _no_result(_run(["chip_smoke.py"], ROOT))


def test_bench_fails_without_gpu():
    assert _no_result(_run(["bench.py", "--reps", "1"], ROOT))


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    assert _no_result(_run(["chip_smoke.py"], tmp_path,
                           {"PYTHONPATH": ""}))


def test_last_line_format(monkeypatch, capsys):
    """With the GPU check and the phases stubbed, main's last line is
    the one-object JSON result naming the device."""
    class Dev:
        platform, device_kind = "gpu", "Fake GPU"

    import vacv_tpu.utils.perf as perf

    monkeypatch.setattr(jax, "devices", lambda *a: [Dev()])
    monkeypatch.setattr(perf, "card_info", lambda: CARD)
    for name in ("phase_cfg4", "phase_nv21", "phase_cfg5", "phase_qcif",
                 "phase_serve"):
        monkeypatch.setattr(chip_smoke, name, lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "phase_gpu_tests", lambda card: None)
    import vacv_tpu.config as vconfig

    monkeypatch.setattr(vconfig, "enable_compile_cache", lambda: "")
    assert chip_smoke.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "Fake GPU", "count": 1}}
    assert f"card: {CARD}" in lines
