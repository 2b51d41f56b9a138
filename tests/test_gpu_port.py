"""The program runs on a GPU as it does here: no TPU-only kernel, no code
path chosen for a TPU, one compile-cache location, configuration files
read without a YAML library, and a chip smoke check that refuses to run
without a GPU."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "vslam_tpu"
CONFIGS = sorted((ROOT / "configurations").glob("*.yaml"))


def _sources():
    return [(p, p.read_text()) for p in sorted(PKG.rglob("*.py"))]


def test_no_module_imports_tpu_pallas():
    pat = re.compile(r"pallas\.tpu|pallas import tpu|\bpltpu\b")
    hits = [str(p) for p, src in _sources() if pat.search(src)]
    assert not hits, hits


def test_no_code_path_selected_for_tpu():
    pat = re.compile(
        r"default_backend\(\)\s*(==|!=|in|not in)\s*[(\[]?[^)\]\n]*[\"']tpu[\"']"
        r"|platform\s*(==|!=)\s*[\"']tpu[\"']"
    )
    hits = [str(p) for p, src in _sources() if pat.search(src)]
    assert not hits, hits


def test_compile_cache_follows_environment(monkeypatch, tmp_path):
    import jax

    from vslam_tpu.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert compile_cache.enable() == str(tmp_path)
    assert calls == []


def test_compile_cache_defaults_to_fixed_repo_path(monkeypatch):
    import jax

    from vslam_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = str(ROOT / ".jax_cache")
    assert compile_cache.enable() == want
    assert compile_cache.enable() == want
    assert jax.config.jax_compilation_cache_dir == want


@pytest.mark.parametrize("path", CONFIGS, ids=[p.name for p in CONFIGS])
def test_yaml_subset_reader_matches_pyyaml(path, monkeypatch):
    yaml = pytest.importorskip("yaml")
    from vslam_tpu.io import config as cfg_mod

    text = path.read_text()
    assert cfg_mod.parse_yaml_subset(text) == yaml.safe_load(text)
    ours = cfg_mod.load_config(str(path))
    monkeypatch.setattr(cfg_mod, "parse_yaml_subset", yaml.safe_load)
    theirs = cfg_mod.load_config(str(path))
    assert ours == theirs
    assert ours.explicit_keys == theirs.explicit_keys


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_main_path_imports_without_optional_libraries():
    """PyYAML, cv2 and matplotlib are not needed to load a configuration,
    build the engine or reach the CLI."""
    code = (
        "import sys\n"
        "for m in ('yaml', 'cv2', 'matplotlib'):\n"
        "    sys.modules[m] = None\n"
        "import vslam_tpu.system.engine, vslam_tpu.system.cli, vslam_tpu.io.datasets\n"
        "from vslam_tpu.io import config\n"
        f"config.load_config({str(ROOT / 'configurations' / 'configuration_kitti.yaml')!r})\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
