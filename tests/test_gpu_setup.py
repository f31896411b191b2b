"""What the GPU path needs from its surroundings, checked on the CPU: the
compile-cache location rule, native builds keyed to their sources and
host, and chip_smoke.py refusing to run without a GPU."""

import os
import subprocess
import sys

import pytest

from blasr_tpu import hostcache, native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert hostcache.compile_cache_dir() == str(tmp_path)


def test_compile_cache_default_is_fixed_repo_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert hostcache.compile_cache_dir() == os.path.join(REPO, ".jax_cache")


def test_native_library_keyed_by_source_and_host(monkeypatch, tmp_path):
    src = tmp_path / "k.c"
    src.write_text("int k(void) { return 1; }\n")
    cmd = ["cc", "-shared", "-fPIC"]
    a = native.library_path("k", [str(src)], cmd)
    assert os.path.dirname(a) == native.BUILD_DIR
    src.write_text("int k(void) { return 2; }\n")
    b = native.library_path("k", [str(src)], cmd)
    monkeypatch.setattr(native, "host_cache_key", lambda: "another-host")
    c = native.library_path("k", [str(src)], cmd)
    assert len({a, b, c}) == 3


def test_native_build_is_written_once(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    src = tmp_path / "k.c"
    src.write_text("int k(void) { return 7; }\n")
    cmd = ["cc", "-shared", "-fPIC"]
    path = native.build_library("k", [str(src)], cmd)
    assert os.path.exists(path) and os.listdir(tmp_path / "build") == [
        os.path.basename(path)]
    mtime = os.path.getmtime(path)
    assert native.build_library("k", [str(src)], cmd) == path
    assert os.path.getmtime(path) == mtime
    src.write_text("int k(void) { return }\n")  # a syntax error
    with pytest.raises(subprocess.SubprocessError, match="failed"):
        native.build_library("k", [str(src)], cmd)


@pytest.mark.parametrize("where", ["checkout", "bare"])
def test_chip_smoke_refuses_without_gpu(where, tmp_path):
    """On the CPU, and from a directory holding only chip_smoke.py, the
    script exits non-zero and prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "bare":
        bare = tmp_path / "chip_smoke.py"
        bare.write_text(open(script).read())
        script = str(bare)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, script], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
