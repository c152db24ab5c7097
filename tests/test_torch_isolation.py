"""The port stands alone: no file of ladder_tpu_torch/, and neither
chip_smoke.py nor kernel_times.py, imports jax, flax, msgpack or
ladder_tpu, and the package imports with those modules blocked. The
kernels' shared build helper keys a library by its source and flags."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "msgpack", "ladder_tpu", "sklearn",
             "scipy"}
SOURCES = sorted((ROOT / "ladder_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "kernel_times.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = FORBIDDEN.intersection(_imported_roots(path))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_package_imports_with_jax_blocked():
    blocked = "; ".join(f"sys.modules[{m!r}] = None" for m in sorted(FORBIDDEN))
    code = (
        "import sys, importlib, pkgutil\n"
        f"{blocked}\n"
        "import ladder_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    ladder_tpu_torch.__path__, 'ladder_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert int(proc.stdout.split()[-1]) >= 24


def test_sources_cover_the_training_slice():
    covered = {str(p.relative_to(ROOT)) for p in SOURCES}
    for name in ("training/__init__.py", "training/schedules.py",
                 "training/optim.py", "training/losses.py",
                 "training/step.py", "ops/_build.py", "ops/adam.py",
                 "ops/output_stage.py", "ops/norm_chain.py",
                 "utils/device.py"):
        assert f"ladder_tpu_torch/{name}" in covered


def test_sources_cover_the_mnist_slice():
    covered = {str(p.relative_to(ROOT)) for p in SOURCES}
    for name in ("train.py", "training/trainer.py", "models/mnist.py",
                 "ops/gmm.py", "data/__init__.py", "data/mnist.py",
                 "utils/metrics.py", "utils/checkpoint.py",
                 "utils/profiling.py", "utils/config.py"):
        assert f"ladder_tpu_torch/{name}" in covered


def test_sources_cover_the_celeba_slice():
    covered = {str(p.relative_to(ROOT)) for p in SOURCES}
    for name in ("runtime/__init__.py", "data/tfrecord.py", "data/celeba.py",
                 "training/celeba_trainer.py", "serving/bn_freeze.py",
                 "freeze_bn.py"):
        assert f"ladder_tpu_torch/{name}" in covered


def test_the_native_reader_is_the_ports_own():
    """ladder_tpu_torch/runtime holds its own copy of the C++ reader (the
    same source as ladder_tpu's), imports nothing of ladder_tpu.runtime,
    and builds its library under ladder_tpu_torch/_build/, never beside
    ladder_tpu's source."""
    from ladder_tpu_torch import runtime

    pkg = ROOT / "ladder_tpu_torch"
    assert runtime.SOURCE == pkg / "runtime" / "tfrecord_reader.cc"
    assert runtime.LIBRARY.parent == pkg / "_build"
    theirs = (ROOT / "ladder_tpu" / "runtime" / "tfrecord_reader.cc")
    code = [ln for ln in runtime.SOURCE.read_text().splitlines()
            if not ln.startswith("//")]
    assert code == [ln for ln in theirs.read_text().splitlines()
                    if not ln.startswith("//")]
    runtime.load()
    assert runtime.LIBRARY.is_file()
    assert "ladder_tpu" not in set(_imported_roots(
        pkg / "runtime" / "__init__.py"))


def test_kernel_sources_include_no_torch_headers():
    """The kernels have a plain C interface: a source that pulled in
    PyTorch's headers would take minutes to compile."""
    sources = sorted((ROOT / "ladder_tpu_torch" / "csrc").glob("*.cu"))
    assert [p.stem for p in sources] == ["adam", "norm_chain", "output_stage"]
    for path in sources:
        text = path.read_text()
        includes = [ln for ln in text.splitlines() if ln.startswith("#include")]
        assert includes and all(
            inc.split("<")[1].startswith("cuda") for inc in includes)
        assert f'extern "C" const char* {path.stem}_error_string' in text


def test_build_cache_key_hashes_source_and_flags(tmp_path, monkeypatch):
    from ladder_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    (tmp_path / "toy.cu").write_text("// one\n")
    lib = _build.KernelLibrary("toy", {"toy_run": []})
    first = lib.path()
    assert first.parent == tmp_path / "_build"
    assert first.name.startswith("libtoy_") and first.suffix == ".so"
    assert lib.path() == first                       # stable
    (tmp_path / "toy.cu").write_text("// two\n")
    second = lib.path()
    assert second != first                           # the source is hashed
    other = _build.KernelLibrary("toy", {"toy_run": []},
                                 flags=_build.NVCC_FLAGS + ("-lineinfo",))
    assert other.path() not in (first, second)       # and so are the flags
    assert lib.loaded is None


def test_build_uses_what_is_built_and_reports_a_failing_compiler(
        tmp_path, monkeypatch):
    from ladder_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    (tmp_path / "toy.cu").write_text("// toy\n")
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'toy.cu(1): error: no' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    lib = _build.KernelLibrary("toy", {"toy_run": []})
    with pytest.raises(RuntimeError, match="error: no"):
        lib.build()
    assert not list((tmp_path / "_build").glob("*.so"))  # nothing half-built
    lib.path().write_bytes(b"built earlier")
    assert lib.build() == (lib.path(), "")
    assert _build.build_all([lib]) == {"toy": (lib.path(), "")}


def test_the_kernel_modules_share_the_build_helper():
    from ladder_tpu_torch.ops import _build, adam, norm_chain, output_stage

    libs = [m.LIBRARY for m in (norm_chain, output_stage, adam)]
    assert all(isinstance(lib, _build.KernelLibrary) for lib in libs)
    assert [lib.source.name for lib in libs] == [
        "norm_chain.cu", "output_stage.cu", "adam.cu"]
    assert len({lib.path() for lib in libs}) == 3
    assert all(lib.source.is_file() and lib.flags == _build.NVCC_FLAGS
               for lib in libs)


def test_sources_cover_the_interpolation_slice():
    covered = {str(p.relative_to(ROOT)) for p in SOURCES}
    for name in ("interp.py", "demo_tools.py", "interpolate.py",
                 "utils/plotting.py"):
        assert f"ladder_tpu_torch/{name}" in covered


def _module_level_imports(path):
    """The roots a module imports when it is imported: its top-level
    statements, with the bodies of top-level if/try blocks, not its
    functions or classes."""
    body = list(ast.parse(path.read_text(), filename=str(path)).body)
    while body:
        node = body.pop()
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, (ast.If, ast.Try, ast.With)):
            for field in ("body", "orelse", "finalbody", "handlers"):
                body.extend(getattr(node, field, []))
        elif isinstance(node, ast.ExceptHandler):
            body.extend(node.body)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_matplotlib_is_imported_inside_functions_only(path):
    """The card's machine has no matplotlib: the demo's plot writers
    import it when they run, never when their module is imported."""
    assert "matplotlib" not in set(_module_level_imports(path))


def test_package_imports_without_matplotlib():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['matplotlib'] = None\n"
        "import ladder_tpu_torch\n"
        "for m in pkgutil.walk_packages(ladder_tpu_torch.__path__,\n"
        "                               'ladder_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from ladder_tpu_torch.utils.plotting import pyplot\n"
        "try:\n"
        "    pyplot()\n"
        "except ImportError as e:\n"
        "    print(e)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "matplotlib" in proc.stdout
