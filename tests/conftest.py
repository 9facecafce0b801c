import importlib.util
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# Gate the optional `hypothesis` dependency: the CI image only bakes the
# jax_pallas toolchain, so when hypothesis is absent install the minimal
# deterministic fallback (tests/_hypothesis_fallback.py) before any test
# module imports it. The real package wins whenever it is installed.
try:
    import hypothesis  # noqa: F401
except ImportError:
    _spec = importlib.util.spec_from_file_location(
        "_hypothesis_fallback",
        os.path.join(os.path.dirname(__file__), "_hypothesis_fallback.py"))
    _mod = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_mod)
    _mod.install()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips, with its reason, without "
                   "one (decided inside the test)")
