"""The port's rule on imports: no module of ``repro_torch`` and not
``chip_smoke.py`` imports JAX (``jax``, ``jaxlib``) or anything of the
reference package ``repro`` (``repro_torch`` is the port itself).  The
card's machine has no JAX, and the port keeps its own copies of what it
needs.  Each file is parsed with ``ast``, so an import inside a function
counts as much as one at the top.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted(p.relative_to(ROOT).as_posix()
               for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
FILES.append("chip_smoke.py")
FORBIDDEN = ("jax", "jaxlib", "repro")


def forbidden_imports(source: str) -> list:
    """Names of the forbidden modules that ``source`` imports."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [n for n in names if n.split(".")[0] in FORBIDDEN]
    return found


@pytest.mark.parametrize("path", FILES)
def test_port_imports_neither_jax_nor_the_reference(path):
    assert forbidden_imports((ROOT / path).read_text()) == []


def test_the_rule_catches_each_form():
    for src in ("import jax", "import jax.numpy as jnp", "import jaxlib",
                "from repro.kernels import ops", "import repro.models",
                "from jax import numpy", "def f():\n    import repro\n"):
        assert forbidden_imports(src), src
    for src in ("import repro_torch", "from repro_torch.kernels import ops",
                "from . import ref", "import reprolib"):
        assert not forbidden_imports(src), src
    assert len(FILES) > 30 and "src/repro_torch/kernels/ssd_scan.py" in FILES
