"""The port imports nothing of JAX: every ``.py`` under
``gnnbuilder_tpu_torch/``, and ``chip_smoke.py``, parsed with ``ast``,
has no ``import`` or ``from ... import`` of ``jax``, ``flax``, ``optax``
or ``gnnbuilder_tpu`` (``gnnbuilder_tpu_torch`` is the port itself)."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "optax", "gnnbuilder_tpu")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "gnnbuilder_tpu_torch")):
        out += [os.path.join(d, f) for f in sorted(files)
                if f.endswith(".py")]
    return sorted(out)


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_sources_found():
    names = {os.path.relpath(p, ROOT) for p in _sources()}
    assert "chip_smoke.py" in names
    assert os.path.join("gnnbuilder_tpu_torch", "parallel",
                        "halo.py") in names
    assert len(names) > 50


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = [m for m in _imported(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
