"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole, so the port, whose name begins with the JAX
package's, is not caught), and the plain reference imports nothing of the
port either."""
import ast
import os

from benchmark import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "llm_instance_gateway_tpu"}
PORT = "llm_instance_gateway_tpu_torch"


def _tops(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module.split(".")[0]


def _sources():
    for d, _, files in os.walk(spec.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    bad = {p: sorted(set(_tops(p)) & FORBIDDEN) for p in _sources()}
    assert not {p: b for p, b in bad.items() if b}


def test_reference_imports_nothing_of_the_port():
    for name in ("reference.py", "roofline.py", "generator.py"):
        tops = set(_tops(os.path.join(spec.HERE, name)))
        assert PORT not in tops and not tops & FORBIDDEN, name


def test_the_check_is_whole_names():
    from benchmark import run
    import sys
    before = set(sys.modules)
    sys.modules.setdefault("llm_instance_gateway_tpu_torch_x", object())
    try:
        assert "llm_instance_gateway_tpu_torch_x" not in run.forbidden_modules()
    finally:
        if "llm_instance_gateway_tpu_torch_x" not in before:
            del sys.modules["llm_instance_gateway_tpu_torch_x"]
