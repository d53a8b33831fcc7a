"""Nothing in the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "tagdust_tpu"}


def imports(path):
    """[(top-level name, level)] of every import in ``path``."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(a.name.split(".")[0], 0) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            out.append(((node.module or "").split(".")[0], node.level))
    return out


def modules(root):
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    found = [(p, m) for p in modules(BENCH) for m, lvl in imports(p)
             if lvl == 0 and m in FORBIDDEN]
    assert not found
    # the program's name begins with the JAX package's: compared whole
    assert "tagdust_tpu_torch" not in FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    allowed = {"numpy", "torch", "__future__", "contextlib", "copy", "dataclasses",
               "math", "re", "typing", "itertools", "collections", "functools", "hashlib"}
    for p in modules(ref):
        for m, lvl in imports(p):
            assert m != "tagdust_tpu_torch", p
            assert lvl <= 1, f"{p} imports from outside the reference"
            if lvl == 0:
                assert m in allowed, f"{p} imports {m}"


def test_the_check_finds_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom tagdust_tpu.engine import x\n")
    assert {m for m, _ in imports(str(bad))} == {"jax", "tagdust_tpu"}
