"""The port stands alone: it imports neither ``jax`` nor any module of the
JAX package ``tagdust_tpu``, and its default engine needs the card.

* an AST scan of every module of ``tagdust_tpu_torch`` and of the three
  scripts that drive it on the card;
* a subprocess that runs a small ``-engine torch`` demultiplex through the
  CLI, ``-arch`` detection, the ``-ref`` artifact filter (the plain Myers
  lanes) and a ``-start/-end`` decode (the label-carrying rows) included,
  and then finds neither ``jax`` nor ``tagdust_tpu`` in ``sys.modules``;
* a subprocess that imports the auxiliary tools, the Myers module and the
  training modules (``engine.train``, ``parallel.mesh``) and finds the same;
* a subprocess in which ``torch.cuda.is_available`` is False: the default
  ``-engine auto`` raises, as ``-engine cuda`` does (decided in the
  subprocess, so every test worker collects the same tests).
"""

import ast
import glob
import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(
    glob.glob(os.path.join(_REPO, "tagdust_tpu_torch", "**", "*.py"), recursive=True)
) + [os.path.join(_REPO, f) for f in ("chip_smoke.py", "profile_smoke.py", "step_profile.py")]


def _foreign(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "tagdust_tpu")


def _imports(path: str) -> list:
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append(node.module)
    return out


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    assert len(FILES) > 30
    bad = {os.path.relpath(f, _REPO): [m for m in _imports(f) if _foreign(m)]
           for f in FILES}
    assert not {f: m for f, m in bad.items() if m}


_RUN = """
import json, sys
from tagdust_tpu_torch.cli.tagdust import main
import tagdust_tpu_torch.controller, tagdust_tpu_torch.detect
main(sys.argv[1:])
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "tagdust_tpu"))))
"""


def _env():
    from conftest import spawn_env

    return spawn_env(rtest=False)


def test_a_demultiplex_loads_no_module_of_jax(tmp_path):
    from test_torch_cli import ARCH_FILE, ARCHS, write_fastq

    fq = str(tmp_path / "in.fq")
    write_fastq(fq, 120, seed=3)
    arch = tmp_path / "arch.txt"
    arch.write_text(ARCH_FILE)
    contam = tmp_path / "contam.fa"
    contam.write_text(">adapter1\nACGTACGTACGTACGTACGT\n")
    for n, args in enumerate((
            ARCHS["barcode"], ["-arch", str(arch)],
            [*ARCHS["barcode"], "-ref", str(contam)],
            [*ARCHS["barcode"], "-start", "1", "-end", "30"])):
        out = str(tmp_path / f"o{n}")
        res = subprocess.run(
            [sys.executable, "-c", _RUN, *args, fq, "-Q", "10", "-o", out,
             "-engine", "torch"],
            check=True, capture_output=True, text=True, cwd=_REPO, env=_env())
        assert res.stdout.strip().splitlines()[-1] == "[]"
        assert os.path.getsize(out + "_un.fq") > 0


_TOOLS = """
import json, sys
import tagdust_tpu_torch.cli.simreads, tagdust_tpu_torch.cli.evalres
import tagdust_tpu_torch.cli.merge_tool, tagdust_tpu_torch.cli.rename_qiime
import tagdust_tpu_torch.engine.myers
import tagdust_tpu_torch.engine.train, tagdust_tpu_torch.parallel.mesh
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "tagdust_tpu"))))
"""


def test_the_tools_and_the_myers_module_load_no_module_of_jax():
    names = {os.path.relpath(f, _REPO) for f in FILES}
    for tool in ("simreads", "evalres", "merge_tool", "rename_qiime"):
        assert f"tagdust_tpu_torch/cli/{tool}.py" in names
    for mod in ("engine/myers.py", "engine/train.py", "parallel/mesh.py"):
        assert f"tagdust_tpu_torch/{mod}" in names
    res = subprocess.run([sys.executable, "-c", _TOOLS], check=True,
                         capture_output=True, text=True, cwd=_REPO, env=_env())
    assert res.stdout.strip().splitlines()[-1] == "[]"


_NO_CARD = """
import sys, torch
torch.cuda.is_available = lambda: False
from tagdust_tpu_torch.cli.tagdust import main
try:
    main(sys.argv[1:])
except RuntimeError as e:
    print("raised:", e)
    sys.exit(3)
"""


@pytest.mark.parametrize("engine", [[], ["-engine", "auto"], ["-engine", "cuda"]],
                         ids=["default", "auto", "cuda"])
def test_default_engine_needs_the_card(tmp_path, engine):
    from test_torch_cli import ARCHS, write_fastq

    fq = str(tmp_path / "in.fq")
    write_fastq(fq, 20, seed=3)
    res = subprocess.run(
        [sys.executable, "-c", _NO_CARD, *ARCHS["barcode"], fq, "-Q", "10", "-o",
         str(tmp_path / "o"), *engine],
        capture_output=True, text=True, cwd=_REPO, env=_env())
    assert res.returncode == 3, res.stderr[-2000:]
    assert "no CUDA device" in res.stdout
    assert not os.path.exists(str(tmp_path / "o_un.fq"))
