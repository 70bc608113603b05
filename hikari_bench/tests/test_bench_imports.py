"""No run and no part of the reference loads ``jax``, ``jaxlib``, ``flax``
or the JAX package (top-level names compared whole: the port's name starts
with the JAX package's), and the reference loads nothing of the port."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from hikari_bench import run

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def test_names_are_compared_whole():
    mods = ["hikari_tpu_torch", "hikari_tpu_torch.render", "jaxtyping", "hikari_bench"]
    assert run.forbidden_modules(mods) == []
    assert run.forbidden_modules(mods + ["jax.numpy", "jaxlib", "flax", "hikari_tpu.trace"]) == [
        "flax", "hikari_tpu.trace", "jax.numpy", "jaxlib"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_sources_import_neither_jax_nor_the_jax_package():
    for path in HERE.rglob("*.py"):
        for name in _imports(path):
            top = name.split(".", 1)[0]
            assert top not in run.FORBIDDEN, f"{path}: imports {name}"
            if "reference" in path.relative_to(HERE).parts:
                assert top != "hikari_tpu_torch", f"{path}: the reference imports {name}"


PROBE = r"""
import json, sys
sys.path.insert(0, {root!r})
from hikari_bench import run
{body}
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""

SHRINK = r"""
def shrink(c):
    c = json.loads(json.dumps(c))
    c["settings"]["width"], c["settings"]["height"] = 32, 24
    return c
"""


def _loaded(body: str):
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT), body=body)],
                         capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    body = SHRINK + "run.run('cornell1080_view', 5, 0.0, True, device='cpu', shrink=shrink)"
    loaded = _loaded(body)
    assert "hikari_tpu_torch" in loaded
    assert not loaded & set(run.FORBIDDEN), loaded & set(run.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    """Every module of the reference, and a frame of the reference of
    each configuration: the benchmark's and the CPU tests' city (a scene
    over 2,048 triangles that ``reference_scene`` names)."""
    city = json.loads((HERE / "tests" / "city8_test.json").read_text())
    body = SHRINK + (
        "from hikari_bench import check, spec\n"
        "import pkgutil, importlib, hikari_bench.reference as R\n"
        "for m in pkgutil.walk_packages(R.__path__, 'hikari_bench.reference.'):\n"
        "    importlib.import_module(m.name)\n"
        "configs = [json.loads((spec.ROOT / c['file']).read_text())\n"
        "           for c in spec.load_benchmark()['configs']]\n"
        "settings = configs[0]['settings']\n"
        f"configs.append(dict(json.loads({json.dumps(city)!r}), settings=settings))\n"
        "for c in configs:\n"
        "    ref = check.Reference(shrink(c), 'cpu')\n"
        "    ref.render(ref.initial_state(3))\n")
    loaded = _loaded(body)
    assert not loaded & (set(run.FORBIDDEN) | {"hikari_tpu_torch"}), loaded


def test_a_reference_scene_outside_the_reference_is_refused():
    from hikari_bench import scenes, spec

    config = json.loads((spec.ROOT / spec.load_benchmark()["configs"][0]["file"]).read_text())
    for module in ("hikari_tpu_torch.io.scenes", "hikari_bench.tests.elsewhere",
                   "hikari_bench.referenceX.io"):
        own = dict(config, reference_scene={"module": module, "fn": "cornell_config"})
        with pytest.raises(ValueError, match="outside"):
            scenes.build(own, scenes.REFERENCE, "cpu")
