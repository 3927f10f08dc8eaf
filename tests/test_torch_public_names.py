"""Every public top-level name of the JAX package has a counterpart in the
port, module by module, read with `ast` (neither package is imported).

A JAX module's public names are the functions, classes and variables it
defines at its top level without a leading underscore; the port's module
provides a name if it defines or imports it under that name. The JAX
package's factories of compiled programs have counterparts that make the
port's programs (CUDA graphs on the card: the decode chunk, the prefills
and admission steps, the train step). The names the port does not have are
listed below with their reasons: a few divergences kept on purpose
(ROADMAP.md).
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "llark_tpu", ROOT / "llark_tpu_torch"

# module -> {JAX name: (the port's counterpart in the same module, or None; why)}
ABSENT = {
    "parallel/pipeline.py": {
        "pp_param_shardings": ("pp_shard_params", "NamedShardings for GSPMD; a rank of the port "
                                                  "keeps its stage's shards"),
    },
    "encoders/clap/text.py": {
        "init_text_params": ("random_init", "the tower's random weights, drawn from a "
                                            "torch.Generator where the JAX package takes a key"),
    },
    "native/build.py": {
        "log": (None, "a failed native build raises with the compiler's output; the JAX "
                      "package logs a warning and takes its numpy routes"),
    },
    "native/tarloader.py": {
        "available": (None, "the port's native build never fails quietly, so there is no "
                            "availability to ask (ROADMAP.md, divergences)"),
    },
}


def _names(path: pathlib.Path, imports: bool) -> set:
    """Public top-level names a module defines (and, with `imports`, the
    names it imports)."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(n.id for t in node.targets for n in ast.walk(t) if isinstance(n, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in out if not n.startswith("_")}


MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def test_every_jax_module_has_a_counterpart():
    missing = [m for m in MODULES if not (PORT_PKG / m).is_file()]
    assert not missing, f"no counterpart in llark_tpu_torch/: {missing}"
    assert set(ABSENT) <= set(MODULES)


@pytest.mark.parametrize("module", MODULES)
def test_public_names_have_counterparts(module):
    port = PORT_PKG / module
    if not port.is_file():
        pytest.fail(f"llark_tpu_torch/{module} is missing")
    ported = _names(port, imports=True)
    absent = ABSENT.get(module, {})
    missing = _names(JAX_PKG / module, imports=False) - ported - set(absent)
    assert not missing, f"llark_tpu_torch/{module} lacks {sorted(missing)}"
    for name, (counterpart, why) in absent.items():
        assert why
        assert name not in ported, f"{name} is in the port now: take it out of ABSENT"
        if counterpart is not None:
            assert counterpart in ported, f"{module}: {name}'s counterpart {counterpart} is gone"
