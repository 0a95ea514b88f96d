"""The benchmark measures the port alone: no JAX, and not the JAX
package, whose top-level name ``radian_tpu`` is a prefix of the port's
(``radian_tpu_torch``), so names are compared whole, up to the first dot."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "radian_tpu"})
PROGRAM = "radian_tpu_torch"


def top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m in mods if top(m) in FORBIDDEN)


def imported_names(path: Path) -> set[str]:
    """Every module a Python file imports, by its full dotted name."""
    tree = ast.parse(Path(path).read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            out.add(node.module)
    return out


def source_faults(bench_dir: Path) -> list[str]:
    """What the benchmark's own sources get wrong: an import of a
    forbidden module anywhere, the program imported by the reference or
    the yardstick (``core/``, which the program must not steer), or a
    path into ``bench_data/``."""
    faults = []
    for f in sorted(Path(bench_dir).rglob("*.py")):
        names = imported_names(f)
        rel = f.relative_to(bench_dir)
        for n in sorted(names):
            if top(n) in FORBIDDEN:
                faults.append(f"{rel}: imports {n}")
            if top(n) == PROGRAM and rel.parts[0] == "core":
                faults.append(f"{rel}: the yardstick imports {n}")
        if ("bench_data" in f.read_text() and rel.parts[0] != "tests"
                and f.resolve() != Path(__file__).resolve()):
            faults.append(f"{rel}: names bench_data")
    return faults
