"""What the benchmark may import: no module whose top-level name is
jax, jaxlib, flax or the JAX package (compared whole: the port's name
begins with the JAX package's), and in reference/ nothing of the port."""
import ast
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "port_bench")
FORBIDDEN = {"jax", "jaxlib", "flax", "hipt_abmil_atec23_tpu"}
PORT = "hipt_abmil_atec23_tpu_torch"


def sources(sub=""):
    for dirpath, _, names in os.walk(os.path.join(BENCH, sub)):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)


def imported(path):
    """Top-level names of every module the file imports, anywhere in it."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0], node.module


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    bad = {top for top, _ in imported(path)} & FORBIDDEN
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_is_independent_of_the_port(path):
    for top, full in imported(path):
        assert top != PORT, f"{path} imports {full}"
        if top == "port_bench":
            assert full.startswith("port_bench.reference"), full


def test_the_check_compares_whole_names(monkeypatch):
    sys.path.insert(0, ROOT)
    from port_bench.harness import forbidden_modules
    before = set(forbidden_modules())
    monkeypatch.setitem(sys.modules, PORT + ".engine", object())
    monkeypatch.setitem(sys.modules, "jaxlike", object())
    assert set(forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "flax.core", object())
    monkeypatch.setitem(sys.modules, "hipt_abmil_atec23_tpu.ops", object())
    assert set(forbidden_modules()) == before | {"flax",
                                                 "hipt_abmil_atec23_tpu"}
