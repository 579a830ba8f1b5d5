"""When the port's kernel builder rebuilds a library
(hipt_abmil_atec23_tpu_torch/kernels/build.py): a source, or any csrc/*.cuh
header it may include, newer than lib<name>.so forces a rebuild; nothing
else does. Pure file-time logic, so it runs without nvcc."""
import os

import pytest

from hipt_abmil_atec23_tpu_torch.kernels import build


@pytest.fixture
def tree(tmp_path):
    """A csrc-like directory with two sources and a shared header, and a
    library built after all of them."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in ("fused_block.cu", "fused_network.cu", "vit_block.cuh",
              "notes.txt"):
        (csrc / f).write_text("//\n")
        os.utime(csrc / f, (1000, 1000))
    so = tmp_path / "libfused_block.so"
    so.write_bytes(b"")
    os.utime(so, (2000, 2000))
    return csrc, str(so)


def test_sources_are_the_source_and_every_header(tree):
    csrc, _ = tree
    assert build.sources("fused_block", str(csrc)) == [
        str(csrc / "fused_block.cu"), str(csrc / "vit_block.cuh")]


@pytest.mark.parametrize("touched,rebuild", [
    (None, False),
    ("vit_block.cuh", True),
    ("fused_block.cu", True),
    ("fused_network.cu", False),   # another library's source
    ("notes.txt", False)])
def test_rebuild_only_when_a_dependency_is_newer(tree, touched, rebuild):
    csrc, so = tree
    if touched:
        os.utime(csrc / touched, (3000, 3000))
    assert build.stale(so, build.sources("fused_block", str(csrc))) \
        is rebuild


def test_a_missing_library_is_built(tree):
    csrc, so = tree
    os.remove(so)
    assert build.stale(so, build.sources("fused_block", str(csrc)))


def test_the_package_sources_name_the_shared_header():
    """Both block kernels include csrc/vit_block.cuh, so it is among the
    dependencies of each."""
    for name in ("fused_block", "fused_network"):
        deps = build.sources(name)
        assert os.path.join(build.CSRC_DIR, "vit_block.cuh") in deps
        assert all(os.path.exists(p) for p in deps)
        with open(deps[0]) as f:
            assert '#include "vit_block.cuh"' in f.read()
