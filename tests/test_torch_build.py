"""The kernel build's identity: a library is named by a hash of its
source, of every header the source can include (the shared
``kernels/csrc/`` and its own ``csrc/``) and of the flags, so that an
edited header never loads a stale library. These run on a copy of the
sources and need no ``nvcc``: the compiler is replaced by a stub that
records its command line.
"""

import shutil
import subprocess

import pytest

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.matmul import matmul

KERNELS = {"matmul": matmul, "flash_attention": flash_attention}


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A copy of the shared headers and of each kernel's ``csrc/``, with
    the build pointed at it; returns {name: copied source}."""
    shared = tmp_path / "kernels" / "csrc"
    shutil.copytree(build.SHARED_INCLUDE, shared)
    monkeypatch.setattr(build, "SHARED_INCLUDE", shared)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    sources = {}
    for name, mod in KERNELS.items():
        csrc = tmp_path / "kernels" / name / "csrc"
        shutil.copytree(mod.SOURCE.parent, csrc)
        sources[name] = csrc / mod.SOURCE.name
    return sources


def test_every_dmma_source_includes_the_shared_header():
    assert (build.SHARED_INCLUDE / "dmma.cuh").is_file()
    for mod in KERNELS.values():
        assert '#include "dmma.cuh"' in mod.SOURCE.read_text()


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_unchanged_tree_gives_the_same_target(tree, name):
    first = build._target(tree[name])
    assert build._target(tree[name]) == first
    assert first.parent == build.BUILD_DIR
    assert first.name.startswith(f"lib{tree[name].stem}-")


@pytest.mark.parametrize("name", sorted(KERNELS))
@pytest.mark.parametrize("where", ["shared", "own"])
def test_header_edit_changes_the_target(tree, name, where):
    """An edit of the shared header, or a header added beside the
    source, renames the library; undoing it restores the name."""
    before = build._target(tree[name])
    if where == "shared":
        header = build.SHARED_INCLUDE / "dmma.cuh"
        text = header.read_text()
        header.write_text(text + "\n// edited\n")
        assert build._target(tree[name]) != before
        header.write_text(text)
    else:
        header = tree[name].parent / "extra.cuh"
        header.write_text("#pragma once\n")
        assert build._target(tree[name]) != before
        header.unlink()
    assert build._target(tree[name]) == before


def test_source_edit_changes_the_target(tree):
    src = tree["matmul"]
    before = build._target(src)
    src.write_text(src.read_text() + "\n")
    assert build._target(src) != before


def test_build_puts_both_header_directories_on_the_include_path(
        tree, monkeypatch):
    calls = []

    def fake_run(cmd, **kwargs):
        calls.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"")
        return subprocess.CompletedProcess(cmd, 0, "ptxas info", "")

    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", fake_run)
    src = tree["flash_attention"]
    lib, log, _ = build.build(src)
    assert lib == build._target(src) and lib.exists()
    assert log == "ptxas info"
    (cmd,) = calls
    assert f"-I{src.parent}" in cmd
    assert f"-I{build.SHARED_INCLUDE}" in cmd
    assert cmd[-1] == str(src)
    # built once: a second call only finds the library
    assert build.build(src)[2] == 0.0 and len(calls) == 1
