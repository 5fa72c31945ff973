"""The kernel build's identity: a library is named by a hash of its
source, of every header the source can include (the shared
``kernels/csrc/``: the float64 and the bf16 tensor-core helpers, and its
own ``csrc/``) and of the flags, so that an edited header never loads a
stale library. The flash attention's backward has a source of its own.
These run on a copy of the sources and need no ``nvcc``: the compiler
is replaced by a stub that records its command line.
"""

import shutil
import subprocess
from types import SimpleNamespace

import pytest

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.matmul import matmul

KERNELS = {"matmul": matmul, "flash_attention": flash_attention,
           "flash_attention_bwd": SimpleNamespace(
               SOURCE=flash_attention.BWD_SOURCE)}


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


def test_backward_source_includes_the_bf16_tensor_core_header():
    assert (build.SHARED_INCLUDE / "mma_bf16.cuh").is_file()
    assert '#include "mma_bf16.cuh"' in \
        flash_attention.BWD_SOURCE.read_text()


def test_forward_source_includes_the_bf16_tensor_core_header():
    """The bf16 forward's kernels (tensor-core prefill, split-KV decode)
    take their fragments from the shared header, as the backward's do."""
    text = flash_attention.SOURCE.read_text()
    assert '#include "mma_bf16.cuh"' in text
    for kernel in ("mma_fwd_kernel", "decode_kernel", "combine_kernel"):
        assert f"{kernel}(" in text


def test_bf16_header_edit_changes_the_backward_target(tree):
    """The backward's library is named by the bf16 header too: an edit of
    it renames the library; undoing it restores the name."""
    src = tree["flash_attention_bwd"]
    before = build._target(src)
    header = build.SHARED_INCLUDE / "mma_bf16.cuh"
    text = header.read_text()
    header.write_text(text.replace("mma.sync", "mma.sync ", 1))
    assert build._target(src) != before
    header.write_text(text)
    assert build._target(src) == before


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


def test_scan_header_edit_changes_both_scan_targets(tmp_path, monkeypatch):
    """The selective scan's forward and backward share the helpers of
    their own ``csrc/mamba_scan.cuh``: an edit of it renames both
    libraries; undoing it restores the names."""
    from repro_torch.kernels.mamba_scan import mamba_scan

    shared = tmp_path / "kernels" / "csrc"
    shutil.copytree(build.SHARED_INCLUDE, shared)
    monkeypatch.setattr(build, "SHARED_INCLUDE", shared)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    csrc = tmp_path / "kernels" / "mamba_scan" / "csrc"
    shutil.copytree(mamba_scan.SOURCE.parent, csrc)
    sources = [csrc / mamba_scan.SOURCE.name,
               csrc / mamba_scan.BWD_SOURCE.name]
    for src in sources:
        assert '#include "mamba_scan.cuh"' in src.read_text()
    before = [build._target(src) for src in sources]
    assert before[0] != before[1]
    header = csrc / "mamba_scan.cuh"
    text = header.read_text()
    header.write_text(text + "\n// edited\n")
    assert all(build._target(s) != b for s, b in zip(sources, before))
    header.write_text(text)
    assert [build._target(src) for src in sources] == before
