"""The port's kernel build (``repro_torch.kernels.build``) without nvcc.

The library's name is a hash of every ``.cu`` and ``.cuh`` file in
``csrc/``, so an edit to any of them, the attention tile core's header
included, builds a new library; a build runs one ``nvcc`` per ``.cu``
file, all started before the first is waited for, then one link.  Each
test works on a copy of ``csrc/`` and a build directory of its own.
"""

import shutil
import subprocess
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402

CSRC_FILES = sorted(p.name for p in build.CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    return copy


def test_csrc_holds_the_sources_and_the_tile_core():
    assert {"attention_tile.cuh", "flash_attention.cu", "paged_attention.cu",
            "matmul.cu", "conv2d.cu"} <= set(CSRC_FILES)


@pytest.mark.parametrize("name", CSRC_FILES)
def test_library_path_follows_every_source(csrc_copy, name):
    before = build.library_path()
    path = csrc_copy / name
    text = path.read_bytes()
    path.write_bytes(text + b"\n// edited\n")
    edited = build.library_path()
    assert edited != before and edited.parent == before.parent
    path.write_bytes(text)
    assert build.library_path() == before


def test_library_path_follows_a_new_header_and_ignores_other_files(csrc_copy):
    before = build.library_path()
    (csrc_copy / "notes.txt").write_text("not a source\n")
    assert build.library_path() == before
    (csrc_copy / "extra.cuh").write_text("// a new header\n")
    assert build.library_path() != before


def test_build_runs_one_nvcc_per_source_then_one_link(csrc_copy, tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    started, waited_after, links = [], [], []

    class FakeNvcc:
        returncode = 0

        def __init__(self, cmd, **kw):
            started.append(cmd)

        def communicate(self):
            waited_after.append(len(started))
            return "ptxas info    : Used 8 registers\n", ""

    def fake_link(cmd, **kw):
        links.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(build.subprocess, "Popen", FakeNvcc)
    monkeypatch.setattr(build.subprocess, "run", fake_link)
    log = build.build()
    sources = [str(p) for p in sorted(csrc_copy.glob("*.cu"))]
    assert [cmd[-1] for cmd in started] == sources          # headers get no nvcc
    for cmd in started:
        assert cmd[0] == "nvcc" and "-c" in cmd and "-Xptxas=-v" in cmd
        assert "arch=compute_90a,code=sm_90a" in cmd
    assert min(waited_after) == len(sources)                 # all started first
    assert len(links) == 1 and links[0][:2] == ["nvcc", "-shared"]
    assert build.library_path().exists() and "registers" in log
    assert build.build() == ""                               # built: nothing to do
    assert len(started) == len(sources) and len(links) == 1
