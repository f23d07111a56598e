"""``repro_torch.kernels._build`` on the CPU, with a stand-in for nvcc: a
build started without waiting is finished by a later ``build`` or at the
library's first ``load``, and a failed compile raises with its output."""
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402

# writes the -o file and a ptxas-like line, or fails for a source named bad.cu;
# keeps its command line beside the source (<source>.cmd)
FAKE_NVCC = """#!/bin/sh
cmd="$*"; out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift;; *.cu) src="$1";; esac
  shift
done
case "$src" in *bad.cu) echo "error: planted failure"; exit 1;; esac
echo "$cmd" > "$src.cmd"
echo "ptxas info    : Used 1 registers"
echo built > "$out"
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a", "b", "bad", "sim_batch"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_PENDING", {})
    monkeypatch.setattr(_build, "_LOADED", {})


def test_build_waits_and_returns_each_log(fake_nvcc):
    logs = _build.build(["a", "b"])
    assert set(logs) == {"a", "b"} and "Used 1 registers" in logs["a"]
    assert _build.library_path("a").exists() and _build.library_path("b").exists()
    assert not _build._PENDING
    assert _build.build(["a"]) == {}                 # built already: nothing to do


def test_build_without_waiting_is_finished_later(fake_nvcc):
    assert _build.build(["a", "b"], wait=False) == {}
    assert set(_build._PENDING) == {"a", "b"}
    assert set(_build.build(["a"])) == {"a"}         # waits for a alone
    assert set(_build._PENDING) == {"b"}
    assert _build.library_path("a").exists()


def test_load_finishes_a_pending_build(fake_nvcc, monkeypatch):
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    _build.build(["b"], wait=False)
    assert _build.load("b") == str(_build.library_path("b"))
    assert not _build._PENDING and _build.library_path("b").exists()


@pytest.mark.parametrize("wait", [True, False])
def test_a_failed_compile_raises_with_its_output(fake_nvcc, monkeypatch, wait):
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    _build.build(["bad", "a"], wait=False)
    with pytest.raises(RuntimeError, match="planted failure"):
        if wait:
            _build.build(["bad", "a"])
        else:
            _build.load("bad")
    assert not _build.library_path("bad").exists()
    assert not list(_build.BUILD_DIR.glob("bad-*.tmp*"))


def test_per_source_flags_reach_their_source_alone(fake_nvcc, monkeypatch):
    """``-fmad=false`` (no FMA contraction: the batch simulator's float64
    sites) is on sim_batch.cu's command line and on no other source's, and
    the flags are part of the library's hash."""
    assert _build.SOURCE_FLAGS["sim_batch"] == ("-fmad=false",)
    _build.build(["a", "sim_batch"])
    cmds = {n: (_build.CSRC / f"{n}.cu.cmd").read_text().split() for n in ("a", "sim_batch")}
    assert "-fmad=false" in cmds["sim_batch"] and "-fmad=false" not in cmds["a"]
    assert cmds["a"][:len(_build.NVCC_FLAGS)] == list(_build.NVCC_FLAGS)
    before = {n: _build.library_path(n) for n in ("a", "sim_batch")}
    monkeypatch.setitem(_build.SOURCE_FLAGS, "sim_batch", ("-fmad=true",))
    assert _build.library_path("sim_batch") != before["sim_batch"]
    assert _build.library_path("a") == before["a"]
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path("a") != before["a"]
