"""The kernel library's build-time tool on the CPU.

A stand-in ``nvcc`` (found through ``CUDA_HOME``) records its arguments and
writes the file it is asked for: the tool compiles each ``LT_PART`` of the
source alone, then every part at once and the link, with the library's
own flags; it exits 2 without ``nvcc`` and 1 when a compile fails.
"""

import hashlib
import json
import sys

import pytest

from land_trendr_tpu_torch.ops import segment_cuda
from land_trendr_tpu_torch.tools import build_time


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in ``nvcc`` on ``CUDA_HOME``; its calls' arguments, one
    JSON list a line, in the returned file.  ``FAIL_PART`` in its
    environment makes that part's compile exit 1."""
    calls = tmp_path / "calls.jsonl"
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import json, os, sys\n"
        "args = sys.argv[1:]\n"
        f"with open({str(calls)!r}, 'a') as f:\n"
        "    f.write(json.dumps(args) + '\\n')\n"
        "if '-DLT_PART=' + os.environ.get('FAIL_PART', '') in args:\n"
        "    sys.exit('error: stand-in failure')\n"
        "open(args[args.index('-o') + 1], 'wb').close()\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(nvcc.parent.parent))
    return calls


def test_parts_are_the_librarys():
    assert build_time.parts_of(segment_cuda._SRC.read_text()) == list(segment_cuda._PARTS)


def test_each_part_alone_then_the_library(tmp_path, fake_nvcc):
    src = str(segment_cuda._SRC)
    out = tmp_path / "build_time.json"
    assert build_time.main([src, src, "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["command"] == (f"python -m land_trendr_tpu_torch.tools.build_time {src} {src} "
                              f"--out {out}")
    assert len(rec["source_sha256"]) == 64
    parts = list(segment_cuda._PARTS)
    for b in rec["builds"]:
        assert b["sha256"] == hashlib.sha256(segment_cuda._SRC.read_bytes()).hexdigest()
        assert b["parts"] == parts and sorted(b["part_alone_s"]) == [str(n) for n in parts]
        assert b["build_s"] >= 0
    calls = [json.loads(line) for line in fake_nvcc.read_text().splitlines()]
    compiles = [c for c in calls if "-c" in c]
    # each build: every part alone, every part again at once, one link
    assert len(calls) == 2 * (2 * len(parts) + 1) and len(compiles) == 4 * len(parts)
    for c in compiles:
        n = int(c[len(segment_cuda._NVCC_FLAGS)].removeprefix("-DLT_PART="))
        assert c[:len(segment_cuda._NVCC_FLAGS)] == list(segment_cuda._NVCC_FLAGS)
        assert n in parts and c[-1] == src
    links = [c for c in calls if "-shared" in c]
    assert len(links) == 2
    for c in links:  # the library's link: its arch flags, the library, every part's object
        assert c[:4] == [*segment_cuda._NVCC_FLAGS[:2], "-shared", "-o"]
        assert [o.rsplit("/", 1)[-1] for o in c[5:]] == [f"part{n}.o" for n in parts]


def test_refuses_without_nvcc_and_on_a_failed_compile(monkeypatch, fake_nvcc):
    src = str(segment_cuda._SRC)
    monkeypatch.setenv("FAIL_PART", "2")
    assert build_time.main([src]) == 1

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(segment_cuda, "_nvcc", no_nvcc)
    assert build_time.main([src]) == 2
