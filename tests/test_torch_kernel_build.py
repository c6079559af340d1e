"""The kernel build's cache key (paddle_tpu_torch/core/kernel_build.py):
a library is named by a hash of its source, the shared headers under
csrc/ and the nvcc flags, so an edit to any of them builds a new library
instead of loading a stale one.  CPU only: nvcc is never called."""
import os

import pytest

from paddle_tpu_torch.core import kernel_build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "kern.cu").write_text('#include "shared.cuh"\n')
    (src / "shared.cuh").write_text("// v1\n")
    monkeypatch.setattr(kernel_build, "CSRC_DIR", str(src))
    monkeypatch.setattr(kernel_build, "BUILD_DIR", str(tmp_path / "build"))

    def no_nvcc():
        raise AssertionError("nvcc must not be called")

    monkeypatch.setattr(kernel_build, "find_nvcc", no_nvcc)
    return src


def _lib_name(name="kern"):
    return os.path.basename(kernel_build._target(name)[1])


def test_header_edit_changes_the_library_name(csrc):
    before = _lib_name()
    assert _lib_name() == before  # the key is stable
    (csrc / "shared.cuh").write_text("// v2\n")
    after = _lib_name()
    assert after != before and after.startswith("libkern_")
    (csrc / "other.cuh").write_text("// a new header\n")
    assert _lib_name() != after


@pytest.mark.parametrize("what", ["source", "flags"])
def test_source_and_flags_are_in_the_key(csrc, monkeypatch, what):
    before = _lib_name()
    if what == "source":
        (csrc / "kern.cu").write_text('#include "shared.cuh"\n// edit\n')
    else:
        monkeypatch.setattr(kernel_build, "NVCC_FLAGS",
                            kernel_build.NVCC_FLAGS + ("-lineinfo",))
    assert _lib_name() != before


def test_a_built_library_is_reused_without_nvcc(csrc):
    """A library already under the build directory with the current key is
    returned as it is: the build step (nvcc) is not run."""
    out = kernel_build._target("kern")[1]
    os.makedirs(os.path.dirname(out))
    open(out, "wb").close()
    assert kernel_build.build_libraries(["kern"]) == [out]
    (csrc / "shared.cuh").write_text("// v3\n")
    with pytest.raises(AssertionError, match="nvcc must not be called"):
        kernel_build.build_libraries(["kern"])
