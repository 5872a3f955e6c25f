"""The kernel build of ``gadget_leicester_tpu_torch/kernels.py`` on the CPU,
through a stand-in for ``nvcc`` (there is none here): one compile per
source and one link into the library under the sources' hash; nvcc's
output, which carries ``-Xptxas=-v``'s register counts, is kept beside the
library, so a second, cached build reports the same counts, and
``chip_smoke.ptxas_registers`` reads them."""

import stat

import chip_smoke
from gadget_leicester_tpu_torch import kernels

# a stand-in for nvcc: writes the file after -o, and for each compile the
# two ptxas lines nvcc -Xptxas=-v prints for a kernel named after the source
FAKE_NVCC = r"""#!/bin/sh
out=""; src=""; prev=""
for a in "$@"; do
  [ "$prev" = "-o" ] && out="$a"
  case "$a" in *.cu) src="$a";; esac
  prev="$a"
done
: > "$out"
if [ -n "$src" ]; then
  name=$(basename "$src" .cu)
  echo "ptxas info    : Compiling entry function '_Z${name}_kernelILb0EEv' for 'sm_90a'"
  echo "ptxas info    : Used 42 registers, used 0 barriers"
fi
"""


def test_build_keeps_nvcc_output_beside_a_cached_library(tmp_path,
                                                         monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(kernels, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(kernels, "build_info", {})
    lib = kernels.build()
    assert lib.exists() and lib.parent.parent == tmp_path / "build"
    first = kernels.build_info["log"]
    assert first.count("Used 42 registers") == len(kernels.SOURCES)
    assert (lib.parent / "nvcc.log").read_text() == first
    # no object file is left behind
    assert sorted(p.name for p in lib.parent.iterdir()) == [
        "libglt_kernels.so", "nvcc.log"]
    assert kernels.build() == lib
    assert kernels.build_info["seconds"] == 0.0
    assert kernels.build_info["log"] == first
    assert chip_smoke.ptxas_registers("sph_density_kernelILb0E") == [
        ("_Zsph_density_kernelILb0EEv", 42)]
