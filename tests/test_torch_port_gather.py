"""Port: the choice of the row gather's (K5) kernel variant, on the CPU.

``fovealseg_torch/ops/gather.py::gather_variant`` picks one of the three
variants of ``csrc/gather.cu`` from the channel count, the indices per image
and the three base addresses; the kernel's ``choose_variant`` mirrors it and
refuses any other choice but the scalar one. These tests hold the Python
function to a table of cases, and the C++ function (compiled alone with the
host's C++ compiler) to the Python one over every channel count up to 9, the
score map's 51, ragged and whole index counts and every 4-byte alignment.
The variants themselves run on the card (``test_torch_port_cuda.py``).
"""

import re
import shutil
import subprocess
from itertools import product
from pathlib import Path

import pytest

from fovealseg_torch.ops import gather
from fovealseg_torch.ops.gather import (
    SMALL_MAX_C,
    VARIANT_SCALAR,
    VARIANT_SMALL,
    VARIANT_WIDE,
    gather_variant,
)

SOURCE = Path(gather.__file__).resolve().parent.parent / "csrc" / "gather.cu"


@pytest.mark.parametrize("c,n,table,idx,out,want", [
    (1, 409600, 0, 0, 0, VARIANT_SMALL),  # labels at K2's output
    (2, 409600, 0, 0, 0, VARIANT_SMALL),  # the filled grid at K4's output
    (3, 409600, 0, 0, 0, VARIANT_SMALL),  # an image at K4's output
    (4, 64, 0, 0, 0, VARIANT_SMALL),
    (51, 409600, 0, 0, 0, VARIANT_WIDE),  # the score map
    (5, 80, 4, 4, 0, VARIANT_WIDE),  # wide needs only the output aligned
    (1, 409601, 0, 0, 0, VARIANT_SCALAR),  # a ragged tail
    (3, 35, 0, 0, 0, VARIANT_SCALAR),
    (2, 4096, 4, 0, 0, VARIANT_SCALAR),  # table at storage offset 1
    (2, 4096, 8, 0, 0, VARIANT_SMALL),  # ... at offset 2: 8-byte rows still aligned
    (4, 4096, 8, 0, 0, VARIANT_SCALAR),  # 16-byte rows are not
    (1, 4096, 4, 0, 0, VARIANT_SMALL),  # 4-byte rows never need more
    (1, 4096, 0, 4, 0, VARIANT_SCALAR),  # index map at storage offset 1
    (3, 4096, 0, 0, 8, VARIANT_SCALAR),
    (51, 99, 0, 0, 0, VARIANT_SCALAR),  # n * c % 4 != 0
    (51, 4096, 0, 0, 4, VARIANT_SCALAR),
    (300, 391, 4, 4, 0, VARIANT_WIDE),
])
def test_gather_variant(c, n, table, idx, out, want):
    assert gather_variant(c, n, 1 << 20 | table, 1 << 21 | idx, 1 << 22 | out) == want


def test_kernel_constants_match():
    src = SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(consts["kScalar"]), int(consts["kSmall"]), int(consts["kWide"])) == (
        VARIANT_SCALAR, VARIANT_SMALL, VARIANT_WIDE)
    assert int(consts["kSmallMaxC"]) == SMALL_MAX_C
    assert int(consts["kWidePix"]) % 4 == 0  # a wide span is a whole number of chunks


def test_kernel_choose_variant_mirrors_python(tmp_path):
    """``choose_variant`` from the kernel source, compiled on the host,
    against :func:`gather_variant` on every case of a grid."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler is needed to compile choose_variant"
    src = SOURCE.read_text()
    consts = "\n".join(re.findall(r"constexpr int k\w+ = \d+;", src))
    body = re.search(r"int choose_variant\(.*?\n}\n", src, re.S).group(0)
    prog = tmp_path / "choose.cc"
    prog.write_text("#include <cstdint>\n#include <cstdio>\n" + consts + "\n" + body + """
int main() {
  int c; long long n; unsigned long long t, i, o;
  while (std::scanf("%d %lld %llu %llu %llu", &c, &n, &t, &i, &o) == 5)
    std::printf("%d\\n", choose_variant(c, n, t, i, o));
}
""")
    exe = tmp_path / "choose"
    subprocess.run([cxx, "-std=c++17", "-O1", "-o", str(exe), str(prog)], check=True)
    cases = [(c, n, (1 << 30) + a, (1 << 31) + b, (1 << 32) + d)
             for c, n, a, b, d in product([*range(1, 10), 51, 300], [1, 2, 3, 4, 35, 64, 99, 409600],
                                          [0, 4, 8, 12], [0, 4, 8, 12], [0, 4, 8, 12])]
    run = subprocess.run([str(exe)], input="\n".join(" ".join(map(str, k)) for k in cases),
                         capture_output=True, text=True, check=True)
    got = [int(v) for v in run.stdout.split()]
    want = [gather_variant(*k) for k in cases]
    assert got == want
    assert set(want) == {VARIANT_SCALAR, VARIANT_SMALL, VARIANT_WIDE}
