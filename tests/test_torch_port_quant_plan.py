"""Port: K8's planner (``csrc/quant.cu::plan_conv``), on the CPU.

The planner is the one place K8 chooses its tile width BN and how it splits
K over blocks, from M = B*Ho*Wo, N and K = kh*kw*C alone. These tests
compile it alone with the host's C++ compiler and hold it to a table at
every distinct quantized conv of the flagship's b8 call, and, there and at
every shape of the card tests' ``W8A8_CASES``, to the facts the kernel
relies on: the tiles cover M and N, the splits cover every K step once and
none is empty, a split grid stays within one wave of the card's SMs, and a
grid short of the card splits as finely as one wave and the fewest steps
per split allow. They also hold the widths and the shared memory of each
``wgmma`` variant to what the card takes. The kernel runs on the card
(``test_torch_port_cuda.py -k w8a8``).
"""

import re
import shutil
import subprocess
from pathlib import Path

import pytest

from fovealseg_torch.ops import quant
from tests.test_torch_port_cuda import W8A8_CASES

SOURCE = Path(quant.__file__).resolve().parent.parent / "csrc" / "quant.cu"
FIELDS = ("bn", "m_tiles", "n_tiles", "steps", "splits", "steps_per_split")
SMEM_PER_BLOCK = 232448  # bytes of shared memory one block may take on the H100
S8_WIDTHS = {8, 16, 24, *range(32, 257, 16)}  # wgmma's legal N for s8 (PTX ISA)

# The flagship's b8 call (HRNetV2-nodownsp + C1, 80x80 task): convs per call,
# (cin, h = w, cout, kernel, stride) -> the plan (FIELDS). 3x3 convs pad 1,
# 1x1 convs 0.
FLAGSHIP = [
    (64, (128, 40, 128, 3, 1), (128, 100, 1, 9, 1, 9)),
    (56, (256, 20, 256, 3, 1), (128, 25, 2, 18, 2, 9)),
    (25, (512, 10, 512, 3, 1), (128, 7, 4, 36, 4, 9)),
    (8, (128, 40, 256, 3, 2), (128, 25, 2, 9, 2, 5)),
    (7, (256, 20, 128, 1, 1), (128, 25, 1, 2, 1, 2)),
    (4, (256, 20, 512, 3, 2), (128, 7, 4, 18, 4, 5)),
    (3, (512, 10, 128, 1, 1), (128, 7, 1, 4, 1, 4)),
    (3, (512, 10, 256, 1, 1), (128, 7, 2, 4, 1, 4)),
    (3, (128, 40, 128, 3, 2), (128, 25, 1, 9, 3, 4)),
    (3, (128, 20, 512, 3, 2), (128, 7, 4, 9, 3, 4)),
    (1, (192, 80, 192, 3, 1), (192, 400, 1, 14, 1, 14)),
    (1, (256, 80, 128, 3, 2), (128, 100, 1, 18, 1, 18)),
    (1, (960, 80, 240, 3, 1), (240, 400, 1, 68, 1, 68)),  # C1: N = 240 in one tile
    (1, (960, 80, 512, 3, 4), (128, 25, 4, 68, 1, 68)),
    (1, (960, 80, 512, 1, 4), (128, 25, 4, 8, 1, 8)),
    (1, (512, 20, 512, 3, 1), (128, 25, 4, 36, 1, 36)),
    (1, (512, 20, 512, 3, 2), (128, 7, 4, 36, 4, 9)),
    (1, (512, 20, 512, 1, 2), (128, 7, 4, 4, 1, 4)),
]


def _mnk(b, cin, h, w, cout, k, stride, pad):
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    return b * ho * wo, cout, k * k * cin


FLAGSHIP_MNK = [_mnk(8, c, hw, hw, n, k, s, 1 if k == 3 else 0) for _, (c, hw, n, k, s), _ in
                FLAGSHIP]
CASES_MNK = [_mnk(*case[:8]) for case in W8A8_CASES]


def _constants(src: str) -> dict:
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}


@pytest.fixture(scope="module")
def planner(tmp_path_factory):
    """The plan of every (M, N, K) in FLAGSHIP_MNK + CASES_MNK, from
    ``plan_conv`` compiled alone on the host: {(m, n, k): {field: value}}."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler is needed to compile plan_conv"
    src = SOURCE.read_text()
    consts = "\n".join(re.findall(r"^constexpr int k\w+ = [^;]+;", src, re.M))
    plan = re.search(r"struct ConvPlan \{.*?\n\};\n\nConvPlan plan_conv\(.*?\n}\n", src, re.S)
    tmp = tmp_path_factory.mktemp("plan")
    prog = tmp / "plan.cc"
    prog.write_text("#include <cstdio>\n" + consts + "\n" + plan.group(0) + """
int main() {
  long long m; int n, k;
  while (std::scanf("%lld %d %d", &m, &n, &k) == 3) {
    const ConvPlan p = plan_conv(m, n, k);
    std::printf("%d %d %d %d %d %d\\n", p.bn, p.m_tiles, p.n_tiles, p.steps, p.splits,
                p.steps_per_split);
  }
}
""")
    exe = tmp / "plan"
    subprocess.run([cxx, "-std=c++17", "-O1", "-o", str(exe), str(prog)], check=True)
    shapes = sorted(set(FLAGSHIP_MNK + CASES_MNK))
    run = subprocess.run([str(exe)], input="\n".join(" ".join(map(str, s)) for s in shapes),
                         capture_output=True, text=True, check=True)
    rows = [tuple(map(int, line.split())) for line in run.stdout.splitlines()]
    assert len(rows) == len(shapes)
    return {s: dict(zip(FIELDS, r)) for s, r in zip(shapes, rows)}


@pytest.mark.parametrize("count,shape,want", FLAGSHIP,
                         ids=[f"{c}x_{s[0]}@{s[1]}to{s[2]}_k{s[3]}s{s[4]}" for c, s, _ in FLAGSHIP])
def test_flagship_plan_table(planner, count, shape, want):
    cin, hw, cout, k, stride = shape
    assert tuple(planner[_mnk(8, cin, hw, hw, cout, k, stride, 1 if k == 3 else 0)].values()) \
        == want


def test_flagship_table_is_one_b8_call():
    """184 quantized convs per call (``quantize_model`` on the flagship);
    18 distinct shapes; the ones that split K are the 3x3 convs at M = 800
    and 3,200."""
    assert sum(c for c, _, _ in FLAGSHIP) == 184
    assert len({s for _, s, _ in FLAGSHIP}) == 18
    split = {_mnk(8, c, hw, hw, n, k, s, 1)[0] for _, (c, hw, n, k, s), p in FLAGSHIP if p[4] > 1}
    assert split == {800, 3200} and all(s[3] == 3 for _, s, p in FLAGSHIP if p[4] > 1)


@pytest.mark.parametrize("mnk", sorted(set(FLAGSHIP_MNK + CASES_MNK)),
                         ids=lambda s: "m{}_n{}_k{}".format(*s))
def test_plan_facts(planner, mnk):
    consts = _constants(SOURCE.read_text())
    sms, min_steps = consts["kSms"], consts["kMinSplitSteps"]
    bm, bk = consts["kBM"], consts["kBK"]
    m, n, k = mnk
    p = planner[mnk]
    bn, per, splits, steps = p["bn"], p["steps_per_split"], p["splits"], p["steps"]
    assert bn in (128, 192, 240, 256)
    # the tiles cover M and N, none wholly outside
    assert (p["m_tiles"] - 1) * bm < m <= p["m_tiles"] * bm
    assert (p["n_tiles"] - 1) * bn < n <= p["n_tiles"] * bn
    assert steps == -(-k // bk)
    # split z takes steps [z * per, min(steps, (z + 1) * per)): each step once, none empty
    ranges = [range(z * per, min(steps, (z + 1) * per)) for z in range(splits)]
    assert all(len(r) > 0 for r in ranges)
    assert sorted(i for r in ranges for i in r) == list(range(steps))
    tiles = p["m_tiles"] * p["n_tiles"]
    if tiles >= sms:
        assert splits == 1
    else:
        # one wave of one block per SM, and no finer split keeps one (or one cluster)
        assert tiles * splits <= sms
        finer = -(-steps // (per - 1)) if per > 1 else None
        assert per == min(steps, min_steps) or tiles * finer > sms \
            or finer > consts["kMaxSplits"]
    if splits > 1:  # one cluster per tile, and its partial and staging share a 128-wide ring
        assert per >= min_steps and splits <= consts["kMaxSplits"] and bn == 128


def test_wgmma_widths_and_shared_memory():
    """Every width the planner picks has its ``wgmma`` variant, legal for
    s8; the ring (``conv_stages``: at least 4 stages), its barriers, the
    tile's scales and the 1024-byte alignment fit one block's shared
    memory (``conv_smem_bytes``); the epilogue's staging tile fits in the
    ring."""
    src = SOURCE.read_text()
    c = _constants(src)
    widths = {int(w) for w in re.findall(r"struct Wgmma<(\d+)> \{", src)}
    assert widths == {128, 192, 240, 256} and widths <= S8_WIDTHS
    assert {int(w) for w in re.findall(r"launch_conv_bn<(\d+)>\(", src)} == widths
    for bn in widths:
        assert re.search(rf"m64n{bn}k32\.s32\.s8\.s8", src)
        stage = (c["kBM"] + bn) * c["kBK"]
        stages = min(c["kMaxStages"], c["kRingBytes"] // stage)  # conv_stages<BN>()
        assert stages >= 4  # two in flight unsignalled, at least two more
        ring = stages * stage
        assert ring + 16 * stages + 16 + 2048 + 1024 <= SMEM_PER_BLOCK
        assert bn * (c["kBM"] + 4) * 4 <= ring and bn * (c["kBM"] + 8) * 2 <= ring
    assert c["kBK"] == 128  # one 128-byte swizzle row per stage
