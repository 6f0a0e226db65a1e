"""The uplink channel's block kernels (``csrc/topk_compress.cu`` and
``csrc/quantize.cu``'s ``int8_roundtrip``): the constants their layout
rests on, and the inputs and planted faults they are checked on
(``channel_cases.py`` beside ``chip_smoke.py``).

Both kernels hold one 256-element block per warp, 8 elements per lane
(``csrc/channel_block.cuh``). The kernels themselves are held against the
plain versions on the card (``tests/test_torch_kernels.py``, ``*_cuda``,
and ``chip_smoke.py``'s phase 6); the port's plain versions against the
reference on these inputs in ``tests/test_torch_kernels.py``."""
import pathlib
import re
import sys

import torch

import repro_torch
from repro_torch.kernels import ops, ref, topk_compress

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import channel_cases  # noqa: E402  (beside chip_smoke.py, outside the package)

CSRC = pathlib.Path(repro_torch.__file__).parent / "csrc"


def _update(n, seed):
    gen = torch.Generator().manual_seed(seed)
    return channel_cases.bf16_grid_update(torch.randn(n, generator=gen) * 0.02,
                                          torch.randn(n, generator=gen))


def test_ties_decide_the_top_k_of_the_sync_kind_of_update():
    """On the sync's kind of update the k-th magnitude ties in most blocks:
    fewer threshold rounds than k, and more than k kept, which a top-k
    keeping exactly k per block misses."""
    x = _update(256 * 64, 0)
    st = channel_cases.tie_stats(x, 3)
    assert st["kth_tied"] > 0.5 and st["rounds"] < 3
    assert not torch.equal(ref.topk_sparsify_ref(x, 3), channel_cases.topk_exact_k(x, 3))


def test_edge_blocks_hold_their_kinds():
    x = channel_cases.plant_edge_blocks(_update(256 * 8, 1))
    rows = x.view(8, 256)
    assert (rows[0] == 0).all()
    assert int((rows[1] != 0).sum()) == 1 and int((rows[2] != 0).sum()) == 2
    s = rows[3].abs().amax() / 127
    assert s.item() == channel_cases.HALF_STEP
    q = rows[3][1:-1] / s
    assert torch.equal(q - torch.floor(q), torch.full_like(q, 0.5))
    assert not torch.equal(ref.int8_roundtrip_ref(x), channel_cases.int8_half_away(x))


def _constant(source: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert m is not None, (source, name)
    return int(m.group(1))


def test_block_constants_match_the_kernel_source():
    """The kernels' block and lane layout (``channel_block.cuh``) is the
    wrappers' block: 256 elements, 8 per lane of a 32-lane warp."""
    block = _constant("channel_block.cuh", "BLOCK")
    assert block == ops.BLOCK == ref.BLOCK == topk_compress.BLOCK == channel_cases.BLOCK
    assert _constant("channel_block.cuh", "PER_LANE") * 32 == block
