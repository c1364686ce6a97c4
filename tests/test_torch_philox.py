"""The port's counter-based dropout masks (``ops/philox.py``), the plain
version of the masks its CUDA kernels draw: Philox4x32-10 against
Random123's known-answer vectors, masks that depend on (seed, mask, row,
position, channel) alone, and the keep fraction."""

import numpy as np
import pytest
import torch

from datamining_recblr_torch.models import layers as L
from datamining_recblr_torch.ops import philox


def _words(ctr, key):
    c = [torch.tensor([v], dtype=torch.int64) for v in ctr]
    return [int(w) for w in philox.philox4x32_10(*c, *key)]


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    assert tuple(_words(ctr, key)) == want


def test_mask_depends_only_on_its_coordinates():
    seed = 0x1234_5678_9ABC_DEF0
    big = philox.dropout_bits(seed, philox.M2, 6, 11, 37)
    small = philox.dropout_bits(seed, philox.M2, 4, 5, 10)
    assert torch.equal(small, big[:4, :5, :10])
    # word (channel & 3) of the Philox block at counter (channel >> 2, t, b, m)
    b, t, ch = 3, 7, 29
    words = _words((ch >> 2, t, b, philox.M2), (seed & 0xFFFFFFFF, seed >> 32))
    assert int(big[b, t, ch]) == words[ch & 3]
    # another mask id, seed or coordinate gives other bits
    assert not torch.equal(big, philox.dropout_bits(seed, philox.M3, 6, 11, 37))
    assert not torch.equal(big, philox.dropout_bits(seed + 1, philox.M2, 6, 11, 37))
    assert (big.min() >= 0) and (big.max() < 2**32)


def test_keep_fraction_and_scale():
    p = 0.2
    m = philox.dropout_mask(2020, philox.M1, 100, 100, 100, p)  # 1e6 draws
    keep = float((m > 0).float().mean())
    assert abs(keep - (1 - p)) < 0.01
    assert set(torch.unique(m).tolist()) == {0.0, np.float32(1 / (1 - p))}
    assert philox.keep_threshold(p) == min(int(0.8 * 4294967296.0), 4294967295)


def test_step_seeds_are_a_function_of_seed_step_and_index():
    a = philox.step_seeds(2020, 17, 3)
    assert a == philox.step_seeds(2020, 17, 3)
    assert len(set(a)) == 3 and all(0 <= s < 2**64 for s in a)
    assert a != philox.step_seeds(2020, 18, 3) and a != philox.step_seeds(2021, 17, 3)
    assert philox.step_seeds(2020, 17, 4)[:3] == a


def test_layers_dropout():
    x = torch.ones((4, 6, 8), dtype=torch.bfloat16)
    assert L.dropout(x, 0.0, 5) is x
    y = L.dropout(x, 0.25, 5, philox.M1)
    assert y.dtype == torch.bfloat16
    want = philox.dropout_mask(5, philox.M1, 4, 6, 8, 0.25).to(torch.bfloat16)
    assert torch.equal(y, want)
    # a [B, W] input draws the masks of position 0
    y2 = L.dropout(torch.ones((4, 8)), 0.25, 5, philox.M1)
    assert torch.equal(y2, philox.dropout_mask(5, philox.M1, 4, 1, 8, 0.25)[:, 0])


def test_mask_at_positions_is_the_full_mask_gathered():
    """The last-query layer's masks: row b at position pos[b] of the
    [B, T, W] mask, bit for bit."""
    pos = torch.tensor([0, 5, 2, 7])
    full = philox.dropout_mask(99, philox.prob_mask_id(1), 4, 8, 13, 0.3)
    at = philox.dropout_mask_at(99, philox.prob_mask_id(1), pos, 13, 0.3)
    torch.testing.assert_close(at, full[torch.arange(4), pos], atol=0, rtol=0)
    assert philox.prob_mask_id(0) == philox.ATTN_PROB == 4 > philox.M3


def test_mask_at_selected_positions_is_the_full_mask_gathered():
    """The selected-positions layer's masks: element [b, s] is the full
    mask's row b at position pos[b, s], repeats included, bit for bit."""
    pos = torch.tensor([[0, 5, 5, 0], [7, 1, 0, 0], [2, 2, 2, 6]])
    full = philox.dropout_mask(77, philox.M3, 3, 8, 10, 0.25)
    at = philox.dropout_mask_at(77, philox.M3, pos, 10, 0.25)
    assert at.shape == (3, 4, 10)
    torch.testing.assert_close(at, full[torch.arange(3)[:, None], pos], atol=0, rtol=0)


def test_cloze_draw_is_a_function_of_its_seed_and_coordinates():
    """Word (position & 3) of the Philox block at counter (position >> 2,
    row, 0, 0) under the cloze seed, below ratio * 2^32; about ``ratio``
    of the draws are True."""
    seed = 0x0123_4567_89AB_CDEF
    big = philox.cloze_draw(seed, 300, 200, 0.2)
    assert big.dtype == torch.bool and big.shape == (300, 200)
    assert torch.equal(philox.cloze_draw(seed, 5, 13, 0.2), big[:5, :13])
    b, t = 4, 11
    words = _words((t >> 2, b, 0, 0), (seed & 0xFFFFFFFF, seed >> 32))
    assert bool(big[b, t]) == (words[t & 3] < int(0.2 * 2**32))
    assert abs(float(big.float().mean()) - 0.2) < 0.01
    assert not torch.equal(big, philox.cloze_draw(seed + 1, 300, 200, 0.2))
    assert not philox.cloze_draw(seed, 3, 7, 0.0).any()
