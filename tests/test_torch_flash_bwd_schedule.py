"""The flash backward kernel's schedule of dQ adds, modelled in Python.

At head dims 64 and 128 ``csrc/flash_attention_bwd.cu`` forms dQ inside
the kernel that forms dK and dV: each work item (one 128-key tile of a
batch row's KV head) adds its 64-row dQ partials into an fp32 accumulator
per (batch, query head, query tile), and a counter per tile orders the
adds by key tile, so that every run sums in the same order.  The kernel
cannot run here; ``check_runs.fb_items`` and ``check_runs.fb_schedule``
model its item order, its walk and its waits.  These tests hold the model
to what the kernel's results and progress rest on, at TR's shape and at
every ``FB_CASES`` shape (``chip_smoke.py`` phase 42 runs the kernel on
the same shapes): every visible (batch, query head, query tile, key tile)
pair is one step of exactly one item, each tile's adds come in increasing
key-tile order, and no item waits on one taken after it.
"""
import re
from collections import Counter
from pathlib import Path

import pytest

from repro_torch.check_runs import (FB_CASES, FB_KEY_TILE, FB_QUERY_TILE,
                                    fb_items, fb_schedule, fb_super_group)

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc"
SHAPES = [c[:5] for c in FB_CASES]        # (name, B, S, Hq, Hkv)
IDS = [c[0] for c in SHAPES]


def visible_pairs(B, S, Hq, Hkv):
    """(b, h, query tile, key tile) with a key of the key tile at or before
    a query of the query tile, every key and query below S."""
    nq, nkt = -(-S // FB_QUERY_TILE), -(-S // FB_KEY_TILE)
    return {(b, h, qi, kj) for b in range(B) for h in range(Hq)
            for qi in range(nq) for kj in range(nkt)
            if kj * FB_KEY_TILE <= min(S - 1, qi * FB_QUERY_TILE
                                       + FB_QUERY_TILE - 1)}


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_every_visible_tile_pair_is_one_step(shape):
    _, B, S, Hq, Hkv = shape
    steps = Counter((b, h, qi, j) for j, b, _, walk in fb_items(B, S, Hq, Hkv)
                    for h, qi in walk)
    assert set(steps) == visible_pairs(B, S, Hq, Hkv)
    assert set(steps.values()) == {1}
    # every item is one (batch row, KV head, key tile), each once, and walks
    # the query heads of its KV head only
    items = fb_items(B, S, Hq, Hkv)
    assert len({it[:3] for it in items}) == len(items) == (
        B * Hkv * -(-S // FB_KEY_TILE))
    assert all(h // (Hq // Hkv) == hk for _, _, hk, walk in items
               for h, _ in walk)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_adds_come_in_increasing_key_tile_order(shape):
    _, B, S, Hq, Hkv = shape
    adds = fb_schedule(B, S, Hq, Hkv)["adds"]
    nq = -(-S // FB_QUERY_TILE)
    assert len(adds) == B * Hq * nq
    for (b, h, qi), order in adds.items():
        # key tiles 0 .. the tile holding the query tile's last query
        last = min(S - 1, qi * FB_QUERY_TILE + FB_QUERY_TILE - 1)
        assert order == list(range(last // FB_KEY_TILE + 1)), (b, h, qi)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_no_item_waits_on_one_taken_after_it(shape):
    _, B, S, Hq, Hkv = shape
    run = fb_schedule(B, S, Hq, Hkv)
    taken = run["taken"]
    assert len(taken) == len(fb_items(B, S, Hq, Hkv))
    for waiter, on in run["waits"]:
        assert on < waiter and taken[on] <= taken[waiter]


def test_waits_occur_and_resolve_at_trs_shape():
    """TR's schedule stalls (the check above is not vacuous) and ends,
    within 15% of the steps an SM would take with no stall."""
    run = fb_schedule(8, 2048, 32, 8)
    assert run["waits"]
    steps = sum(len(it[3]) for it in fb_items(8, 2048, 32, 8))
    assert steps == 8 * 32 * sum(32 - 2 * j for j in range(16))
    assert run["rounds"] <= 1.15 * steps / 132


@pytest.mark.parametrize("sms", [1, 2, 3, 7])
def test_few_ctas_at_once_still_finish(sms):
    """Fewer CTAs at once than items (a small card): the waits still
    resolve, and one CTA at a time never waits."""
    run = fb_schedule(2, 300, 8, 2, sms=sms)
    steps = sum(len(it[3]) for it in fb_items(2, 300, 8, 2))
    assert run["rounds"] >= steps / sms
    if sms == 1:
        assert run["rounds"] == steps and not run["waits"]


@pytest.mark.parametrize("hkv, nkt, want", [(8, 16, 4), (8, 32, 2),
                                            (8, 1, 8), (1, 16, 1),
                                            (6, 16, 3), (8, 128, 1)])
def test_super_group(hkv, nkt, want):
    assert fb_super_group(hkv, nkt) == want


def test_the_model_takes_the_kernels_tiles():
    """The tile sizes and the super-group rule of the model are the
    kernel's."""
    src = (CSRC / "flash_attention_bwd.cu").read_text()
    assert int(re.search(r"constexpr int HK = (\d+);", src)[1]) == FB_KEY_TILE
    assert int(re.search(r"constexpr int HQ = (\d+);", src)[1]) == (
        FB_QUERY_TILE)
    assert "hkv % c == 0 && c * p.nkt <= 64" in src
