"""The launch geometry and routes of the fused STDP update (``ops/stdp.py``,
``csrc/stdp_update.cu``), on the CPU.

The kernel runs only on the card; here a numpy model of route "tile"'s
mapping, written as the kernel's code walks it (thread block -> strip,
tile and segment; thread -> lane and row group; row step -> rows), takes
the plan that ``stdp_update`` passes to the launch and must cover every
entry of W exactly once, with no lane past its row's end.  The routes
must fall back to "row" where a row is not a whole number of 16-byte
pieces or an address is not 16-byte aligned, and a forced route must
raise where it cannot run.
"""

import os
import re

import numpy as np
import pytest
import torch

from rectipy_tpu_torch.ops import stdp
from rectipy_tpu_torch.ops.stdp import (stdp_update, stdp_update_plan, stdp_update_route,
                                        stdp_update_routes)
from rectipy_tpu_torch.testing import STDP_CHECK_SHAPES, STDP_SHAPES, stdp_inputs

SOURCE = os.path.join(os.path.dirname(stdp.__file__), os.pardir, "csrc", "stdp_update.cu")
DTYPES = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}
# the paths' shapes: N = 10,000 dense; 196 x 4 blocks of 512 (N = 100,352)
PATH_SHAPES = {"dense": (10_000, 10_000), "blocks": (196, 4, 512, 196)}
SHAPES = sorted({("dense", s) for s in STDP_CHECK_SHAPES["dense"] + [STDP_SHAPES["dense"]]}
                | {("blocks", s) for s in STDP_CHECK_SHAPES["blocks"] + [STDP_SHAPES["blocks"]]}
                | {(k, v) for k, v in PATH_SHAPES.items()})


def geometry(layout, shape):
    """(segments, seg_rows, row_len) of a dense (n_out, n_in) or a block
    (n_br, cb, bs, nb_in) shape."""
    if layout == "dense":
        return 1, shape[0], shape[1]
    n_br, cb, bs, _ = shape
    return n_br * cb, bs, bs


def tile_vectors(plan, segments, seg_rows, row_len, chunk=2048):
    """Every 16-byte piece route "tile" updates, as the flat index of its
    first entry in W, in chunks of thread blocks: the kernel's own walk."""
    t = np.arange(plan.threads)
    groups = plan.threads // plan.lanes
    group, lane = t // plan.lanes, t % plan.lanes
    assert groups == plan.groups
    for first in range(0, plan.grid, chunk):
        b = np.arange(first, min(first + chunk, plan.grid))
        tile, strip = b // plan.strips, b % plan.strips
        row0 = (tile % plan.row_tiles) * plan.tile_rows
        seg = tile // plan.row_tiles
        assert seg.max() < segments
        rows = np.minimum(plan.tile_rows, seg_rows - row0)
        col = (strip[:, None] * plan.lanes + lane[None, :]) * plan.vec
        live = (group < groups)[None, :] & (col < row_len)
        # no live lane reaches past its row's end
        assert (col[live] + plan.vec <= row_len).all()
        base = (seg * seg_rows + row0)[:, None] * row_len + col
        for i0 in range(0, plan.tile_rows, groups * stdp.TILE_UNROLL):
            for u in range(stdp.TILE_UNROLL):
                i = group + i0 + u * groups
                on = live & (i[None, :] < rows[:, None])
                yield (base + i[None, :] * row_len)[on]


def source_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", open(SOURCE).read()).group(1))


def test_python_geometry_mirrors_the_source():
    assert stdp.TILE_THREADS == source_constant("kTileThreads")
    assert stdp.TILE_UNROLL == source_constant("kTileUnroll")
    assert stdp.TILE_MAX_ROWS == source_constant("kTileMaxRows")
    assert stdp.ROW_THREADS == source_constant("kThreads")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("layout,shape", SHAPES)
def test_tile_plan_covers_every_entry_once(layout, shape, dtype):
    dt = DTYPES[dtype]
    segments, seg_rows, row_len = geometry(layout, shape)
    vec = 16 // torch.empty((), dtype=dt).element_size()
    if row_len % vec:
        # not whole 16-byte pieces: route "row" only, and no tile plan
        assert stdp_update_routes(dt, row_len, [0, 16, 32]) == ("row",)
        with pytest.raises(ValueError, match="does not take"):
            stdp_update_plan("tile", dt, seg_rows, row_len, segments)
        return
    plan = stdp_update_plan("tile", dt, seg_rows, row_len, segments)
    assert plan.vec == vec and plan.threads == stdp.TILE_THREADS
    assert 1 <= plan.lanes <= plan.threads and plan.groups == plan.threads // plan.lanes
    assert plan.tile_rows <= stdp.TILE_MAX_ROWS
    assert plan.grid == segments * plan.row_tiles * plan.strips < 2 ** 31
    n_vec = segments * seg_rows * row_len // vec
    seen = np.zeros(n_vec, dtype=bool)
    count = 0
    for starts in tile_vectors(plan, segments, seg_rows, row_len):
        assert (starts % vec == 0).all()
        seen[starts // vec] = True
        count += starts.size
    # as many pieces as W holds and each of them reached: each exactly once
    assert count == n_vec and seen.all()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_tile_plan_at_the_paths_shapes(dtype):
    # the geometry the card runs: rows of 10,000 in even strips, blocks of
    # 512 in whole rows, each thread TILE_ROWS_PER_THREAD rows
    dt = DTYPES[dtype]
    size = torch.empty((), dtype=dt).element_size()
    dense = stdp_update_plan("tile", dt, 10_000, 10_000)
    vecs = 10_000 * size // 16
    assert dense.strips == -(-vecs // 256) and dense.lanes * dense.strips >= vecs
    assert dense.tile_rows == stdp.TILE_ROWS_PER_THREAD[size]
    blocks = stdp_update_plan("tile", dt, 512, 512, 784)
    assert blocks.strips == 1 and blocks.lanes == min(512 * size // 16, 256)
    assert blocks.tile_rows == stdp.TILE_ROWS_PER_THREAD[size] * blocks.groups
    for plan in (dense, blocks):
        assert stdp_update_route(dt, 10_000 if plan is dense else 512, [0, 16, 64]) == "tile"


def test_row_plan_is_a_grid_stride_loop():
    plan = stdp_update_plan("row", torch.float32, 37, 1003)
    assert (plan.route, plan.grid, plan.threads) == ("row", 37, stdp.ROW_THREADS)
    big = stdp_update_plan("row", torch.float32, 512, 512, 784, sms=132)
    assert big.grid == stdp.ROW_BLOCKS_PER_SM * 132
    # nothing to update: no thread block
    assert stdp_update_plan("tile", torch.float32, 0, 1000).grid == 0
    assert stdp_update_plan("row", torch.float32, 5, 0).grid == 0


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_routes_take_row_where_tiles_cannot(dtype):
    dt = DTYPES[dtype]
    vec = 16 // torch.empty((), dtype=dt).element_size()
    assert stdp_update_routes(dt, 8 * vec, [0, 16, 4096]) == ("tile", "row")
    assert stdp_update_routes(dt, 8 * vec + 1, [0, 16, 4096]) == ("row",)
    # one address a single element past a 16-byte boundary
    assert stdp_update_routes(dt, 8 * vec, [0, 16 + torch.empty((), dtype=dt).element_size()]) \
        == ("row",)
    ops = stdp_inputs("dense", dtype, 1, "cpu", (37, 1000))
    W = ops["W"]
    store = torch.empty(W.numel() + 1, dtype=W.dtype)
    shifted = store[1:].view_as(W)
    ptrs = [t.data_ptr() for t in (W, ops["x_pre"], ops["spk_pre"])]
    assert stdp_update_routes(W.dtype, 1000, ptrs) == ("tile", "row")
    assert stdp_update_routes(W.dtype, 1000, [shifted.data_ptr()] + ptrs[1:]) == ("row",)


def test_forced_routes_raise_without_the_card():
    ops = stdp_inputs("dense", "float32", 2, "cpu", (37, 1000))
    args = [ops[k] for k in ("W", "x_pre", "x_post", "spk_pre", "spk_post", "c")]
    # CPU tensors take the plain version, which has no routes
    for route in ("tile", "row"):
        with pytest.raises(ValueError, match="is the kernel's"):
            stdp_update(*args, route=route)
    with pytest.raises(ValueError, match="must be one of"):
        stdp_update(*args, route="rows")
    # a route the shapes do not allow: rows of 1,003 are no whole pieces
    ragged = stdp_inputs("dense", "float32", 2, "cpu", (37, 1003))
    with pytest.raises(ValueError, match="does not take"):
        stdp_update(*[ragged[k] for k in ("W", "x_pre", "x_post", "spk_pre", "spk_post", "c")],
                    route="tile")
    blk = stdp_inputs("blocks", "bfloat16", 2, "cpu")  # blocks of 20: no bf16 pieces
    with pytest.raises(ValueError, match="does not take"):
        stdp_update(*[blk[k] for k in ("W", "x_pre", "x_post", "spk_pre", "spk_post", "c")],
                    cols=blk["cols"], route="tile")
    # the default route still takes the plain version on the CPU
    W, _ = stdp_update(*args)
    torch.testing.assert_close(W, stdp.stdp_update_plain(*args)[0], rtol=0, atol=0)
