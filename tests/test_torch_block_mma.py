"""The tensor-core route of ``block_int8_mv`` (``csrc/block_int8.cu``), on the CPU.

- a numpy model of ``block_int8_mma_kernel``, every lane of every warp of
  every thread block: the gathered stage of each trial's ``cb`` source
  segments, zero past the pass and past the trials, in rows padded to 64
  mod 128 bytes; the 16-byte loads of the blocks' rows at gathered columns
  (inside one segment each), as the card reads them from the flat buffer;
  the k-permutation that the A and B fragments share; the PTX ISA's
  m16n8k32 fragment layouts; the groups of 32 trials, the ragged rows of
  a block and the ragged n-tile; and the epilogue's writes, each output
  once.  It equals ``block_int8_mv_plain`` bit for bit for both index
  forms (a node coupling's cols, and a delayed edge's flat history index),
  and with the activation scales applied, the JAX package's
  ``block_int8_mv``;
- ``block_int8_mv_route`` and ``block_int8_mv_routes``: the route from the
  block size and the alignment.

The model reads the kernel's geometry from the source.  Inputs come from
numpy seeds.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectipy_tpu.ops import quant as jquant
from rectipy_tpu_torch.ops import quant as tquant
from rectipy_tpu_torch.ops._build import CSRC_DIR
from rectipy_tpu_torch.testing import mma_m16n8k32 as _mma_m16n8k32
from rectipy_tpu_torch.testing import words as _words

_LANE = np.arange(32)
_G, _T = _LANE >> 2, _LANE & 3  # the fragments' group and thread in group


def _geometry() -> dict:
    """The tensor-core route's constants, read from csrc/mma_s8.cuh (the k
    loop block_int8_mma_kernel shares with int8_mm_mma_kernel)."""
    with open(os.path.join(CSRC_DIR, "mma_s8.cuh")) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    geo = {k: const(name) for k, name in (
        ("warps", "kRowWarps"), ("tiles", "kRowTiles"), ("trials", "kRowTrials"),
        ("block_k", "kRowBlockK"), ("pass_cols", "kRowPassCols"))}
    m = re.search(r"constexpr int kRowStride = kRowPassCols / 128 \* 128 \+ 64;", src)
    assert m, "the stage stride's formula changed: update the model"
    geo["stride"] = geo["pass_cols"] // 128 * 128 + 64
    return geo


def _block_mma_model(bq, rs, xq, idx, geo, tiles_per_block=1):
    """The kernel's output, lane by lane: (B, n_br * bs) float32, for a
    grid whose thread blocks walk ``tiles_per_block`` tiles of rows each."""
    n_br, cb, bs, _ = bq.shape
    B, n_src = xq.shape[:2]
    assert bs % 32 == 0  # the route's condition
    warps, tiles = geo["warps"], geo["tiles"]
    assert geo["stride"] % 128 == 64 and geo["stride"] >= geo["pass_cols"]
    K = cb * bs
    flat_w, flat_x = bq.reshape(-1), xq.reshape(-1)
    rows_a = warps * 16 * tiles
    n_tiles = -(-bs // rows_a)
    # row0 of every warp of block row r, thread block by thread block: the
    # chunks of tiles_per_block tiles of rows, each tile's warps
    chunks = -(-n_tiles // tiles_per_block)
    row0 = np.asarray([tile * rows_a + 16 * tiles * w for chunk in range(chunks)
                       for tile in range(chunk * tiles_per_block,
                                         min((chunk + 1) * tiles_per_block, n_tiles))
                       for w in range(warps)])
    out = np.zeros((B, n_br * bs), np.float32)
    written = np.zeros((B, n_br * bs), np.int64)
    for b0 in range(0, B, geo["trials"]):
        nb = min(geo["trials"], B - b0)
        ntiles = -(-nb // 8)
        c = np.zeros((tiles, 4, 4, n_br, row0.size, 32), np.int64)  # u, nt, i, r, warp, lane
        for p0 in range(0, K, geo["pass_cols"]):
            pcols = min(geo["pass_cols"], K - p0)
            blocks = -(-pcols // geo["block_k"])
            span = blocks * geo["block_k"]
            # the stage: every 16-byte copy of each trial's row, zeros where
            # the copy is past the pass or the trials
            stage = np.full((n_br, 8 * ntiles, geo["stride"]), 77, np.int8)  # never read past span
            stage[:, :, :span] = 0
            k = np.arange(0, span, 16)
            kk = p0 + k[k < pcols]
            blk = kk // bs
            for b in range(nb):
                src = ((b0 + b) * n_src + idx[:, blk]) * bs + (kk - blk * bs)  # (n_br, copies)
                assert np.all(src + 16 <= flat_x.size)
                stage[:, b, (kk - p0)[:, None] + np.arange(16)] = flat_x[src[..., None]
                                                                         + np.arange(16)]
            # lane (g, t)'s loads of k-block kb, sub-block h: 16 bytes at the
            # gathered column kb * block_k + 64 h + 16 t of the pass
            kcol = (np.arange(blocks)[:, None, None] * geo["block_k"] + 64 * np.arange(2)[:, None]
                    + 16 * _T)  # (kb, h, lane)
            k_ok = kcol < pcols
            kk = p0 + np.where(k_ok, kcol, 0)
            blk = kk // bs
            assert np.all((kk - blk * bs) + 16 <= bs)  # a piece stays inside its segment
            regs = []  # per m: (r, warp, kb, h, lane, 4 words)
            for m in range(2 * tiles):
                i = row0[:, None] + 16 * (m >> 1) + 8 * (m & 1) + _G  # (warp, lane)
                ok = (i < bs)[None, :, None, None, :] & k_ok[None, None]
                addr = (np.arange(n_br)[:, None, None, None, None] * cb * bs * bs
                        + blk[None, None] * bs * bs + (kk - blk * bs)[None, None]
                        + np.where(i < bs, i, 0)[None, :, None, None, :] * bs)
                addr = np.where(ok, addr, 0)
                raw = flat_w[addr[..., None] + np.arange(16)] * ok[..., None]
                regs.append(_words(raw.astype(np.int8)))
            # B registers of n-tile nt: trial 8 nt + g's 16 staged bytes at the
            # lane's columns, (r, 1, kb, h, lane, 4 words)
            for nt in range(ntiles):
                cols = kcol[..., None] + np.arange(16)  # (kb, h, lane, 16)
                bv = _words(stage[:, 8 * nt + _G[:, None], cols][:, None])
                for u in range(tiles):
                    a0, a1 = regs[2 * u], regs[2 * u + 1]  # rows g and g + 8
                    for s in range(2):  # the k-steps of a sub-block: bytes 8s..8s+7
                        d = _mma_m16n8k32((a0[..., 2 * s], a1[..., 2 * s],
                                           a0[..., 2 * s + 1], a1[..., 2 * s + 1]),
                                          (bv[..., 2 * s], bv[..., 2 * s + 1]))
                        for i in range(4):
                            c[u, nt, i] += d[i].sum(axis=(2, 3))  # over k-blocks and sub-blocks
        # the epilogue: element i of fragment (u, nt) is row g + 8 (i / 2) of
        # m-tile u and trial 8 nt + 2t + i % 2
        for u, nt, i in np.ndindex(tiles, 4, 4):
            row = row0[:, None] + 16 * u + _G + 8 * (i >> 1)  # (warp, lane)
            b = 8 * nt + 2 * _T + (i & 1)
            keep = (row < bs) & (b < nb)[None]
            w_idx, ln = np.nonzero(keep)
            for r in range(n_br):
                o = r * bs + row[w_idx, ln]
                trial = b0 + b[ln]
                val = c[u, nt, i, r, w_idx, ln].astype(np.float32) * rs.reshape(-1)[o]
                out[trial, o] = val
                written[trial, o] += 1
    assert np.all(written == 1)  # every output once
    return out


def _operands(B, bs, cb, form, seed, n_br=3, nb_in=5, d1=3):
    """``form`` 'cols' indexes (B, nb_in, bs) sources by a node coupling's
    cols; 'history' a flat (B, nb_in * d1, bs) history by cols * d1 + slot,
    as the delayed edge's read would."""
    rng = np.random.default_rng(seed)
    bq = rng.integers(-127, 128, size=(n_br, cb, bs, bs)).astype(np.int8)
    rs = rng.random((n_br, bs)).astype(np.float32)
    cols = np.stack([rng.permutation(nb_in)[:cb] for _ in range(n_br)])
    if form == "cols":
        xq, idx = rng.integers(-127, 128, size=(B, nb_in, bs)), cols
    else:
        xq = rng.integers(-127, 128, size=(B, nb_in * d1, bs))
        idx = cols * d1 + rng.integers(0, d1, size=(n_br, cb))
    return bq, rs, xq.astype(np.int8), idx.astype(np.int32)


def _plain(bq, rs, xq, idx):
    return tquant.block_int8_mv_plain(*(torch.as_tensor(a) for a in (bq, rs, xq, idx))).numpy()


@pytest.mark.parametrize("form", ["cols", "history"])
@pytest.mark.parametrize("bs,cb", [(32, 1), (32, 4), (64, 1), (64, 4), (512, 1)])
@pytest.mark.parametrize("B", [1, 3, 8, 16, 17, 32, 33])
def test_block_mma_lane_model_equals_plain(B, bs, cb, form):
    # the tensor-core kernel's index mapping, modelled lane by lane, gives
    # block_int8_mv's plain result bit for bit: one n-tile (B = 1, 3, 8),
    # full groups (16, 32), a ragged n-tile (17), a second group of trials
    # (33); a block row of one warp's rows (bs = 32, three warps of the
    # block idle), of two (64) and of four blocks of rows (512); K of one
    # k-step (32 x 1) to a full pass (512 x 4 is the million-neuron cell's)
    ops = _operands(B, bs, cb, form, seed=B * 100 + bs + cb)
    np.testing.assert_array_equal(_block_mma_model(*ops, _geometry()), _plain(*ops))


@pytest.mark.parametrize("B", [1, 17, 33])
def test_block_mma_lane_model_at_the_cells_block(B):
    # bs = 512 with cb = 4: 2,048 gathered columns, the whole pass and 16
    # k-blocks of 4 segments, as at N = 1,000,448 (one block row)
    ops = _operands(B, 512, 4, "cols", seed=B, n_br=1, nb_in=4)
    np.testing.assert_array_equal(_block_mma_model(*ops, _geometry()), _plain(*ops))


@pytest.mark.parametrize("tiles_per_block", [1, 2, 3, 4])
def test_block_mma_lane_model_two_passes_and_ragged_row_tiles(tiles_per_block):
    # cb * bs = 5 x 480 = 2,400 gathered columns: a second pass of 352
    # (its last k-block 96 wide), bs = 480 not a multiple of the 128 rows
    # of a tile, segments that start inside a k-block; thread blocks that
    # walk 1 to 4 of the 4 tiles (3: a short last chunk), restaging each
    # pass
    geo = _geometry()
    ops = _operands(9, 480, 5, "history", seed=11, n_br=2, nb_in=6, d1=2)
    assert 5 * 480 > geo["pass_cols"]
    got = _block_mma_model(*ops, geo, tiles_per_block=tiles_per_block)
    np.testing.assert_array_equal(got, _plain(*ops))


@pytest.mark.parametrize("tiles_per_block", [2, 4])
def test_block_mma_lane_model_walks_tiles_on_one_stage(tiles_per_block):
    # one pass (cb * bs = 2,048): a thread block stages its block row once
    # and walks 2 or 4 tiles of 128 rows on it, as the million-neuron cell's
    # calls do
    ops = _operands(20, 512, 4, "cols", seed=20 + tiles_per_block, n_br=2, nb_in=4)
    got = _block_mma_model(*ops, _geometry(), tiles_per_block=tiles_per_block)
    np.testing.assert_array_equal(got, _plain(*ops))


def test_block_mma_lane_model_with_scales_equals_jax():
    # the model's sums with the activation scales applied, trial by trial,
    # against the JAX package's block_int8_mv of the same source
    rng = np.random.default_rng(5)
    n_br, cb, bs, B = 3, 2, 64, 3
    cols = np.stack([rng.permutation(n_br)[:cb] for _ in range(n_br)])
    blocks = rng.normal(size=(n_br, cb, bs, bs)).astype(np.float32)
    bq, scale = (t.numpy() for t in tquant.quantize_blocks(torch.as_tensor(blocks)))
    src = rng.normal(size=(B, n_br * bs)).astype(np.float32)
    xq, xs = (t.numpy() for t in tquant.quant_vec(torch.as_tensor(src)))
    got = _block_mma_model(bq, scale, xq.reshape(B, n_br, bs), cols.astype(np.int32),
                           _geometry()) * xs.reshape(-1, 1)
    for b in range(B):
        want = jquant.block_int8_mv((jnp.asarray(bq), jnp.asarray(scale)), jnp.asarray(cols),
                                    jnp.asarray(src[b]))
        np.testing.assert_array_equal(got[b], np.asarray(want))


@pytest.mark.parametrize("bs,bq_ptr,xq_ptr,route", [
    (512, 4096, 8192, "mma"),  # the million-neuron cell
    (32, 4096, 8192 + 16, "mma"),
    (256, 4096, 8192, "mma"),
    (48, 4096, 8192, "vec16"),  # bs % 32 != 0
    (512, 4096, 8192 + 8, "vec4"),  # activations 8-byte aligned only
    (512, 4096 + 4, 8192, "vec4"),
    (20, 4096, 8192, "vec4"),  # the reference's bs = 20
    (16, 4096, 8192, "vec16"),  # and 16
    (4, 4096, 8192, "vec4"),  # and 4
    (512, 4096 + 1, 8192, "scalar"),  # a view one byte into its buffer
    (7, 4096, 8192, "scalar"),
])
def test_block_int8_mv_route(bs, bq_ptr, xq_ptr, route):
    # the route is a pure function of the block size and the two addresses:
    # the tensor cores wherever bs % 32 == 0 and both are 16-byte aligned,
    # at any number of trials, else the widest __dp4a pieces they allow
    assert tquant.block_int8_mv_route(bs, bq_ptr, xq_ptr) == route
    routes = tquant.block_int8_mv_routes(bs, bq_ptr, xq_ptr)
    assert routes[0] == route and routes[-1] == "scalar"
    assert ("mma" in routes) == (bs % 32 == 0 and (bq_ptr | xq_ptr) % 16 == 0)
