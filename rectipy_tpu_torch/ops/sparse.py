"""Block-sparse couplings: a fixed number of dense source blocks per block row.

Counterpart of ``rectipy_tpu/ops/sparse.py``.  A ``BlockSparseCoupling``
stores ``blocks (n_br, cb, bs, bs)`` and ``cols (n_br, cb)``: block
``blocks[r, c]`` couples source block ``cols[r, c]`` into output block
``r``, so that

    s_in[r*bs:(r+1)*bs] = sum_c blocks[r, c] @ s[cols[r, c]*bs : +bs]

The product is a gather of whole ``bs``-long source blocks and a batched
dense contraction: ``n_br * cb`` matrix products of ``(bs, bs)`` blocks,
computed here with ``torch.bmm`` (the JAX package leaves the same einsum to
XLA).  At fan-in 1,000 and ``bs = 512`` the stored coupling is ``N * 2048``
weights, about 50 times fewer than the dense ``N * N`` at N = 100,000, and
each step streams it once.  The int8 contraction of the quantized couplings
is a hand-written kernel (``ops/quant.py``, ``block_int8_mv``).

Precision follows the JAX package's ``preferred_element_type=float32``:
:func:`block_sparse_matvec` returns the exact product rounded once to
float32 (in the source's dtype), whatever the operands' width; bfloat16
operands multiply exactly and sum in float32.

``block_random_connectivity`` samples fixed fan-in rows from each block
row's randomly chosen source blocks: the numpy backend makes the JAX
package's blocks and cols bit for bit from the same seed, and so does the
native (C++) backend, which is the same sampler (``native/``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

__all__ = ["BlockSparseCoupling", "block_contract", "block_random_connectivity", "gather_blocks",
           "block_sparse_matvec", "blocks_to_device"]

# elements a host-to-device copy or a quantization pass of block rows moves
# at once (256 MB of float32): a million-neuron coupling is 2e9 weights, and
# a whole-tensor pass would hold several temporaries of its size
CHUNK_ELEMS = 1 << 26


@dataclass
class BlockSparseCoupling:
    """Fixed-degree block-sparse matrix: ``blocks[r, c]`` is the dense
    ``(bs, bs)`` tile coupling source block ``cols[r, c]`` into output block
    ``r``.  Behaves like an ``(n, m)`` matrix for the Network/DSL layer."""

    blocks: np.ndarray  # (n_br, cb, bs, bs)
    cols: np.ndarray  # (n_br, cb) int32, source block indices

    def __post_init__(self):
        self.blocks = np.asarray(self.blocks)
        self.cols = np.asarray(self.cols, dtype=np.int32)
        if self.blocks.ndim != 4 or self.cols.ndim != 2 \
                or self.blocks.shape[:2] != self.cols.shape \
                or self.blocks.shape[2] != self.blocks.shape[3]:
            raise ValueError(
                f"blocks must be (n_br, cb, bs, bs) with cols (n_br, cb); got "
                f"{self.blocks.shape} / {self.cols.shape}")

    @property
    def bs(self) -> int:
        return self.blocks.shape[2]

    @property
    def shape(self) -> tuple:
        # (n, max(m, n)), as the JAX package reports it: the DSL asks for a
        # square recurrent coupling
        n = self.blocks.shape[0] * self.bs
        m = (int(self.cols.max()) + 1) * self.bs if self.cols.size else 0
        return (n, max(m, n))

    @property
    def ndim(self) -> int:
        return 2

    def to_dense(self) -> np.ndarray:
        n, m = self.shape
        bs = self.bs
        W = np.zeros((n, m), dtype=self.blocks.dtype)
        for r in range(self.blocks.shape[0]):
            for c in range(self.blocks.shape[1]):
                j = int(self.cols[r, c]) * bs
                W[r * bs:(r + 1) * bs, j:j + bs] += self.blocks[r, c]
        return W

    def matvec(self, s: torch.Tensor) -> torch.Tensor:
        return block_sparse_matvec(blocks_to_device(self.blocks, s.dtype, s.device),
                                   torch.as_tensor(self.cols, device=s.device), s)


def blocks_to_device(blocks, dtype: torch.dtype, device) -> torch.Tensor:
    """A copy of the ``(n_br, ...)`` host array ``blocks`` on ``device`` in
    ``dtype``, moved and cast a chunk of block rows at a time (each value
    rounds once, as a whole-array cast rounds it)."""
    src = torch.from_numpy(np.ascontiguousarray(blocks))
    out = torch.empty(src.shape, dtype=dtype, device=device)
    step = max(1, CHUNK_ELEMS // max(1, src[0].numel()))
    for lo in range(0, src.shape[0], step):
        out[lo:lo + step] = src[lo:lo + step].to(device).to(dtype)
    return out


def _bmm(a: torch.Tensor, x: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """``a @ x`` (batched) summed in ``acc``.  bfloat16/float16 operands
    multiply exactly in float32; on the card ``torch.bmm(..., out_dtype=
    float32)`` keeps them at their width (no float32 copy of the blocks per
    step) where no gradient is asked for; otherwise both are cast to
    ``acc`` first."""
    if (a.is_cuda and acc == torch.float32 and a.dtype == x.dtype
            and a.dtype in (torch.bfloat16, torch.float16)
            and not (torch.is_grad_enabled() and (a.requires_grad or x.requires_grad))):
        return torch.bmm(a, x, out_dtype=torch.float32)
    return torch.bmm(a.to(acc), x.to(acc))


def block_contract(blocks: torch.Tensor, s_blk: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """``out[..., r, i] = sum_c sum_j blocks[r, c, i, j] * s_blk[..., r, c, j]``
    in ``acc``: the JAX package's ``einsum("rcij,rcj->ri", ...,
    preferred_element_type=acc)``.  ``s_blk`` is a gathered source stack
    ``(..., n_br, cb, bs)`` with any leading (trial) axes; ``blocks`` is
    shared ``(n_br, cb, bs, bs)`` or per trial ``(B, n_br, cb, bs, bs)``
    (a coupling swept by ``run_batch``).  One batched product over the
    ``n_br * cb`` blocks (the trials side by side as its columns), then the
    sum over the ``cb`` blocks of a row."""
    n_br, cb, bs = blocks.shape[-4], blocks.shape[-3], blocks.shape[-2]
    lead = s_blk.shape[:-3]
    if blocks.dim() == 4:
        L = int(np.prod(lead, dtype=np.int64)) if lead else 1
        x = s_blk.reshape(L, n_br * cb, bs).permute(1, 2, 0)
        y = _bmm(blocks.reshape(n_br * cb, bs, bs), x, acc)  # (n_br*cb, bs, L)
        out = y.reshape(n_br, cb, bs, L).sum(1).permute(2, 0, 1)
        return out.reshape(*lead, n_br, bs)
    x = s_blk.reshape(-1, bs, 1)
    y = _bmm(blocks.reshape(-1, bs, bs), x, acc)
    return y.reshape(*lead, n_br, cb, bs).sum(-2)


def gather_blocks(s: torch.Tensor, cols: torch.Tensor, bs: int) -> torch.Tensor:
    """The source blocks ``s[..., cols[r, c]*bs : +bs]`` as ``(..., n_br,
    cb, bs)``: one gather of whole contiguous blocks."""
    return s.reshape(*s.shape[:-1], -1, bs)[..., cols.long(), :]


def block_sparse_matvec(blocks, cols, s, cast_dtype=None) -> torch.Tensor:
    """``s_in = A @ s`` for a block-sparse ``A``: one block gather and one
    batched contraction.  ``s`` may carry leading (trial) axes ``(...,
    n)``.  ``cast_dtype`` casts both operands first (bfloat16: exact
    products, float32 sums).  The result is the product rounded to float32,
    returned in ``s``'s dtype (the JAX package's
    ``preferred_element_type=float32`` followed by ``astype(s.dtype)``): at
    float64 the sums run in float64 and round once."""
    n_br, bs = blocks.shape[-4], blocks.shape[-2]
    s_blk = gather_blocks(s, cols, bs)
    if cast_dtype is not None:
        blocks = blocks.to(cast_dtype)
        s_blk = s_blk.to(cast_dtype)
    acc = torch.float64 if torch.float64 in (blocks.dtype, s_blk.dtype) else torch.float32
    out = block_contract(blocks, s_blk, acc).to(torch.float32)
    return out.reshape(*s.shape[:-1], n_br * bs).to(s.dtype)


def block_random_connectivity(n: int, m: int, fan_in: int, block_size: int = 512,
                              source_blocks: Optional[int] = None, seed: int = 0,
                              normalize: bool = True, dtype=np.float32,
                              backend: str = "auto") -> BlockSparseCoupling:
    """Sample fixed-fan-in random connectivity with block-local sources.

    Each neuron receives exactly ``fan_in`` distinct connections (weight
    ``1/fan_in`` when ``normalize``), drawn uniformly from the
    ``source_blocks`` source blocks assigned to its block row.  With
    ``source_blocks * block_size >= 2 * fan_in`` the in-block density stays
    at most 50%.

    ``backend``: ``"auto"`` takes the native C++ sampler for float32 blocks
    (numpy where it is unavailable), ``"numpy"`` the argsort construction,
    which costs minutes of host time at N = 1e6.  Both make the JAX
    package's blocks and cols bit for bit for the same seed and backend;
    ``block_random_connectivity.last_backend`` says which one the last call
    took (``"native"`` or ``"numpy"``)."""
    if n % block_size or m % block_size:
        raise ValueError(f"n={n} and m={m} must be multiples of block_size={block_size}")
    nb_out, nb_in = n // block_size, m // block_size
    if source_blocks is None:
        source_blocks = min(nb_in, max(1, int(np.ceil(2.0 * fan_in / block_size))))
    cand = source_blocks * block_size
    if fan_in > cand:
        raise ValueError(f"fan_in={fan_in} exceeds candidate pool "
                         f"{source_blocks}x{block_size}={cand}")
    rng = np.random.default_rng(seed)
    cols = np.stack([rng.choice(nb_in, size=source_blocks, replace=False)
                     for _ in range(nb_out)]).astype(np.int32)
    blocks = np.zeros((nb_out, source_blocks, block_size, block_size), dtype=dtype)
    w = (1.0 / fan_in) if normalize else 1.0
    # the native sampler writes each neuron's fan_in picks directly: O(nb_out
    # * bs * fan_in) writes, against numpy's O(nb_out * bs * cand * log(cand))
    # sort; a different (but per-seed deterministic) sample, same contract
    if backend != "numpy" and dtype == np.float32:
        from ..native.connectivity import fill_block_fanin

        if fill_block_fanin(blocks, source_blocks, block_size, fan_in, seed, w):
            block_random_connectivity.last_backend = "native"
            return BlockSparseCoupling(blocks, cols)
    for r in range(nb_out):
        picks = np.argsort(rng.random((block_size, cand)), axis=1)[:, :fan_in]
        c_idx, j_idx = picks // block_size, picks % block_size
        i_idx = np.repeat(np.arange(block_size), fan_in)
        blocks[r, c_idx.ravel(), i_idx, j_idx.ravel()] = w
    block_random_connectivity.last_backend = "numpy"
    return BlockSparseCoupling(blocks, cols)


block_random_connectivity.last_backend = None
