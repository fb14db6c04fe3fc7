"""K1, gather-OR: ``out[c] = OR_{j<w} values[idx[c*w + j]]``.

The reduction under every level of the staged pull BFS (``ops/ellbfs.py``).
Replaces the Pallas kernel ``hypergraphdb_tpu/ops/pallas_gather.py``
(``_kernel`` :95, launched by ``_call`` :137, public ``gather_or`` :163). The
TPU's artifacts are gone: no SEG segmentation for a 1 MB SMEM, no
``Kw % 128`` lane rule, no DMA slots, no minimum index count.

The CUDA kernel is ``csrc/gather_or.cu``: one warp per output row, 16 bytes
per lane per gathered row, the ``w`` index entries read in one load. It
skips what cannot add a bit: given the line-occupancy mask of ``values``
(``ops/linemask.py``) it loads a gathered row only where the row's line is
nonzero, and a lane whose accumulator is all ones stops. It emits the mask
of the rows it writes.

Bitmap words are ``int32`` on the port's side (PyTorch has no ``>>`` or
``index_add_`` on ``uint32``); the bits are those of the reference's uint32.
"""

from __future__ import annotations

from functools import reduce

import torch

from hypergraphdb_tpu_torch import verify as hgverify
from hypergraphdb_tpu_torch.ops import _cuda, linemask

#: output rows per streamed block of the plain version (bounds its
#: ``(rows, w, Kw)`` gather transient)
PLAIN_CHUNK = 1 << 16


def or_fold(x: torch.Tensor) -> torch.Tensor:
    """(R, w, Kw) → (R, Kw): OR over axis 1."""
    return reduce(torch.bitwise_or, x.unbind(1))


def gather_or_plain(values: torch.Tensor, idx: torch.Tensor, w: int,
                    out: torch.Tensor | None = None,
                    chunk: int = PLAIN_CHUNK,
                    out_mask: torch.Tensor | None = None,
                    mask_row0: int = 0) -> torch.Tensor:
    """The plain PyTorch version of K1: ``values[idx].view(-1, w, Kw)``
    OR-folded, streamed ``chunk`` output rows at a time; the exact line
    fields of the rows written are ORed into ``out_mask`` at rows
    ``mask_row0 + c``. It reads no input mask: under the mask contract the
    bitmap is the same with or without one."""
    n_out, Kw = idx.shape[0] // w, values.shape[1]
    if out is None:
        out = torch.empty((n_out, Kw), dtype=values.dtype, device=values.device)
    for s in range(0, n_out, chunk):
        e = min(s + chunk, n_out)
        out[s:e] = or_fold(values[idx[s * w : e * w]].view(e - s, w, Kw))
    if out_mask is not None:
        linemask.or_fields(out_mask, linemask.row_fields_of(out), mask_row0, Kw)
    return out


@hgverify.entry(
    "ops.pallas_gather.gather_or",
    shapes=lambda device, seed: (hgverify.words(device, seed, (8, 128)),
                                 hgverify.ints(device, seed, (2048,), 8)),
    statics={"w": 8},
)
def gather_or(values: torch.Tensor, idx: torch.Tensor, w: int,
              out: torch.Tensor | None = None,
              chunk: int = PLAIN_CHUNK,
              mask: torch.Tensor | None = None,
              out_mask: torch.Tensor | None = None,
              mask_row0: int = 0) -> torch.Tensor:
    """``(len(idx)//w, Kw)`` int32 where row c = OR of
    ``values[idx[c*w : (c+1)*w]]``; written into ``out`` when given (a
    contiguous ``(len(idx)//w, Kw)`` int32 tensor, which may be a section
    of the buffer ``values`` lies in as long as no gathered row lies in it).
    On the card ``out`` must start as a subset of the result (zeros, or an
    earlier result of values that only grew, as in a BFS), because rows
    whose result is all zero are not stored; with no ``out`` the result is
    written into zeros.

    ``mask`` is the line mask of ``values`` (a superset of its nonzero
    lines; ``None``: every line live). ``out_mask``, when given, is the
    line mask of the buffer ``out`` lies in: the exact fields of the rows
    written are ORed into it at rows ``mask_row0 + c``, so a caller that
    zeroes it before writing a buffer's sections gets the buffer's exact
    mask.

    A CUDA tensor launches the kernel; a CPU tensor runs the plain version
    (``chunk`` is its streaming block). Every ``idx`` entry must be a row
    of ``values``."""
    E = idx.shape[0]
    if values.dim() != 2 or values.dtype != torch.int32:
        raise ValueError(f"gather_or: values must be (S, Kw) int32, got "
                         f"{tuple(values.shape)} {values.dtype}")
    if idx.dim() != 1 or idx.dtype != torch.int32 or E % w or not 0 < w <= 32:
        raise ValueError(f"gather_or: need int32 idx with len % w == 0 and "
                         f"0 < w <= 32, got E={E} w={w} {idx.dtype}")
    n_out, Kw = E // w, values.shape[1]
    if out is None:
        out = torch.zeros((n_out, Kw), dtype=torch.int32, device=values.device)
    elif (out.shape != (n_out, Kw) or out.dtype != torch.int32
          or not out.is_contiguous() or out.device != values.device):
        raise ValueError(f"gather_or: out must be a contiguous ({n_out}, "
                         f"{Kw}) int32 tensor on {values.device}")
    if idx.device != values.device:
        raise ValueError("gather_or: values and idx on different devices")
    if mask is not None:
        linemask.check_mask(mask, values.shape[0], Kw, values.device,
                            "gather_or mask")
    if out_mask is not None:
        n_mask = out_mask.shape[0] * 32 // linemask.field_bits(Kw)
        if mask_row0 < 0 or mask_row0 + n_out > n_mask:
            raise ValueError(f"gather_or: out_mask rows [{mask_row0}, "
                             f"{mask_row0 + n_out}) exceed its {n_mask} rows")
        linemask.check_mask(out_mask, n_mask, Kw, values.device,
                            "gather_or out_mask")
    if values.device.type == "cpu":
        return gather_or_plain(values, idx, w, out=out, chunk=chunk,
                               out_mask=out_mask, mask_row0=mask_row0)
    if values.device.type != "cuda":
        raise ValueError(f"gather_or: unsupported device {values.device}")
    if not (values.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_or: values and idx must be contiguous")
    if n_out == 0:
        return out
    _cuda.check_rows(idx, values.shape[0], "gather_or idx")
    fn = _cuda.kernel("gather_or")
    code = fn(values.data_ptr(), idx.data_ptr(), out.data_ptr(), n_out, w,
              Kw, _cuda.ptr(mask), _cuda.ptr(out_mask), mask_row0,
              linemask.line_words(Kw), linemask.field_bits(Kw),
              _cuda.stream_of(values))
    gather_or.launches += 1
    _cuda.check(code, "gather_or")
    return out


#: kernel launches since the count was last set to 0
gather_or.launches = 0
