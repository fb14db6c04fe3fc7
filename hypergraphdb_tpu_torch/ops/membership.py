"""K3, sorted-set membership: ``mask[i] = base[i] ≠ SENTINEL ∧ ∀j: base[i] ∈
row j``, over padded (M, Lo) rows or ragged rows ``flat[offsets[j],
offsets[j + 1])``.

The step under the planner's n-way intersection
(``setops.device_intersect_sorted``, which passes ragged rows). Replaces the
Pallas kernel ``hypergraphdb_tpu/ops/pallas_kernels.py`` (``_kernel`` :41,
launched by ``_membership_call`` :85; ``membership_mask_pallas`` :107,
``intersect_sorted_pallas`` :135). The TPU's power-of-two shapes, brute-force
tiled compare and VMEM guard (``fits_vmem``) are gone: the CUDA kernel,
``csrc/membership.cu``, takes ragged rows, streams each base tile's window of
a row through shared memory (or searches it in place when the window is far
longer than the tile) and has no size ceiling, so nothing routes around it on
the card. Both entries launch the one kernel and count into
``membership_mask.launches``; the padded form is the ragged one with
``offsets[j] = j · Lo``.

The plain versions are ``setops.intersect_mask_many`` (padded) and
``setops.intersect_mask_ragged``.
"""

from __future__ import annotations

import numpy as np
import torch

from hypergraphdb_tpu_torch.ops import _cuda
from hypergraphdb_tpu_torch.ops.setops import (
    intersect_mask_many,
    intersect_mask_ragged,
)


def _check_base(base: torch.Tensor, what: str) -> None:
    if base.dim() != 1 or base.dtype != torch.int32:
        raise ValueError(f"{what}: base must be (Lb,) int32, got "
                         f"{tuple(base.shape)} {base.dtype}")
    if base.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {base.device}")


def _launch(base: torch.Tensor, flat: torch.Tensor, offsets: torch.Tensor,
            m: int) -> torch.Tensor:
    out = torch.empty(base.shape, dtype=torch.bool, device=base.device)
    if base.numel() == 0:
        return out
    fn = _cuda.kernel("membership")
    code = fn(base.data_ptr(), flat.data_ptr(), offsets.data_ptr(),
              out.data_ptr(), base.numel(), m, _cuda.stream_of(base))
    membership_mask.launches += 1
    _cuda.check(code, "membership")
    return out


def membership_mask(base: torch.Tensor, others: torch.Tensor) -> torch.Tensor:
    """Bool (Lb,): which elements of ``base`` (Lb,) lie in every row of
    ``others`` (M, Lo). Both are int32, sorted ascending and
    SENTINEL-padded; a SENTINEL base element never matches.

    A CUDA tensor launches the kernel; a CPU tensor runs the plain
    version."""
    _check_base(base, "membership_mask")
    if others.dim() != 2 or others.dtype != torch.int32:
        raise ValueError(f"membership_mask: others must be (M, Lo) int32, "
                         f"got {tuple(others.shape)} {others.dtype}")
    if others.device != base.device:
        raise ValueError("membership_mask: base and others on different "
                         "devices")
    if base.device.type == "cpu":
        return intersect_mask_many(base, others)
    if not (base.is_contiguous() and others.is_contiguous()):
        raise ValueError("membership_mask: base and others must be contiguous")
    m, lo = others.shape
    offsets = torch.arange(m + 1, dtype=torch.int64, device=base.device) * lo
    return _launch(base, others, offsets, m)


def _check_offsets(offsets, n_flat: int, what: str) -> np.ndarray:
    """``offsets`` as a host int64 array, raising unless it is 1-D, starts
    at 0 or above, never decreases and ends at ``n_flat``."""
    host = np.asarray(offsets.numpy() if isinstance(offsets, torch.Tensor)
                      else offsets)
    if host.ndim != 1 or host.size == 0 or host.dtype.kind not in "iu":
        raise ValueError(f"{what}: offsets must be a non-empty 1-D integer "
                         f"array, got shape {host.shape} {host.dtype}")
    if host[0] < 0 or (np.diff(host) < 0).any() or host[-1] != n_flat:
        raise ValueError(f"{what}: offsets must never decrease, from 0 or "
                         f"above to flat.numel() = {n_flat}; got {host}")
    return host.astype(np.int64, copy=False)


def membership_mask_ragged(base: torch.Tensor, flat: torch.Tensor,
                           offsets: torch.Tensor,
                           offsets_host=None) -> torch.Tensor:
    """Bool (Lb,): which elements of ``base`` (Lb,) lie in every row
    ``flat[offsets[j], offsets[j + 1])``. ``base`` and ``flat`` are int32,
    ``base`` sorted ascending (a SENTINEL tail never matches), each row
    sorted ascending; ``offsets`` is (M + 1,) int64 on the same device.

    The offsets are checked on the host, never by a device sync: on a CUDA
    tensor pass ``offsets_host``, the host copy the caller built them from
    (a CPU ``offsets`` is its own). A CUDA tensor launches the kernel; a CPU
    tensor runs the plain version."""
    what = "membership_mask_ragged"
    _check_base(base, what)
    if flat.dim() != 1 or flat.dtype != torch.int32:
        raise ValueError(f"{what}: flat must be (N,) int32, got "
                         f"{tuple(flat.shape)} {flat.dtype}")
    if offsets.dim() != 1 or offsets.dtype != torch.int64:
        raise ValueError(f"{what}: offsets must be (M + 1,) int64, got "
                         f"{tuple(offsets.shape)} {offsets.dtype}")
    if not (flat.device == offsets.device == base.device):
        raise ValueError(f"{what}: base, flat and offsets on different "
                         f"devices")
    if offsets_host is None and base.device.type == "cpu":
        offsets_host = offsets
    if offsets_host is None:
        raise ValueError(f"{what}: a CUDA call needs offsets_host, the host "
                         f"copy of offsets (checked without a device sync)")
    host = _check_offsets(offsets_host, flat.numel(), what)
    if host.shape != tuple(offsets.shape):
        raise ValueError(f"{what}: offsets_host has {host.size} entries, "
                         f"offsets {offsets.numel()}")
    if base.device.type == "cpu":
        return intersect_mask_ragged(base, flat, host)
    if not (base.is_contiguous() and flat.is_contiguous()
            and offsets.is_contiguous()):
        raise ValueError(f"{what}: base, flat and offsets must be contiguous")
    return _launch(base, flat, offsets, offsets.numel() - 1)


#: kernel launches since the count was last set to 0 (both entries)
membership_mask.launches = 0
