"""K3, sorted-set membership: ``mask[i] = base[i] ≠ SENTINEL ∧ ∀j: base[i] ∈
others[j]``.

The step under the planner's n-way intersection
(``setops.device_intersect_sorted``). Replaces the Pallas kernel
``hypergraphdb_tpu/ops/pallas_kernels.py`` (``_kernel`` :41, launched by
``_membership_call`` :85; ``membership_mask_pallas`` :107,
``intersect_sorted_pallas`` :135). The TPU's brute-force tiled compare and
its VMEM guard (``fits_vmem``) are gone: the CUDA kernel,
``csrc/membership.cu``, gives each base element one thread that binary
searches every other row. It has no size ceiling, so nothing routes around
it on the card.

The plain version is ``setops.intersect_mask_many``.
"""

from __future__ import annotations

import torch

from hypergraphdb_tpu_torch.ops import _cuda
from hypergraphdb_tpu_torch.ops.setops import intersect_mask_many


def membership_mask(base: torch.Tensor, others: torch.Tensor) -> torch.Tensor:
    """Bool (Lb,): which elements of ``base`` (Lb,) lie in every row of
    ``others`` (M, Lo). Both are int32, sorted ascending and
    SENTINEL-padded; a SENTINEL base element never matches.

    A CUDA tensor launches the kernel; a CPU tensor runs the plain
    version."""
    if base.dim() != 1 or base.dtype != torch.int32:
        raise ValueError(f"membership_mask: base must be (Lb,) int32, got "
                         f"{tuple(base.shape)} {base.dtype}")
    if others.dim() != 2 or others.dtype != torch.int32:
        raise ValueError(f"membership_mask: others must be (M, Lo) int32, "
                         f"got {tuple(others.shape)} {others.dtype}")
    if others.device != base.device:
        raise ValueError("membership_mask: base and others on different "
                         "devices")
    if base.device.type == "cpu":
        return intersect_mask_many(base, others)
    if base.device.type != "cuda":
        raise ValueError(f"membership_mask: unsupported device {base.device}")
    if not (base.is_contiguous() and others.is_contiguous()):
        raise ValueError("membership_mask: base and others must be contiguous")
    out = torch.empty(base.shape, dtype=torch.bool, device=base.device)
    if base.numel() == 0:
        return out
    m, lo = others.shape
    fn = _cuda.kernel("membership")
    code = fn(base.data_ptr(), others.data_ptr(), out.data_ptr(),
              base.numel(), m, lo, _cuda.stream_of(base))
    membership_mask.launches += 1
    _cuda.check(code, "membership")
    return out


#: kernel launches since the count was last set to 0
membership_mask.launches = 0
