"""Public wrapper for the MD5 key-search kernel."""

from __future__ import annotations

import torch

from ...device import resolve_device
from .kernel import md5_search_cuda
from .ref import md5_search_ref


def md5_search(
    n: int,
    target: tuple[int, int, int, int],
    *,
    block: int = 8 * 128 * 8,
    use_ref: bool = False,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Smallest key index in [0, n) whose MD5 matches ``target`` (else n),
    as a 0-d int32 tensor on ``device``.

    The search takes no tensor to find its device from: ``device=None``
    means the GPU, as for ``Context``, and fails where there is none.  On a
    CUDA device this launches the hand-written kernel; ``device="cpu"`` (or
    ``use_ref=True``) takes the plain version.  ``block`` is accepted for
    the reference's signature; the kernel picks its own grid."""
    del block
    device = resolve_device(device)
    if use_ref or device.type == "cpu":
        return md5_search_ref(n, target, device=device)
    return md5_search_cuda(n, target, device).reshape(())
