"""Hand-written Hopper kernels for the paper's benchmarks and the LM path.

Each subpackage follows the kernel/ops/ref triple:

* ``kernel.py`` — the wrapper that launches the CUDA C++ kernel from
  ``repro_torch/csrc`` (checks its arguments, allocates outputs, counts
  launches),
* ``ops.py``    — the public function: the kernel for a CUDA tensor, the
  plain version for a CPU tensor or on ``use_ref=True``,
* ``ref.py``    — the plain PyTorch version of the same function.

All thirteen are ported: kmeans, stencil2d (HotSpot), coclustering, gemm,
and the paper's other section 4.2 benchmarks black_scholes, spmv_ell, md5,
nbody and correlator; the serving path's flash_attention (prefill) and
decode_attention (decode); and the recurrent families' scans, rwkv6 (WKV6)
and rg_lru (RG-LRU).
"""

from .black_scholes import black_scholes, black_scholes_ref
from .coclustering import cluster_sums, cluster_sums_ref
from .correlator import correlate, correlate_ref
from .decode_attention import decode_attention, decode_attention_ref
from .flash_attention import attention_ref, flash_attention
from .gemm import gemm, gemm_ref
from .kmeans import (
    kmeans_assign_reduce,
    kmeans_assign_reduce_ref,
    kmeans_iteration,
    kmeans_iteration_ref,
)
from .md5 import md5_search, md5_search_ref, md5_u32x2
from .nbody import nbody_forces, nbody_forces_ref, nbody_step, nbody_step_ref
from .rg_lru import rg_lru, rg_lru_ref
from .rwkv6 import wkv6, wkv6_ref
from .spmv_ell import spmv_ell, spmv_ell_ref
from .stencil2d import hotspot_step, hotspot_step_ref

__all__ = [
    "attention_ref", "black_scholes", "black_scholes_ref", "cluster_sums",
    "cluster_sums_ref", "correlate", "correlate_ref", "decode_attention", "decode_attention_ref",
    "flash_attention", "gemm", "gemm_ref", "hotspot_step", "hotspot_step_ref",
    "kmeans_assign_reduce", "kmeans_assign_reduce_ref", "kmeans_iteration",
    "kmeans_iteration_ref", "md5_search", "md5_search_ref", "md5_u32x2",
    "nbody_forces", "nbody_forces_ref", "nbody_step", "nbody_step_ref",
    "rg_lru", "rg_lru_ref", "spmv_ell", "spmv_ell_ref", "wkv6", "wkv6_ref",
]
