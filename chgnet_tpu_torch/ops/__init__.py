"""The port's hand-written CUDA kernels, each beside its plain PyTorch version.

* ``segment``: ``segment_sum_csr``, ``segment_sum_pair`` and ``gather_rows``
  with the autograd pair ``plan_gather`` / ``plan_segment_sum``;
* ``gproj``: ``gather_project_sum``, the first-layer sum of every conv layer;
* ``build``: nvcc -> shared library -> ctypes, at first use.
"""

from chgnet_tpu_torch.ops.gproj import gather_project_sum_kernel
from chgnet_tpu_torch.ops.segment import gather_rows, segment_sum_csr, segment_sum_pair

KERNELS = (segment_sum_csr, gather_rows, segment_sum_pair, gather_project_sum_kernel)


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in KERNELS:
        fn.launches = 0


__all__ = [
    "KERNELS",
    "gather_project_sum_kernel",
    "gather_rows",
    "reset_launch_counts",
    "segment_sum_csr",
    "segment_sum_pair",
]
