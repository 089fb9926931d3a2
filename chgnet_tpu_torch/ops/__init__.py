"""The port's hand-written CUDA kernels, each beside its plain PyTorch version.

* ``segment``: ``segment_sum_csr``, ``segment_sum_pair`` and ``gather_rows``
  with the autograd pair ``plan_gather`` / ``plan_segment_sum``, and under
  ``CHGNET_TPU_STREAM_V2`` ``segment_sum_tiles`` and ``gather_rows_window``;
* ``gproj``: ``gather_project_sum``, the first-layer sum of every conv layer;
* ``gated_message``: the fused gated-MLP tails (message and update, forward
  and backward) behind ``fused_gated_message`` / ``fused_gated_update``, and
  the message tail fused with its sorted segment sum behind
  ``fused_gated_message_reduce``;
* ``multi_gather``: ``gather_sum_rows``, the sum of several gathered tables,
  behind ``gather_sum`` / ``twin_reduce`` (the undirected bond layout);
* ``fused_pass``: ``fused_pass_fwd`` / ``fused_pass_bwd``, a conv layer's
  first-layer sum and tail in one kernel, behind ``fused_layer_pass``
  (``CHGNET_TPU_FUSED_PASS``);
* ``build``: nvcc -> shared library -> ctypes, at first use.
"""

from chgnet_tpu_torch.ops.fused_pass import fused_pass_bwd, fused_pass_fwd
from chgnet_tpu_torch.ops.gated_message import (
    gated_message_bwd,
    gated_message_fwd,
    gated_message_reduce,
    gated_update_bwd,
    gated_update_fwd,
)
from chgnet_tpu_torch.ops.gproj import gather_project_sum_kernel
from chgnet_tpu_torch.ops.multi_gather import gather_sum_rows
from chgnet_tpu_torch.ops.segment import (
    gather_rows,
    gather_rows_window,
    segment_sum_csr,
    segment_sum_pair,
    segment_sum_tiles,
)

KERNELS = (
    segment_sum_csr, gather_rows, segment_sum_pair, gather_project_sum_kernel,
    gated_message_fwd, gated_message_bwd, gated_update_fwd, gated_update_bwd,
    gather_sum_rows, gated_message_reduce, segment_sum_tiles,
    gather_rows_window, fused_pass_fwd, fused_pass_bwd,
)


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch counts to 0: ``launches``, and
    ``launches_bf16``, those of them with bf16 arguments (every row, 1-14,
    of PERF.md's table launches in bf16 through its ``_bf16`` C entry
    point)."""
    for fn in KERNELS:
        fn.launches = fn.launches_bf16 = 0


__all__ = [
    "KERNELS",
    "fused_pass_bwd",
    "fused_pass_fwd",
    "gated_message_bwd",
    "gated_message_fwd",
    "gated_message_reduce",
    "gated_update_bwd",
    "gated_update_fwd",
    "gather_project_sum_kernel",
    "gather_rows",
    "gather_rows_window",
    "gather_sum_rows",
    "reset_launch_counts",
    "segment_sum_csr",
    "segment_sum_pair",
    "segment_sum_tiles",
]
