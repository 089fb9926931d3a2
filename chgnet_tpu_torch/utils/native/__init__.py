"""The port's native host code: the g++ builder of its host libraries and
the threaded host ops (row gathers, radix argsort)."""

from chgnet_tpu_torch.utils.native.hostops import fast_gather

__all__ = ["fast_gather"]
