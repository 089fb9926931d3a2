"""Host utilities of the port: device selection, meters, metrics, JSON,
parameter trees to and from ``.npz``, VASP parsing and profiling."""

from chgnet_tpu_torch.utils.common import (
    AverageMeter,
    count_params,
    cuda_devices_sorted_by_free_mem,
    determine_device,
    flatten_params,
    load_params,
    mae,
    mkdir,
    read_json,
    save_params,
    unflatten_params,
    write_json,
)
from chgnet_tpu_torch.utils.profiling import timeit, trace
from chgnet_tpu_torch.utils.vasp import parse_vasp_dir, solve_charge_by_mag

__all__ = [
    "AverageMeter",
    "count_params",
    "cuda_devices_sorted_by_free_mem",
    "determine_device",
    "flatten_params",
    "load_params",
    "mae",
    "mkdir",
    "parse_vasp_dir",
    "read_json",
    "save_params",
    "solve_charge_by_mag",
    "timeit",
    "trace",
    "unflatten_params",
    "write_json",
]
