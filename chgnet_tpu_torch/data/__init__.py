"""Datasets and padded-batch loaders (port of ``chgnet_tpu.data``)."""

from chgnet_tpu_torch.data.dataset import (
    CIFData,
    GraphData,
    GraphLoader,
    StructureData,
    StructureJsonData,
    collate_graphs,
    collate_padded,
    get_loader,
    get_train_val_test_loader,
)

__all__ = [
    "CIFData",
    "GraphData",
    "GraphLoader",
    "StructureData",
    "StructureJsonData",
    "collate_graphs",
    "collate_padded",
    "get_loader",
    "get_train_val_test_loader",
]
