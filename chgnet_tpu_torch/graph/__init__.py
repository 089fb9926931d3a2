"""Graph construction (host numpy): neighbor search, edge pairing, line
graphs and padded batching with CSR segment plans."""

from chgnet_tpu_torch.graph.batching import GraphBatch, batch_graphs
from chgnet_tpu_torch.graph.converter import CrystalGraphConverter
from chgnet_tpu_torch.graph.crystalgraph import CrystalGraph

__all__ = ["CrystalGraph", "CrystalGraphConverter", "GraphBatch", "batch_graphs"]
