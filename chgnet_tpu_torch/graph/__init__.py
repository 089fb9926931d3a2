"""Graph construction on the host: neighbor search, edge pairing, line
graphs (the C++ builder or numpy) and padded batching with CSR segment
plans."""

from chgnet_tpu_torch.graph.batching import GraphBatch, batch_graphs
from chgnet_tpu_torch.graph.converter import CrystalGraphConverter
from chgnet_tpu_torch.graph.crystalgraph import CrystalGraph
from chgnet_tpu_torch.graph.graph import DirectedEdge, Graph, Node, UndirectedEdge

__all__ = [
    "CrystalGraph",
    "CrystalGraphConverter",
    "DirectedEdge",
    "Graph",
    "GraphBatch",
    "Node",
    "UndirectedEdge",
    "batch_graphs",
]
