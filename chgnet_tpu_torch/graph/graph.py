"""Object-graph API: Node / DirectedEdge / UndirectedEdge / Graph.

A copy of ``chgnet_tpu.graph.graph``, the API of upstream CHGNet's
``chgnet/graph/graph.py``: an incremental, object-based graph builder for
inspection and debugging, and a third implementation held against the
numpy array builder and the C++ builder.

The hot path does NOT use these objects (flat arrays only, see
``builder.py``); numbering conventions (undirected ids by first
appearance, line-graph enumeration order) match the array builders, so all
three agree exactly when fed edges in canonical order.
"""

from __future__ import annotations

import numpy as np


class Node:
    """A node (atom) with its outgoing directed edges grouped by neighbor."""

    def __init__(self, index: int, info: dict | None = None) -> None:
        self.index = index
        self.info = info
        self.neighbors: dict[int, list[DirectedEdge]] = {}

    def add_neighbor(self, index: int, edge: DirectedEdge) -> None:
        """Record a directed edge from this node to neighbor ``index``."""
        self.neighbors.setdefault(index, []).append(edge)


class Edge:
    """Base edge: a pair of node indices + info (image, distance)."""

    def __init__(
        self, nodes: list[int], index: int | None = None, info: dict | None = None
    ) -> None:
        self.nodes = nodes
        self.index = index
        self.info = info or {}

    def __repr__(self) -> str:
        nodes, index, info = self.nodes, self.index, self.info
        return f"{type(self).__name__}(nodes={nodes!r}, index={index!r}, info={info!r})"

    def __hash__(self) -> int:
        img = self.info.get("image")
        img_tuple = () if img is None else tuple(np.asarray(img).astype(int))
        return hash((tuple(self.nodes), img_tuple))


class UndirectedEdge(Edge):
    """An undirected bond; ``index`` is the undirected edge id."""

    __hash__ = Edge.__hash__

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, UndirectedEdge)
            and self.nodes == other.nodes
            and self.info == other.info
        )


class DirectedEdge(Edge):
    """A directed bond; equality treats the reversed periodic image as the
    same physical bond: (i, j, img) == (j, i, -img)."""

    __hash__ = Edge.__hash__

    def make_undirected(self, index: int, info: dict | None = None) -> UndirectedEdge:
        info = dict(info or {})
        info["distance"] = self.info["distance"]
        return UndirectedEdge(sorted(self.nodes), index, info)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, DirectedEdge):
            return False
        self_img = np.asarray(self.info.get("image"))
        other_img = np.asarray(other.info.get("image"))
        none_img = self_img.ndim == 0 or other_img.ndim == 0
        distance_ok = abs(self.info["distance"] - other.info["distance"]) < 1e-6
        if self.nodes == other.nodes and distance_ok:
            if none_img or (self_img == other_img).all():
                return True
        return (
            self.nodes == other.nodes[::-1]
            and distance_ok
            and (none_img or (self_img == -other_img).all())
        )


class Graph:
    """Incremental dedup of directed edges into undirected bonds plus
    adjacency / line-graph extraction (upstream ``graph.py:121-358`` semantics)."""

    def __init__(self, nodes: list[Node]) -> None:
        self.nodes = nodes
        self.directed_edges_list: list[DirectedEdge] = []
        self.undirected_edges_list: list[UndirectedEdge] = []
        # keyed by (min(i,j), max(i,j)) -> list of undirected edges
        self.undirected_edges: dict[tuple[int, int], list[UndirectedEdge]] = {}

    def add_edge(
        self,
        center_index: int,
        neighbor_index: int,
        image: np.ndarray,
        distance: float,
        dist_tol: float = 1e-6,
    ) -> None:
        """Add one directed edge, pairing it with its reverse partner's
        undirected bond when that already exists."""
        image = np.asarray(image, dtype=np.int64)
        directed = DirectedEdge(
            [center_index, neighbor_index],
            index=len(self.directed_edges_list),
            info={"image": image, "distance": distance},
        )
        key = tuple(sorted((center_index, neighbor_index)))
        for undirected in self.undirected_edges.get(key, []):
            if abs(undirected.info["distance"] - distance) >= dist_tol:
                continue
            members = undirected.info["directed_edge_index"]
            first = self.directed_edges_list[members[0]]
            if len(members) == 1 and directed == first and directed is not first:
                # the reverse partner (or the second loop of a self-edge)
                directed.info["undirected_edge_index"] = undirected.index
                members.append(directed.index)
                self.nodes[center_index].add_neighbor(neighbor_index, directed)
                self.directed_edges_list.append(directed)
                return
        # a brand-new undirected bond
        undirected = directed.make_undirected(
            index=len(self.undirected_edges_list),
            info={"directed_edge_index": [directed.index]},
        )
        directed.info["undirected_edge_index"] = undirected.index
        self.undirected_edges.setdefault(key, []).append(undirected)
        self.undirected_edges_list.append(undirected)
        self.nodes[center_index].add_neighbor(neighbor_index, directed)
        self.directed_edges_list.append(directed)

    def adjacency_list(self) -> tuple[list[list[int]], list[int]]:
        """([[center, neighbor], ...], directed2undirected)."""
        graph = [edge.nodes for edge in self.directed_edges_list]
        directed2undirected = [
            edge.info["undirected_edge_index"]
            for edge in self.directed_edges_list
        ]
        return graph, directed2undirected

    def line_graph_adjacency_list(
        self, cutoff: float
    ) -> tuple[list[list[int]], list[int]]:
        """(line graph rows [center, und_i, dir_i, und_j, dir_j],
        undirected2directed). Left bonds participate when d <= cutoff;
        right bonds are all directed edges from the shared center with
        d < cutoff, excluding the left bond's own directed edge."""
        if len(self.directed_edges_list) != 2 * len(self.undirected_edges_list):
            raise ValueError(
                "inconsistent graph: expected exactly two directed edges "
                f"per undirected bond, got {len(self.directed_edges_list)} "
                f"directed vs {len(self.undirected_edges_list)} undirected "
                "(some bond is missing its reverse edge)"
            )
        line_graph: list[list[int]] = []
        undirected2directed: list[int] = []
        # per-center short directed edges, ascending directed index
        short: dict[int, list[DirectedEdge]] = {}
        for edge in self.directed_edges_list:
            if edge.info["distance"] < cutoff:
                short.setdefault(edge.nodes[0], []).append(edge)

        for u_edge in self.undirected_edges_list:
            undirected2directed.append(u_edge.info["directed_edge_index"][0])
            if u_edge.info["distance"] > cutoff:
                continue
            for d_index in u_edge.info["directed_edge_index"]:
                d_edge = self.directed_edges_list[d_index]
                center = d_edge.nodes[0]
                for other in short.get(center, []):
                    if other.index == d_edge.index:
                        continue
                    line_graph.append(
                        [
                            center,
                            u_edge.index,
                            d_edge.index,
                            other.info["undirected_edge_index"],
                            other.index,
                        ]
                    )
        return line_graph, undirected2directed

    def undirected2directed(self) -> list[int]:
        """First directed-edge id per undirected edge."""
        return [
            edge.info["directed_edge_index"][0]
            for edge in self.undirected_edges_list
        ]

    def as_dict(self) -> dict:
        directed_edges: dict[tuple[int, int], list[DirectedEdge]] = {}
        for edge in self.directed_edges_list:
            directed_edges.setdefault(tuple(edge.nodes), []).append(edge)
        return {
            "nodes": self.nodes,
            "directed_edges": directed_edges,
            "directed_edges_list": self.directed_edges_list,
            "undirected_edges": self.undirected_edges,
            "undirected_edges_list": self.undirected_edges_list,
        }

    def __repr__(self) -> str:
        return (
            f"Graph(num_nodes={len(self.nodes)!r}, "
            f"num_directed_edges={len(self.directed_edges_list)!r}, "
            f"num_undirected_edges={len(self.undirected_edges_list)!r})"
        )
