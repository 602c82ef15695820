"""Dataflow DAG used by the pipeline engine.

The port's copy of ``aiko_services_tpu/utils/graph.py`` (it has no JAX in
it); its imports point at the port's own modules.

Graph definitions arrive as S-expressions, e.g.::

    (PE_0 (PE_1 PE_3 (a: x)) (PE_2 PE_3 (b: y)))

where nesting expresses successor edges and a trailing inline dict attaches
edge *properties* (used by the pipeline for input name-mapping).  Behavior
matches the reference (upstream aiko_services ``main/utilities/
graph.py:42-181``): ``get_path()`` yields a depth-first execution order in
which a node revisited later is *moved* later (so joins run after all their
predecessors), ``iterate_after()`` resumes mid-path (remote-element
continuations), and ``"local:remote"`` graph-path strings split a path into
the locally- and remotely-executed halves.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional

from .sexpr import parse_tree

__all__ = ["Graph", "Node"]


class Node:
    def __init__(self, name: str, element: Any = None,
                 properties: Optional[Dict] = None):
        self.name = name
        self.element = element
        self.properties = properties or {}
        self._successors: "OrderedSet" = dict.fromkeys([])  # ordered set
        self._graph: Optional["Graph"] = None    # set by Graph.add

    @property
    def successors(self) -> List[str]:
        return list(self._successors)

    def add(self, successor_name: str):
        self._successors[successor_name] = None
        if self._graph is not None:
            self._graph._invalidate_paths()

    def remove(self, successor_name: str):
        self._successors.pop(successor_name, None)
        if self._graph is not None:
            self._graph._invalidate_paths()

    def __repr__(self):
        return f"Node({self.name} -> {self.successors})"


class Graph:
    def __init__(self):
        self._nodes: Dict[str, Node] = {}
        self._heads: Dict[str, None] = {}
        #: head_name -> computed execution order.  get_path runs once
        #: per FRAME in the pipeline hot loop but topology only changes
        #: at construction / remote-element (un)wiring, so the DFS is
        #: memoized; any edge mutation invalidates (profiled: ~20% of
        #: in-process frame time before caching).
        self._path_cache: Dict[str, List[Node]] = {}

    def _invalidate_paths(self):
        self._path_cache.clear()

    # -- construction ------------------------------------------------------ #

    def add(self, node: Node, head: bool = False):
        if node.name in self._nodes:
            raise KeyError(f"Graph already contains node: {node.name}")
        self._nodes[node.name] = node
        node._graph = self
        self._path_cache.clear()
        if head:
            self._heads[node.name] = None

    def get_node(self, name: str) -> Node:
        return self._nodes[name]

    def __contains__(self, name: str) -> bool:
        return name in self._nodes

    def nodes(self, as_strings: bool = False) -> List:
        if as_strings:
            return list(self._nodes)
        return list(self._nodes.values())

    @property
    def head_names(self) -> List[str]:
        return list(self._heads)

    # -- traversal --------------------------------------------------------- #

    def get_path(self, head_name: Optional[str] = None) -> Iterator[Node]:
        """Execution order from a head node.

        Depth-first; when a node is reached again by a later edge it is
        re-ordered to run after that edge's source — i.e. a fan-in node runs
        once, after all of its predecessors on the path.
        """
        if not self._heads:
            return iter(())
        if head_name is None:
            head_name = next(iter(self._heads))
        if head_name not in self._heads:
            return iter(())
        cached = self._path_cache.get(head_name)
        if cached is not None:
            return iter(cached)
        order: Dict[Node, None] = {}

        def visit(node: Node):
            order.pop(node, None)   # re-insert at the end on revisit
            order[node] = None
            for successor in node._successors:
                visit(self._nodes[successor])

        visit(self._nodes[head_name])
        path = list(order)
        self._path_cache[head_name] = path
        return iter(path)

    def __iter__(self):
        return self.get_path()

    def iterate_after(self, name: str,
                      head_name: Optional[str] = None) -> List[Node]:
        """Nodes strictly after ``name`` on the execution path (resume point
        for a frame paused at a remote element)."""
        path = list(self.get_path(head_name))
        names = [node.name for node in path]
        try:
            index = names.index(name)
        except ValueError:
            return []
        return path[index + 1:]

    # -- graph-path "local:remote" split ----------------------------------- #

    @staticmethod
    def path_local(graph_path):
        if isinstance(graph_path, str):
            local, _, _ = graph_path.partition(":")
            return local or None
        return graph_path

    @staticmethod
    def path_remote(graph_path):
        if isinstance(graph_path, str):
            _, _, remote = graph_path.partition(":")
            return remote or None
        return graph_path

    # -- parsing ----------------------------------------------------------- #

    @classmethod
    def traverse(cls, graph_definition: List[str],
                 properties_callback: Optional[Callable] = None) -> "Graph":
        """Build a Graph from S-expression strings.

        Each string contributes one head node (one entry path).  Nested lists
        are successor chains; a trailing ``(key: value)`` dict attaches edge
        properties reported via ``properties_callback(node, properties,
        predecessor)``.
        """
        graph = cls()

        def ensure(name: str) -> Node:
            if name not in graph._nodes:
                graph.add(Node(name))
            return graph._nodes[name]

        def walk(items: List, predecessor: Optional[Node]) -> Node:
            """items: [name, successor_spec...], each spec a name or list.

            A dict spec attaches edge properties to the *preceding* successor
            (or to the node itself when it directly follows the name), with
            the edge's source as predecessor — matching the reference's
            ``(b d (key: value))`` -> callback("d", {...}, "b") contract.
            """
            head = items[0]
            if not isinstance(head, str):
                raise ValueError(f"Graph node name expected, got {head!r}")
            node = ensure(head)
            if predecessor is not None:
                predecessor.add(node.name)
            last_child: Optional[Node] = None
            for spec in items[1:]:
                if isinstance(spec, dict):
                    target = last_child if last_child is not None else node
                    source = node if last_child is not None else predecessor
                    if properties_callback:
                        properties_callback(
                            target.name, spec,
                            source.name if source else None)
                    continue
                if isinstance(spec, str):
                    spec = [spec]
                last_child = walk(spec, node)
            return node

        for definition in graph_definition:
            tree = parse_tree(definition, dictionaries=True)
            if isinstance(tree, str):
                tree = [tree]
            if not tree:
                continue
            walk(tree, None)
            graph._heads[tree[0]] = None
        return graph
