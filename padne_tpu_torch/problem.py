"""Problem intermediate representation.

The pure-data contract between the loader front-end and the solver:
copper layers (as polygon geometry) plus lumped-element networks attached
to points on those layers.  Mirrors the semantics of the reference IR
(padne/problem.py:11-181) — NodeID identity hashing, Network node
derivation, element terminals / is_source / extra_variable_count — but is
built on padne_tpu_torch.geom instead of shapely.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import geom


@dataclass(frozen=True)
class Layer:
    """A single copper layer: a MultiPolygon plus its sheet conductance.

    conductance [S] = conductivity [S/mm] * thickness [mm].
    """

    shape: geom.MultiPolygon
    name: str
    conductance: float

    # Cached tuple of the individual polygons.
    geoms: tuple[geom.Polygon, ...] = field(init=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "geoms", tuple(self.shape.geoms))


@dataclass(frozen=True, eq=False)
class NodeID:
    """Opaque identity-hashed token naming a circuit node."""


@dataclass(frozen=True)
class Connection:
    """Binds a network node to a point on a copper layer."""

    layer: Layer
    point: geom.Point
    node_id: NodeID = field(default_factory=NodeID)


@dataclass(frozen=True)
class BaseLumped:
    """Base class for lumped circuit elements."""

    def __post_init__(self):
        assert self.terminals, "Lumped elements must have terminals"

    @property
    def terminals(self) -> list[NodeID]:
        raise NotImplementedError

    @property
    def is_source(self) -> bool:
        return False

    @property
    def extra_variable_count(self) -> int:
        return 0


@dataclass(frozen=True)
class Network:
    """A set of connections plus the lumped elements wiring them together.

    ``nodes`` maps every NodeID appearing in element terminals to a local
    index; ``has_source`` is true when any element is a source.  A Network
    may have connections with no elements (mesh-seed probes).
    """

    connections: list[Connection]
    elements: list[BaseLumped]
    nodes: dict[NodeID, int] = field(init=False)
    has_source: bool = field(init=False)

    def __post_init__(self):
        node_set: set[NodeID] = set()
        for element in self.elements:
            for terminal in element.terminals:
                if not isinstance(terminal, NodeID):
                    raise TypeError("Terminal must be a NodeID")
                node_set.add(terminal)
        object.__setattr__(
            self, "nodes", {key: i for i, key in enumerate(node_set)}
        )
        object.__setattr__(
            self, "has_source", any(e.is_source for e in self.elements)
        )


@dataclass(frozen=True)
class Resistor(BaseLumped):
    a: NodeID
    b: NodeID
    resistance: float

    def __post_init__(self):
        super().__post_init__()
        if self.resistance <= 0:
            raise ValueError(f"Resistance must be positive, got {self.resistance}")

    @property
    def terminals(self) -> list[NodeID]:
        return [self.a, self.b]


@dataclass(frozen=True)
class VoltageSource(BaseLumped):
    p: NodeID
    n: NodeID
    voltage: float

    @property
    def terminals(self) -> list[NodeID]:
        return [self.p, self.n]

    @property
    def is_source(self) -> bool:
        return True

    @property
    def extra_variable_count(self) -> int:
        return 1


@dataclass(frozen=True)
class CurrentSource(BaseLumped):
    f: NodeID
    t: NodeID
    current: float

    @property
    def terminals(self) -> list[NodeID]:
        return [self.f, self.t]

    @property
    def is_source(self) -> bool:
        return True


@dataclass(frozen=True)
class VoltageRegulator(BaseLumped):
    """Ideal regulator: voltage source (v_p, v_n) whose output current is
    mirrored, scaled by ``gain``, into the sense pair (s_f, s_t)."""

    v_p: NodeID
    v_n: NodeID
    s_f: NodeID
    s_t: NodeID
    voltage: float
    gain: float

    @property
    def terminals(self) -> list[NodeID]:
        return [self.v_p, self.v_n, self.s_f, self.s_t]

    @property
    def is_source(self) -> bool:
        return True

    @property
    def extra_variable_count(self) -> int:
        return 1


@dataclass(frozen=True)
class Problem:
    layers: list[Layer]
    networks: list[Network]
    project_name: str | None = None
