"""Loader output IR: descriptors consumed by Scene/NodeGraph.

The reference delegates to the external `l3d` crate which returns
MeshDescriptor/SceneDescriptor/SkinDescriptor/AnimationDescriptor trees
(re-exported at crates/rfw-scene/src/lib.rs:22-25, consumed by
loaders/gltf.rs:26-130 and Mesh3D::from at objects_3d/mod.rs:673-895).
The rebuild defines its own equivalents; loaders fill these and
`Scene.add_3d` instantiates them.

Host copy of `rfw_tpu/scene/descriptor.py`: the same numpy code with its imports
rewritten to `rfw_tpu_torch`, so that it computes what the original
computes, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from rfw_tpu_torch.models.mesh3d import Mesh3D


@dataclass
class SkinDescriptor:
    name: str
    joint_nodes: List[int]  # node indices (within the descriptor node list)
    inverse_bind_matrices: np.ndarray  # (J,4,4) f32


@dataclass
class AnimChannelDescriptor:
    """One sampler->target binding (glTF animation channel)."""

    node: int  # target node index
    path: str  # "translation" | "rotation" | "scale" | "weights"
    times: np.ndarray  # (K,) f32 keyframe times
    values: np.ndarray  # (K,C) f32 — C=3 T/S, 4 R (quat xyzw), W weights
    interpolation: str = "LINEAR"  # LINEAR | STEP | CUBICSPLINE


@dataclass
class AnimationDescriptor:
    name: str
    channels: List[AnimChannelDescriptor]

    @property
    def duration(self) -> float:
        return max((float(c.times[-1]) for c in self.channels if len(c.times)), default=0.0)


@dataclass
class NodeDescriptor:
    """TRS node (reference l3d NodeDescriptor / rfw Node, graph/mod.rs:100-114)."""

    name: str = ""
    translation: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    rotation: np.ndarray = field(default_factory=lambda: np.array([0, 0, 0, 1], np.float32))
    scale: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    matrix: Optional[np.ndarray] = None  # explicit local matrix overrides TRS
    mesh_ids: List[int] = field(default_factory=list)  # indices into SceneDescriptor.meshes
    skin_id: int = -1  # index into SceneDescriptor.skins
    weights: List[float] = field(default_factory=list)  # morph-target weights
    children: List[int] = field(default_factory=list)


@dataclass
class SceneDescriptor:
    """A parsed asset: meshes + node hierarchy + skins + animations.

    `meshes` are object-space `Mesh3D` with material ids already remapped
    into the target `Materials` store by the loader.
    """

    name: str = ""
    meshes: List[Mesh3D] = field(default_factory=list)
    nodes: List[NodeDescriptor] = field(default_factory=list)
    roots: List[int] = field(default_factory=list)
    skins: List[SkinDescriptor] = field(default_factory=list)
    animations: List[AnimationDescriptor] = field(default_factory=list)


@dataclass
class MeshDescriptor:
    """Single-object load result (reference LoadResult::Object)."""

    mesh: Mesh3D
    name: str = ""


LoadResult = object  # MeshDescriptor | SceneDescriptor (duck-typed)
