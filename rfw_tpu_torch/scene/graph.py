"""Node graph, animation channels, skins.

Reference: crates/rfw-scene/src/graph/mod.rs — `Node` TRS + local/combined
matrices (:100-114), recursive `traverse_children` propagating matrices into
instance handles and computing joint matrices (:540-630), `Animation`
channel sampling (:636-641), `SceneGraph` of sub-graphs synced in parallel
via rayon par_bridge (:894-926).

TPU re-architecture: a NodeGraph is *flattened to SoA arrays* — TRS
(N,3)/(N,4)/(N,3), parent indices, and a precomputed level-order schedule.
Matrix propagation is `levels` batched 4x4 matmuls instead of a pointer
chase; animation sampling is vectorized per channel; skinning matrices are
one batched inverse + two batched matmuls. The same arrays are jit-able on
device if graph evaluation ever needs to move there.

Host copy of `rfw_tpu/scene/graph.py`: the same numpy code with its imports
rewritten to `rfw_tpu_torch`, so that it computes what the original
computes, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from rfw_tpu_torch.mathx import compose_trs, quat_slerp
from rfw_tpu_torch.scene.descriptor import (
    AnimationDescriptor,
    NodeDescriptor,
    SceneDescriptor,
    SkinDescriptor,
)
from rfw_tpu_torch.scene.instances import InstanceHandle3D
from rfw_tpu_torch.utils.collections import TrackedStorage


@dataclass
class Skin:
    """Runtime skin: joint node ids + inverse binds + computed matrices
    (reference Skin, graph/mod.rs:833-851)."""

    name: str
    joint_nodes: np.ndarray  # (J,) node indices
    inverse_bind: np.ndarray  # (J,4,4)
    joint_matrices: np.ndarray  # (J,4,4) — output


class Animation:
    """Sampled animation (reference Animation + update_animation :636-641)."""

    def __init__(self, desc: AnimationDescriptor) -> None:
        self.name = desc.name
        self.channels = desc.channels
        self.duration = desc.duration

    def sample(self, t: float, graph: "NodeGraph") -> None:
        """Write sampled TRS into the graph arrays (vectorized searchsorted
        per channel)."""
        if self.duration > 0:
            t = float(t) % self.duration
        for ch in self.channels:
            times = ch.times
            k = len(times)
            if k == 0:
                continue
            node = ch.node
            cubic = ch.interpolation == "CUBICSPLINE"
            if cubic:
                # values come as (k, 3*C): in-tangent, value, out-tangent
                raw = ch.values.reshape(k, 3, -1)
                vals = raw[:, 1, :]
            else:
                vals = ch.values
            if k == 1:
                v = vals[0]
            else:
                i1 = int(np.searchsorted(times, t, side="right"))
                i1 = min(max(i1, 1), k - 1)
                i0 = i1 - 1
                t0, t1 = float(times[i0]), float(times[i1])
                if ch.interpolation == "STEP" or t1 <= t0:
                    v = vals[i0]
                elif cubic:
                    # full glTF cubic Hermite: value columns + the stored
                    # in/out tangents scaled by the keyframe interval
                    # (rotations normalize in the write-back below, per
                    # spec). The reference inherits this from l3d.
                    td = t1 - t0
                    s = (t - t0) / td
                    s2, s3 = s * s, s * s * s
                    v = ((2 * s3 - 3 * s2 + 1) * vals[i0]
                         + td * (s3 - 2 * s2 + s) * raw[i0, 2]
                         + (-2 * s3 + 3 * s2) * vals[i1]
                         + td * (s3 - s2) * raw[i1, 0])
                else:
                    a = (t - t0) / (t1 - t0)
                    if ch.path == "rotation":
                        v = quat_slerp(vals[i0], vals[i1], np.float32(a))
                    else:
                        v = vals[i0] * (1 - a) + vals[i1] * a
            if ch.path == "translation":
                graph.translation[node] = v[:3]
            elif ch.path == "rotation":
                q = v[:4]
                graph.rotation[node] = q / max(np.linalg.norm(q), 1e-12)
            elif ch.path == "scale":
                graph.scale[node] = v[:3]
            elif ch.path == "weights":
                graph.morph_weights[node] = v
            graph.trs_dirty = True


class NodeGraph:
    """One flattened sub-graph (usually one loaded asset)."""

    def __init__(self, desc: SceneDescriptor, mesh_slot_map: Dict[int, int]) -> None:
        """mesh_slot_map: descriptor-local mesh index -> Scene mesh slot."""
        n = len(desc.nodes)
        self.name = desc.name
        self.translation = np.zeros((n, 3), np.float32)
        self.rotation = np.tile(np.array([0, 0, 0, 1], np.float32), (n, 1))
        self.scale = np.ones((n, 3), np.float32)
        self.matrix_override = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        self.has_override = np.zeros(n, bool)
        self.parent = np.full(n, -1, np.int32)
        self.morph_weights: Dict[int, np.ndarray] = {}
        self.names: List[str] = []

        for i, nd in enumerate(desc.nodes):
            self.translation[i] = nd.translation
            self.rotation[i] = nd.rotation
            self.scale[i] = nd.scale
            if nd.matrix is not None:
                self.matrix_override[i] = nd.matrix
                self.has_override[i] = True
            self.names.append(nd.name)
            if getattr(nd, "weights", None):
                self.morph_weights[i] = np.asarray(nd.weights, np.float32)
            for c in nd.children:
                self.parent[c] = i

        # level-order schedule: nodes grouped by depth (roots = depth 0)
        depth = np.zeros(n, np.int32)
        for i in range(n):
            d, p = 0, self.parent[i]
            while p >= 0:
                d += 1
                p = self.parent[p]
            depth[i] = d
        self.levels: List[np.ndarray] = [
            np.nonzero(depth == d)[0].astype(np.int32)
            for d in range(int(depth.max()) + 1 if n else 0)
        ]

        self.combined = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        self.trs_dirty = True

        # mesh bindings: (node, scene mesh slot)
        self.mesh_nodes: List[Tuple[int, int]] = []
        self.node_skin: Dict[int, int] = {}
        for i, nd in enumerate(desc.nodes):
            for mid in nd.mesh_ids:
                self.mesh_nodes.append((i, mesh_slot_map[mid]))
            if nd.skin_id >= 0:
                self.node_skin[i] = nd.skin_id

        self.skins: List[Skin] = [
            Skin(
                name=s.name,
                joint_nodes=np.asarray(s.joint_nodes, np.int32),
                inverse_bind=s.inverse_bind_matrices.astype(np.float32),
                joint_matrices=np.tile(
                    np.eye(4, dtype=np.float32), (len(s.joint_nodes), 1, 1)
                ),
            )
            for s in desc.skins
        ]
        self.animations: List[Animation] = [Animation(a) for a in desc.animations]

        # instance handles: filled by Scene when the graph is instantiated
        self.instance_handles: Dict[int, List[InstanceHandle3D]] = {}
        # skin slot ids in the Scene's skin storage (parallel to self.skins)
        self.scene_skin_ids: List[int] = []
        self.root_matrix = np.eye(4, dtype=np.float32)

    @property
    def num_nodes(self) -> int:
        return self.parent.shape[0]

    def set_time(self, t: float, animation: int = 0) -> None:
        if 0 <= animation < len(self.animations):
            self.animations[animation].sample(t, self)

    def update(self) -> bool:
        """Propagate matrices level by level (batched matmuls); write
        instance matrices + joint matrices. Returns True if anything moved
        (reference traverse_children :540-630)."""
        if not self.trs_dirty:
            return False
        local = compose_trs(self.translation, self.rotation, self.scale)
        local = np.where(self.has_override[:, None, None], self.matrix_override, local)
        combined = self.combined
        for li, level in enumerate(self.levels):
            if li == 0:
                combined[level] = np.einsum(
                    "ab,nbc->nac", self.root_matrix, local[level]
                )
            else:
                combined[level] = np.einsum(
                    "nab,nbc->nac", combined[self.parent[level]], local[level]
                )

        # instances
        for node, handles in self.instance_handles.items():
            mw = self.morph_weights.get(node)
            for h in handles:
                h.set_matrix(combined[node])
                if mw is not None:
                    h.set_morph_weights(mw)

        # skins: joint = inv(mesh_node_combined) @ joint_combined @ ibm —
        # we use the convention that skinned vertices are expressed in the
        # mesh node's frame (glTF), so the instance matrix stays the mesh
        # node's combined transform.
        for node, skin_id in self.node_skin.items():
            if skin_id >= len(self.skins):
                continue
            skin = self.skins[skin_id]
            inv_node = np.linalg.inv(combined[node]).astype(np.float32)
            jm = np.einsum(
                "ab,nbc,ncd->nad", inv_node, combined[skin.joint_nodes], skin.inverse_bind
            )
            skin.joint_matrices = jm.astype(np.float32)

        self.trs_dirty = False
        return True


class GraphHandle:
    """Owned reference to a sub-graph (reference GraphHandle)."""

    def __init__(self, graphs: "SceneGraph", idx: int) -> None:
        self._graphs = graphs
        self.index = idx

    @property
    def graph(self) -> NodeGraph:
        return self._graphs.storage[self.index]

    def set_time(self, t: float, animation: int = 0) -> None:
        self.graph.set_time(t, animation)

    def set_root_matrix(self, m: np.ndarray) -> None:
        g = self.graph
        g.root_matrix = np.asarray(m, np.float32)
        g.trs_dirty = True


class SceneGraph:
    """Storage of sub-graphs (reference SceneGraph :894-926). The rayon
    par_bridge becomes a plain loop — each graph update is internally
    vectorized, so host threads add nothing."""

    def __init__(self) -> None:
        self.storage: TrackedStorage[NodeGraph] = TrackedStorage()

    def add_graph(self, g: NodeGraph) -> GraphHandle:
        idx = self.storage.push(g)
        return GraphHandle(self, idx)

    def remove_graph(self, handle: GraphHandle) -> None:
        self.storage.erase(handle.index)

    def set_animations_time(self, t: float) -> None:
        for _, g in self.storage:
            g.set_time(t)

    def synchronize(self) -> bool:
        any_moved = False
        for _, g in self.storage:
            any_moved |= g.update()
        return any_moved
