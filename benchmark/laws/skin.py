"""Law `skin` (rfw-rs examples/animated's skinned characters, each under its
own skin): the configuration's characters (`configs/heavy10k_skinned.py`'s
`SkinnedSpec`) play one clip, character k offset by k * offset_s seconds,
at t = frame * dt on a simulated clock. Joint j turns about z by
amplitude_rad * sin(2 pi t / period_s + phase_per_joint * j) at its pivot,
composed down the chain. No instance moves.

Frame 0 binds the skins: it re-sends the characters' mesh with its joints
and weights, its instances with skin ids 0..n-1, and every skin's pose,
so the one full rebuild falls inside the warm-up. Every later frame sends
the skins' poses alone. The scene changes before every frame, so each
frame's film holds its own sample 0 alone. The reference renders each
character as a mesh slot of its own, posed by `benchmark/skinning.py`.
"""

import dataclasses

import numpy as np

from benchmark import scene, skinning


def pose(spec, params, frame: int, k: int) -> np.ndarray:
    """(J,4,4) f32 joint matrices of character k at `frame`."""
    t = frame * params["dt"] - k * params["offset_s"]
    m = np.eye(4)
    out = []
    for j, y in enumerate(spec.pivots.astype(np.float64)):
        th = params["amplitude_rad"] * np.sin(2 * np.pi * t / params["period_s"]
                                              + params["phase_per_joint"] * j)
        turn = np.eye(4)
        turn[:2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
        turn[:2, 3] = [y * np.sin(th), y - y * np.cos(th)]  # about (0, y, 0)
        m = m @ turn
        out.append(m)
    return np.stack(out).astype(np.float32)


def mesh_view(spec):
    """The characters' rest pose as the Backend contract's MeshView3D, with
    its joints and weights."""
    from rfw_tpu_torch.backend.structs import MeshView3D

    m = spec.meshes[spec.skin_slot]
    return MeshView3D(
        positions=m.positions, normals=m.normals, uvs=m.uvs, tangents=m.tangents,
        indices=m.indices, tri_material=m.tri_material, tri_light=m.tri_light,
        ranges=np.array([[0, m.indices.shape[0], int(m.tri_material[0])]], np.int32),
        joints=spec.joints, weights=spec.weights, aabb_min=m.aabb_min,
        aabb_max=m.aabb_max, name=m.name).validate()


def apply(backend, spec, params, frame):
    from rfw_tpu_torch.backend.structs import SkinView

    slot = spec.skin_slot
    n = spec.instances[slot].shape[0]
    if frame == 0:
        backend.set_3d_meshes([(slot, mesh_view(spec))])
        view = scene.instances_view(spec, slot, spec.instances[slot])
        view.skin_ids = np.arange(n, dtype=np.int32)
        backend.set_3d_instances([(slot, view)])
    backend.set_skins([(k, SkinView(joint_matrices=pose(spec, params, frame, k)))
                       for k in range(n)])


def scene_at(spec, params, frame):
    """The spec with character k as a mesh slot of its own (the first at
    `skin_slot`, the others appended), posed at `frame`."""
    slot = spec.skin_slot
    rest = spec.meshes[slot]
    meshes, instances = list(spec.meshes), list(spec.instances)
    for k in range(spec.instances[slot].shape[0]):
        p, n, t = skinning.skin(rest.positions, rest.normals, rest.tangents, spec.joints,
                                spec.weights, pose(spec, params, frame, k))
        posed = dataclasses.replace(rest, positions=p, normals=n, tangents=t)
        mats = spec.instances[slot][k:k + 1]
        if k == 0:
            meshes[slot], instances[slot] = posed, mats
        else:
            meshes.append(posed)
            instances.append(mats)
    return dataclasses.replace(spec, meshes=meshes, instances=instances)


def film_start(params, frame):
    return frame
