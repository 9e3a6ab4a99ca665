"""Area-light extraction (host copy of `extract_area_lights` from
`rfw_tpu/scene/lights.py`): one area light per emissive triangle per
instance, extracted as a vectorized gather, returned as an
`AreaLightsView`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from rfw_tpu_torch.backend.lights import AreaLightsView


def extract_area_lights(
    emissive_mask_per_tri: np.ndarray,  # (T,) bool over a mesh's triangles
    radiance_per_tri: np.ndarray,  # (T,3) material emission
    tri_verts: np.ndarray,  # (T,3,3) object-space corners
    instance_matrices: np.ndarray,  # (I,4,4)
    mesh_id: int,
    inst_ids: np.ndarray,  # (I,) global instance ids
) -> Tuple[AreaLightsView, np.ndarray]:
    """Vectorized area-light extraction for one mesh (reference
    update_lights, rfw-scene/src/lib.rs:575-648).

    Returns (lights, light_id_per_tri) where light_id_per_tri is the
    *per-mesh-triangle* id of the light for the FIRST instance (-1 for
    non-emissive); the packed per-instance lights enumerate instances in
    order so light_id for instance k of triangle t = base_of_k + rank(t).
    """
    sel = np.nonzero(emissive_mask_per_tri)[0]
    n_e = len(sel)
    n_i = instance_matrices.shape[0]
    if n_e == 0 or n_i == 0:
        return AreaLightsView.empty(), np.full(len(emissive_mask_per_tri), -1, np.int32)

    v = tri_verts[sel]  # (E,3,3)
    # world transform per instance: (I,1,3,3) x (E,3,3)
    rot = instance_matrices[:, None, :3, :3]  # (I,1,3,3)
    trans = instance_matrices[:, None, None, :3, 3]  # (I,1,1,3)
    wv = np.einsum("ieab,ekb->ieka", np.broadcast_to(rot, (n_i, n_e, 3, 3)), v) + trans
    wv = wv.reshape(n_i * n_e, 3, 3).astype(np.float32)

    e1 = wv[:, 1] - wv[:, 0]
    e2 = wv[:, 2] - wv[:, 0]
    cr = np.cross(e1, e2)
    area = 0.5 * np.linalg.norm(cr, axis=-1)
    nrm = cr / np.maximum(np.linalg.norm(cr, axis=-1, keepdims=True), 1e-20)
    center = wv.mean(axis=1)
    radiance = np.tile(radiance_per_tri[sel], (n_i, 1)).astype(np.float32)

    lights = AreaLightsView(
        position=center.astype(np.float32),
        normal=nrm.astype(np.float32),
        energy=(radiance * area[:, None] * np.pi).astype(np.float32),
        radiance=radiance,
        area=area.astype(np.float32),
        v0=wv[:, 0], v1=wv[:, 1], v2=wv[:, 2],
        inst_id=np.repeat(inst_ids.astype(np.int32), n_e),
        mesh_id=np.full(n_i * n_e, mesh_id, np.int32),
        tri_id=np.tile(sel.astype(np.int32), n_i),
        changed=np.ones(n_i * n_e, bool),
    )
    light_id = np.full(len(emissive_mask_per_tri), -1, np.int32)
    light_id[sel] = np.arange(n_e, dtype=np.int32)
    return lights, light_id
