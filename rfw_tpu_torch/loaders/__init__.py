"""Asset loaders (reference crates/rfw-scene/src/loaders/).

Each loader implements `load(path, materials) -> MeshDescriptor | SceneDescriptor`
against the target Materials store (texture/material ids pre-remapped).
Dispatch by extension lives in Scene.load (reference lib.rs:271-300).

Host copy of `rfw_tpu/loaders/__init__.py`: the same numpy code with its imports
rewritten to `rfw_tpu_torch`, so that it computes what the original
computes, bit for bit.
"""

from rfw_tpu_torch.loaders.obj import ObjLoader
from rfw_tpu_torch.loaders.gltf import GltfLoader

LOADERS = {
    ".obj": ObjLoader(),
    ".gltf": GltfLoader(),
    ".glb": GltfLoader(),
}
