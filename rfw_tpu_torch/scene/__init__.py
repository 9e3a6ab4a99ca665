from rfw_tpu_torch.scene.materials import Material, Materials, Texture
from rfw_tpu_torch.scene.descriptor import (
    MeshDescriptor,
    NodeDescriptor,
    SceneDescriptor,
    SkinDescriptor,
)
from rfw_tpu_torch.scene.camera import Camera2D, Camera3D, Frustum, FrustumResult
from rfw_tpu_torch.scene.lights import DirectionalLight, Lights, PointLight, SpotLight
from rfw_tpu_torch.scene.instances import (
    InstanceHandle2D,
    InstanceHandle3D,
    InstanceList2D,
    InstanceList3D,
)
from rfw_tpu_torch.scene.graph import Animation, GraphHandle, NodeGraph, SceneGraph, Skin
from rfw_tpu_torch.scene.scene import Scene, SceneError
