from rfw_tpu_torch.backend.contract import Backend, RenderMode
from rfw_tpu_torch.backend.structs import (
    MeshView2D,
    MeshView3D,
    InstancesView2D,
    InstancesView3D,
    SkinView,
    TextureView,
    DeviceMaterials,
    CameraView3D,
    CameraView2D,
    INVALID_ID,
)
from rfw_tpu_torch.backend.lights import (
    AreaLightsView,
    DirectionalLightsView,
    PointLightsView,
    SpotLightsView,
)
