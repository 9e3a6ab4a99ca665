from rfw_tpu_torch.backend.structs import CameraView3D, DeviceMaterials
from rfw_tpu_torch.backend.lights import (
    AreaLightsView,
    DirectionalLightsView,
    PointLightsView,
    SpotLightsView,
)
