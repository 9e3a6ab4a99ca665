from rfw_tpu_torch.scene.camera import Camera3D
from rfw_tpu_torch.scene.lights import extract_area_lights
from rfw_tpu_torch.scene.materials import Material, Materials, Texture
