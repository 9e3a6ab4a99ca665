from rfw_tpu_torch.models.mesh3d import Mesh3D, build_mesh3d
from rfw_tpu_torch.models.primitives import cube, plane, quad3d, sphere
