from rfw_tpu_torch.accel.bvh_cpu import BvhNodes, build_bvh_sah
from rfw_tpu_torch.accel.lbvh import build_lbvh_device
