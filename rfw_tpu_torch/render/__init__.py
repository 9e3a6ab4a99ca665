from rfw_tpu_torch.render.pack import TraceScene, pack_trace_scene
from rfw_tpu_torch.render.intersect import bvh_closest_hit, bvh_occluded, brute_force_closest
