from rfw_tpu_torch.ops.traverse import (
    PallasScene,
    pallas_closest_hit,
    pallas_occluded,
    prepare_pallas_scene,
)
from rfw_tpu_torch.ops.traverse_entries import pallas_tlas_entries
from rfw_tpu_torch.ops.traverse_items import pallas_twophase_closest_hit
