"""The `heavy10k_skinned` configuration's small sizes for CPU tests
(`_tiny.PATCH` holds none for it): heavy10k's tiny field and two
characters of 21 x 12 vertices, at their own size (scale 1). Imports
nothing of `benchmark.control`, which rewrites `sys.path[0]` on import."""

from ._tiny import PATCH

SMALL = dict(PATCH["heavy10k"], characters=dict(
    count=2, rings=20, segments=12, radius=0.6, height=6.0, joints=24, influences=4,
    scale=1.0, along=0.6, apart=3.0, yaw_deg=45.0,
    material=dict(name="character", color=[0.85, 0.55, 0.35, 1.0], roughness=0.45)))
#: the vertices both characters skin a frame
VERTICES = 2 * 21 * 12
