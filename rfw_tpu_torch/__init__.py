"""rfw_tpu_torch — the PyTorch + CUDA port of rfw_tpu's renderer.

A second package beside `rfw_tpu` (the JAX/TPU reference, left unchanged).
It imports torch and numpy, never jax and nothing from `rfw_tpu`: the host
modules the renderer needs (scene building, BVH build, packing) are numpy
copies here, kept bit-identical to the originals. Module paths mirror
`rfw_tpu`:

  scene/, models/ (mesh3d, mesh2d,            host scene authoring (numpy):
      primitives), mathx/, utils/ (log,         meshes with their backend
      timing, collections)                      views, the 2D quad
  backend/structs.py, backend/lights.py       the views crossing the backend
                                                boundary
  backend/contract.py                         the Backend protocol (14
                                                methods), RenderMode,
                                                init_from_window_handle
  accel/bvh_cpu.py, render/pack.py,           BVH build/refit and arena
  render/lights_pack.py, render/atlas.py        packing, deformed meshes and
                                                the instance-only repack
                                                (numpy)
  render/overlay.py                           the 2D overlay rasterizer and
                                                compositor (numpy)
  convert.py                                  packed arenas -> device tensors,
                                                each part alone, the scene
                                                equality-gated
  render/torch_backend.py                     TorchBackend: the Backend
                                                contract over the path tracer
                                                (syncs, progressive film, AOV
                                                modes, host skinning/morphs,
                                                overlay)
  scenes.py                                   seeded procedural scenes (the
                                              flagship-scale and the
                                              instance-heavy one)
  render/{wavefront,disney,sampler,atlas,     the wavefront path tracer (torch)
          intersect,film,fxaa}.py               and its film: tonemap with the
                                                FXAA post-pass
  render/twophase.py                          two-phase phase A by a dense
                                              (R, I) scan of instance boxes
  ops/traverse.py + csrc/traverse.cu          K1/K2: two-level BVH traversal
                                              (closest hit, occlusion)
  ops/traverse_entries.py +                   K4: each ray's K nearest TLAS
      csrc/traverse_entries.cu                  instance entries (phase A)
  ops/traverse_items.py +                     phase B and the whole two-phase
      csrc/traverse_items.cu                    call: K3/K5 per-item BLAS
                                                walks, K6 dense items
  csrc/bvh_common.cuh                         the device code they share: the
                                              scene encoding, re-base, slab
                                              and leaf tests, the walk
  tools/ubench_{leaf,grid}.py +               U1/U2: microbenchmarks of the
      csrc/ubench_{leaf,grid}.cu                leaf test and of K1's call
                                                shape

Each kernel is hand-written CUDA for Hopper (sm_90a) beside its plain torch
version; a wrapper launches the kernel for tensors on the card and runs the
plain version for tensors on the CPU.

Importing builds nothing: the CUDA kernels compile at first use
(`ops/_build.py`).
"""

__version__ = "0.1.0"
