"""rfw_tpu_torch — the PyTorch + CUDA port of rfw_tpu's renderer.

A second package beside `rfw_tpu` (the JAX/TPU reference, left unchanged).
It imports torch and numpy, never jax and nothing from `rfw_tpu`: the host
modules the renderer needs (scene building, BVH build, packing) are numpy
copies here, kept bit-identical to the originals. Module paths mirror
`rfw_tpu`:

  scene/, models/, mathx/, backend/, utils/   host scene authoring (numpy)
  accel/bvh_cpu.py, render/pack.py,           BVH build and arena packing
  render/lights_pack.py, render/atlas.py        (numpy)
  convert.py                                  packed arenas -> device tensors
  render/{wavefront,disney,sampler,atlas,     the wavefront path tracer (torch)
          intersect,film}.py
  ops/traverse.py + csrc/traverse.cu          two-level BVH traversal: the
                                              hand-written CUDA kernel for
                                              Hopper and its plain torch walk

Importing builds nothing: the CUDA kernels compile at first use
(`ops/_build.py`).
"""

__version__ = "0.1.0"
