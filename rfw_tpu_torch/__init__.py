"""rfw_tpu_torch — the PyTorch + CUDA port of rfw_tpu's renderer.

A second package beside `rfw_tpu` (the JAX/TPU reference, left unchanged).
It imports torch and numpy, never jax and nothing from `rfw_tpu`: the host
modules (the app and scene layer, the loaders, BVH build, packing, the
numpy oracle) are numpy copies here, kept bit-identical to the originals.
Module paths mirror `rfw_tpu`, and so do the names exported here, so a
program written against `rfw_tpu` runs on the port with `rfw_tpu_torch` in
its imports and `TorchBackend` in place of `TpuBackend`:

  app/ (instance, window, ecs, events,        the app runtime: Instance with
      input, timer)                             its frame loop and
                                                run_windowed, the window
                                                providers (HeadlessWindow,
                                                BrowserWindow), the winit
                                                mirror and InputBundle
  font/plugin.py                              text -> 2D mesh plugin (PIL,
                                                imported when a glyph is
                                                drawn)
  scene/ (scene, graph, instances,            host scene authoring (numpy):
      descriptor, materials, camera,            Scene and its synchronize
      lights, serialize), loaders/              delta pump, the node graph
      (obj, gltf), models/ (mesh3d,             with skins and animations,
      mesh2d, primitives), mathx/,              instance pools, materials
      utils/ (collections, track, task,         and textures, cameras,
      physics, log, timing)                     lights, snapshots, the OBJ
                                                and glTF loaders, meshes,
                                                the sphere physics world
  utils/image.py, utils/png.py                PNG and JPEG texture decoding
                                                and Pillow's resize, bit
                                                for bit without Pillow;
                                                the PNG frame writer
  render/cpu_reference.py                     CpuReferenceBackend: the numpy
                                                pixel oracle with the same
                                                14-method contract (CPU
                                                only, independent of the
                                                code under test)
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
                                                modes, host and device
                                                skinning/morphs, device
                                                instance motion, overlay)
  render/refit_device.py                      the device dynamics: LBS,
                                                morphs and the BVH refit of
                                                deformed units
                                                (apply_dynamic), the TLAS
                                                refit of moving instances
                                                (instance_motion_update), and
                                                their host-built plans
  accel/tlas_device.py, accel/lbvh.py         the device 8-ary TLAS build
                                                over Morton-sorted instances;
                                                Morton codes
  scenes.py                                   seeded procedural scenes (the
                                              flagship-scale and the
                                              instance-heavy one)
  render/{wavefront,disney,sampler,atlas,     the wavefront path tracer (torch)
          intersect,film,fxaa}.py               and its film: tonemap with the
                                                FXAA post-pass
  render/threefry.py                          jax.random's threefry (keys,
                                                split, fold_in, uniform) bit
                                                for bit: the random sampler
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

import os as _os

from rfw_tpu_torch.utils import log as _log

if "RFW_LOG" in _os.environ:
    _log.init()

from rfw_tpu_torch.utils.collections import FlaggedStorage, TrackedStorage
from rfw_tpu_torch.utils.timing import Timer, Averager
from rfw_tpu_torch.app.ecs import Scheduler, Stage
from rfw_tpu_torch.app.events import Events
from rfw_tpu_torch.app.input import Input
from rfw_tpu_torch.app.timer import GameTimer
from rfw_tpu_torch.app.instance import Instance, Plugin, RenderSystem
from rfw_tpu_torch.app.window import (
    BrowserWindow,
    DeviceEvent,
    DeviceEvents,
    ElementState,
    HeadlessWindow,
    InputBundle,
    KeyState,
    MouseButton,
    MouseState,
    ResizeEvent,
    ResizeEvents,
    VirtualKeyCode,
    WindowData,
    WindowEvent,
    WindowEvents,
    WindowHandle,
)
from rfw_tpu_torch.scene.materials import Material, Materials, Texture
from rfw_tpu_torch.scene.descriptor import (
    MeshDescriptor,
    NodeDescriptor,
    SceneDescriptor,
    SkinDescriptor,
)
from rfw_tpu_torch.scene.camera import Camera2D, Camera3D, Frustum, FrustumResult
from rfw_tpu_torch.scene.lights import DirectionalLight, Lights, PointLight, SpotLight
from rfw_tpu_torch.scene.instances import (
    InstanceHandle2D,
    InstanceHandle3D,
    InstanceList2D,
    InstanceList3D,
)
from rfw_tpu_torch.scene.graph import Animation, GraphHandle, NodeGraph, SceneGraph, Skin
from rfw_tpu_torch.scene.scene import Scene, SceneError
