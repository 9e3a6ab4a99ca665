"""Four-process gloo run of `rfw_tpu_torch.parallel` on the CPU.

Four worker processes, configured through RFW_COORDINATOR /
RFW_NUM_PROCESSES / RFW_PROCESS_ID as `rfw_tpu`'s launcher pattern has it,
import only `rfw_tpu_torch` (jax, rfw_tpu and PIL blocked, as in
`test_torch_import.py`). The parent packs the 32x32 scene of
`test_torch_wavefront.py` with the port's host copies, writes it to
tmp_path and computes the references with plain `render_sample` calls.
The workers:
  * `broadcast_scene` the packed TraceScene from rank 0 against zero
    skeletons on ranks 1-3;
  * `render_sample_sharded` on a (4,) film mesh (random sampler): each
    rank's local shard holds W*H/4 rows, and the gathered frame equals the
    parent's four `row0` strips under the same key, bit for bit;
  * `render_sharded_2d` on a (2, 2) mesh, 4 samples, Sobol: the
    sequential Sobol mean within rtol 1e-5 / atol 1e-6 (the sum's order
    differs);
  * `render_spp_sharded`, 4 samples, random: the sequential mean of
    `threefry.split(key, 4)` at the same tolerance.
Each writes its results to tmp_path; the parent asserts.
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_scene

W = H = 32
SPP = 4
KEY = 11

_WORKER = r"""
import importlib.abc, os, pickle, sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "rfw_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, _Block())
sys.modules["PIL"] = None

import numpy as np
import torch
import torch.distributed as dist

from rfw_tpu_torch.parallel import (
    broadcast_scene, global_film_mesh, init_distributed, render_sample_sharded,
)
from rfw_tpu_torch.parallel.mesh import mesh_2d, render_sharded_2d, render_spp_sharded
from rfw_tpu_torch.render import threefry
from rfw_tpu_torch.render.wavefront import RenderConfig

out_dir = sys.argv[1]
assert init_distributed(device="cpu")
rank = dist.get_rank()
assert dist.get_world_size() == 4 and dist.get_backend() == "gloo"
with open(os.path.join(out_dir, "scene.pkl"), "rb") as f:
    d = pickle.load(f)
sc = d["scene"]
if rank != 0:
    sc = type(sc)(*[np.zeros_like(x) for x in sc])
sc = broadcast_scene(sc)
res = {"scene": {k: v.numpy() for k, v in sc._asdict().items()}}

W, H, key = d["W"], d["H"], threefry.PRNGKey(d["key"])
view = torch.from_numpy(d["view"])
args = (sc, d["mats"], d["atlas"], d["lights"], view, key, W, H)
film = global_film_mesh(device="cpu")
r = render_sample_sharded(film, *args, RenderConfig(**d["kw"], sampler="random"))
res["local_rows"] = r.radiance.to_local().shape[0]
res["strips"] = r.radiance.full_tensor().numpy()
res["mean_2d"] = render_sharded_2d(mesh_2d(2, 2, device="cpu"), *args, d["spp"],
                                   RenderConfig(**d["kw"], sampler="sobol")).full_tensor().numpy()
res["mean_spp"] = render_spp_sharded(global_film_mesh("spp", device="cpu"), *args, d["spp"],
                                     RenderConfig(**d["kw"], sampler="random")).full_tensor().numpy()
with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(res, f)
dist.destroy_process_group()
print(f"WORKER {rank} OK", flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_four_process_gloo(tmp_path):
    from rfw_tpu_torch.convert import from_numpy_scene
    from rfw_tpu_torch.render import threefry
    from rfw_tpu_torch.render import wavefront as tw

    sc, mats, lights, atlas, camera = _torch_scene.build("rfw_tpu_torch", seed=1)
    view = camera.get_view(W, H).as_array()
    kw = dict(max_bounces=1, clamp=20.0, sky_intensity=0.35, two_phase="off", aovs=False,
              tex_mask=tw.tex_kinds_mask(mats.tex), mat_features=tw.mat_feature_mask(mats),
              has_area_lights=True)
    with open(tmp_path / "scene.pkl", "wb") as f:
        pickle.dump(dict(scene=sc, mats=mats, lights=lights, atlas=atlas, view=view, kw=kw,
                         W=W, H=H, key=KEY, spp=SPP), f)

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env_base = dict(os.environ, OMP_NUM_THREADS="1",
                    PYTHONPATH=os.pathsep.join([repo, os.environ.get("PYTHONPATH", "")]),
                    RFW_COORDINATOR=f"127.0.0.1:{_free_port()}", RFW_NUM_PROCESSES="4")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(tmp_path)],
                              env=dict(env_base, RFW_PROCESS_ID=str(r)), cwd=str(tmp_path),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(4)]

    # the references, while the workers run
    s, m, li, a = from_numpy_scene(sc, mats, lights, atlas, device="cpu")
    v = torch.from_numpy(view)
    key = threefry.PRNGKey(KEY)
    rnd, sob = tw.RenderConfig(**kw, sampler="random"), tw.RenderConfig(**kw, sampler="sobol")
    strips = np.concatenate([
        tw.render_sample(s, m, a, li, v, W, H // 4, rnd, key=key, row0=r * H // 4).radiance.numpy()
        for r in range(4)])
    keys = threefry.split(key, SPP)
    mean_sobol = sum(tw.render_sample(s, m, a, li, v, W, H, sob, sample_index=i, key=k).radiance
                     for i, k in enumerate(keys)).numpy() / SPP
    mean_random = sum(tw.render_sample(s, m, a, li, v, W, H, rnd, key=k).radiance
                      for k in keys).numpy() / SPP

    outs = []
    for r, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"worker {r} timed out")
        outs.append((p.returncode, out, err))
    for r, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"worker {r} failed:\n{err[-3000:]}"
        assert f"WORKER {r} OK" in out

    for r in range(4):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            res = pickle.load(f)
        for name in sc._fields:
            np.testing.assert_array_equal(res["scene"][name], s._asdict()[name].numpy(),
                                          err_msg=name)
        assert res["local_rows"] == W * H // 4
        np.testing.assert_array_equal(res["strips"], strips)
        np.testing.assert_allclose(res["mean_2d"], mean_sobol, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res["mean_spp"], mean_random, rtol=1e-5, atol=1e-6)
