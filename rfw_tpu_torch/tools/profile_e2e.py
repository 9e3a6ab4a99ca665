"""Time per stage of the integrator on the bench scene.

Counterpart of the reference's `tools/profile_e2e.py`: each stage of
`render_sample` runs alone, in the component form the integrator runs,
on real data (the bench scene's coherent primaries, their hits by K1),
and is timed by CUDA events (the least of `--reps` calls after a warm-up);
the whole sample, which reads its live counts back to the host, by the
host clock around synchronized calls. The stages' sum is not the sample's
time (the sample shades only its live lanes), but their order says what
to attack. Stages:

  render_sample(1b)  one whole sample (1 bounce, Sobol, clamp 100,
                     two_phase="on": the reference tool's two-phase
                     bounce, which "auto" takes only on the CPU)
  trace_primary      K1 on the coherent primaries
  trace_occluded     K2 from the first hits toward a fixed direction
  sort_pair          the bounce sort (the key RFW_SORT_KEY selects,
                     stable sort, gather of 8 columns) and the unsort by
                     ray id
  shading_basis      `_shading_basis_c` (vertex attribute gathers)
  material+atlas     the basis and `_fetch_material_c`
  light+disney       the basis, the material, `_sample_light_c` and
                     Disney eval, pdf and sample
  camera+sobol2      two Sobol slots and `camera_rays_c`
  sobol_slot3        one 3-wide Sobol slot
  v0_sort16          vertex 0's compaction sort (16 columns)
  out_sort4          the output sort by pixel id (4 columns)

    python -m rfw_tpu_torch.tools.profile_e2e [--width 960 --height 544 --reps 3]
        [--gltf PATH] [--device cuda|cpu]

prints one JSON line: ms per stage, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from rfw_tpu_torch.tools import (
    call_ms, card_line, device_name, device_of, primary_rays, synced_ms,
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=544)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--gltf", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from rfw_tpu_torch.bench import build_scene
    from rfw_tpu_torch.ops.traverse import closest_hit, occluded, prepare_scene
    from rfw_tpu_torch.render import disney, threefry
    from rfw_tpu_torch.render.disney import v3_split
    from rfw_tpu_torch.render.sampler import sample_slot
    from rfw_tpu_torch.render.wavefront import (
        RenderConfig, _fetch_material_c, _sample_light_c, _shading_basis_c, camera_rays_c,
        render_sample, sort_key, tex_kinds_mask,
    )

    dev = device_of(args.device)
    W, H = args.width, args.height
    R = W * H
    scene, mats, atlas, lights, view = build_scene(W, H, gltf=args.gltf, device=dev)
    ps = prepare_scene(scene)
    card = card_line(dev)
    key = threefry.PRNGKey(3)
    o, d, pix = primary_rays(view, W, H)
    hit = closest_hit(ps, o, d)
    dc = v3_split(d)
    results = {}

    def timed(name, fn, clock=call_ms):
        results[name] = min(clock(fn, args.reps, dev))
        print(f"[{card}] {name:28s} {results[name]:9.4f} ms", file=sys.stderr)

    # one whole sample, the reference tool's config and route
    cfg = RenderConfig(max_bounces=1, clamp=100.0, sampler="sobol", two_phase="on",
                       tex_mask=tex_kinds_mask(mats.tex),
                       has_area_lights=bool(lights.n_area[0] > 0))
    timed("render_sample(1b)", lambda: render_sample(
        scene, mats, atlas, lights, view, W, H, cfg, sample_index=1), synced_ms)
    timed("trace_primary", lambda: closest_hit(ps, o, d))

    pos = o + torch.where(hit.prim >= 0, hit.t, 1.0)[:, None] * d
    wi = torch.tensor([0.3, 0.9, 0.3], device=dev)
    wi = (wi / torch.linalg.norm(wi)).expand(R, 3).contiguous()
    shadow_o = (pos + wi * 1e-3).contiguous()
    timed("trace_occluded", lambda: occluded(ps, shadow_o, wi, 10.0))

    lim = torch.ones(R, device=dev)
    ids = torch.arange(R, device=dev, dtype=torch.float32)

    hint = torch.where(hit.prim >= 0, hit.inst, -1)  # the "instance" key's

    def sort_pair():
        perm = torch.sort(sort_key(v3_split(pos), dc, scene.tlas_min[0], scene.tlas_max[0],
                                   hint=hint), stable=True).indices
        cols = torch.cat([pos, d, lim[:, None], ids[:, None]], dim=1)[perm]
        back = torch.sort(cols[:, 7], stable=True).indices
        return cols[back, :6]

    timed("sort_pair", sort_pair)
    timed("shading_basis", lambda: _shading_basis_c(scene, hit, dc))

    zero = torch.zeros(R, device=dev)

    def material():
        basis = _shading_basis_c(scene, hit, dc)
        return basis, _fetch_material_c(mats, atlas, basis["mat_id"], basis["uv"], zero,
                                        basis["entering"], cfg.tex_mask)

    timed("material+atlas", lambda: material()[1][0].base_c)

    def shade():
        basis, (params, *_rest) = material()
        ns = basis["ns"]
        u = threefry.uniform(key, (R, 3), device=dev)
        wi_l, *_ = _sample_light_c(lights, (zero, zero, zero), u[:, 0], u[:, 1], u[:, 2], ns)
        wo = disney.to_local_c(basis["tan"], basis["bitan"], ns, (-dc[0], -dc[1], -dc[2]))
        wi_local = disney.to_local_c(basis["tan"], basis["bitan"], ns, wi_l)
        f = disney.disney_eval_c(params, wo, wi_local)
        pdf = disney.disney_pdf_c(params, wo, wi_local)
        _, f_b, pdf_b, _ = disney.disney_sample_c(params, wo, u[:, 0], u[:, 1], u[:, 2])
        return f[0] + f_b[0] + pdf + pdf_b, f[1] + f_b[1], f[2] + f_b[2]

    timed("light+disney", shade)

    if pix is None:
        px = torch.arange(R, dtype=torch.int32, device=dev) % W
        py = torch.arange(R, dtype=torch.int32, device=dev) // W
    else:
        px, py = pix
    pid = (py * W + px).to(torch.int32)
    timed("camera+sobol2", lambda: camera_rays_c(
        view, W, H, (px, py), jitter=(sample_slot(1, pid, 0, 2), sample_slot(1, pid, 1, 2))))
    timed("sobol_slot3", lambda: sample_slot(1, pid, 2, 3))

    key16 = torch.where(hit.prim >= 0, hit.prim >> 4, 1 << 30)
    f1 = torch.ones(R, device=dev)
    cols16 = [hit.t, hit.prim, hit.inst, hit.u, hit.v, f1, f1, f1, o[:, 0], o[:, 1], o[:, 2],
              d[:, 0], d[:, 1], d[:, 2], pid]

    def v0_sort16():
        perm = torch.sort(key16, stable=True).indices
        return [c[perm] for c in cols16]

    timed("v0_sort16", v0_sort16)

    def out_sort4():
        perm = torch.sort(pid, stable=True).indices
        return torch.stack([f1, f1, f1], dim=1)[perm]

    timed("out_sort4", out_sort4)
    out = dict(results, width=W, height=H, device=device_name(dev), card=card,
               clock="cuda events; render_sample on the host clock, synchronized"
               if dev.type == "cuda" else "host")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
