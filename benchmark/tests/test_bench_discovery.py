"""A configuration, a traffic mix (with a new law), a per-layer metric and a
cell are added by new files and new entries alone: the harness finds each
by its name, without an edit to a file that is already there."""

import json
import shutil

from benchmark import harness

from ._tiny import PATCH, run

#: a law the harness has never seen: every `every` frames the moving
#: instances rise by `rise`, so a film holds the samples since the last rise
STEPS = """
import dataclasses
from benchmark import scene


def _mats(spec, params, frame):
    up = params["rise"] * (frame // params["every"])
    out = []
    for slot in spec.moving:
        m = spec.instances[slot].copy()
        m[:, 1, 3] += up
        out.append((slot, m))
    return out


def apply(backend, spec, params, frame):
    if frame % params["every"] == 0:
        for slot, m in _mats(spec, params, frame):
            backend.set_3d_instances([(slot, scene.instances_view(spec, slot, m))])


def scene_at(spec, params, frame):
    mats = list(spec.instances)
    for slot, m in _mats(spec, params, frame):
        mats[slot] = m
    return dataclasses.replace(spec, instances=mats)


def film_start(params, frame):
    return frame - frame % params["every"]
"""


def test_new_config_traffic_metric_and_cell_by_files_alone(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(harness.HERE, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((harness.HERE.parent / "BENCHMARK.json").read_text())
    before = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}

    # a configuration: its sizes and its generator, new files
    cfg = json.loads((root / "configs" / "flagship.json").read_text())
    cfg.update(PATCH["flagship"], name="flagship_deep", settings=dict(cfg["settings"],
                                                                     max_bounces=3))
    (root / "configs" / "flagship_deep.json").write_text(json.dumps(cfg))
    (root / "configs" / "flagship_deep.py").write_text(
        (root / "configs" / "flagship.py").read_text())
    # a traffic mix of a law that is there: a data file alone
    (root / "traffic" / "slow_bounce.json").write_text(json.dumps(dict(
        name="slow_bounce", law="bounce", amplitude=0.5, omega=1.0, phase_per_unit=0.1,
        dt=1 / 30, warmup_frames=2)))
    # a traffic mix of a new law: the law's file and a data file
    (root / "laws" / "steps.py").write_text(STEPS)
    (root / "traffic" / "steps.json").write_text(json.dumps(dict(
        name="steps", law="steps", every=3, rise=0.25, warmup_frames=2)))
    # a per-layer metric: its reader
    (root / "metrics" / "traced_frames.py").write_text(
        "def read(t):\n    return float(len(t.frames))\n")
    # the cell's limit
    (root / "limits" / "flagship_deep-slow_bounce.json").write_text(
        json.dumps({"off_pct": {"limit": 100.0}}))
    bench["configs"].append(dict(name="flagship_deep", source="x",
                                 file="benchmark/configs/flagship_deep.json", reduced=[],
                                 why="x"))
    (root / "limits" / "flagship_deep-steps.json").write_text(
        json.dumps({"off_pct": {"limit": 1.0}}))
    for traffic in ("slow_bounce", "steps"):
        bench["workloads"].append(dict(name=f"flagship_deep-{traffic}", config="flagship_deep",
                                       traffic=traffic, chips=1, why="x"))
    bench["per_layer"].append(dict(name="traced_frames", unit="count", better="higher",
                                   source="host_clock", layer="device", moves="mrays_per_s",
                                   workloads=["flagship_deep-slow_bounce"]))
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] += ["flagship_deep-slow_bounce", "flagship_deep-steps"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    after = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items() if k in after)  # nothing edited

    result, info = run("flagship_deep-slow_bounce", trace=True, root=root,
                       seed=77)
    assert result["metrics"]["traced_frames"]["value"] == harness.TRACE_FRAMES
    assert result["correct"], info
    result, _ = run("flagship_deep-slow_bounce", seconds=0.3, root=root, seed=78)
    assert set(result["metrics"]) == {"mrays_per_s", "frame_ms_p95", "peak_mem_mib", "setup_s"}
    assert result["correct"]
    # the new law's frames: films of 1 to 3 samples, each of its own scene
    result, info = run("flagship_deep-steps", seconds=0.3, root=root, seed=79)
    assert result["correct"], info
    assert info["frames"] >= 1
