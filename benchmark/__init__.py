"""The benchmark of `rfw_tpu_torch`: one cell of `BENCHMARK.json` a process.

`python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>`
runs a configuration (`configs/<name>.json` and its scene generator
`configs/<name>.py`) under a traffic mix (`traffic/<name>.json`) through
`rfw_tpu_torch.render.torch_backend.TorchBackend`, judges the frames it
produced against the plain reference (`reference.py`), and prints one JSON
line. See README.md.
"""
