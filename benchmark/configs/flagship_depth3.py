"""The flagship scene at the port's default path depth: `flagship.py`'s
generator, unchanged; `flagship_depth3.json` holds `flagship.json`'s sizes,
layout and materials, with 3 bounces and clamp 10 in its settings."""

from pathlib import Path

from benchmark.by_name import load_module

build = load_module(Path(__file__).resolve().parent / "flagship.py").build
