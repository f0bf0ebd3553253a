"""A cell as ``BENCHMARK.json`` names it: its configuration, its traffic,
the driver its traffic names and its metrics, each found by name among the
benchmark's own files."""

from __future__ import annotations

import importlib.util
import json
import tomllib
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from harness.reference import MARKER_STRATEGY, Clip, pcm16_to_f32
from harness.traffic import read_wav_int16

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
CONFIGS = BENCH_DIR / "configs"
TRAFFIC = BENCH_DIR / "traffic"
METRICS = BENCH_DIR / "metrics"
DRIVERS = BENCH_DIR / "drivers"
DATA = BENCH_DIR / "data"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    data_dir: Path

    @property
    def driver(self):
        """The module of ``drivers/`` that the traffic file names."""
        return load_driver(self.traffic["driver"])


def load_benchmark(path: Path | None = None) -> dict:
    return json.loads((path or ROOT / "BENCHMARK.json").read_text())


def load_cell(workload: str, bench: dict | None = None) -> Cell:
    bench = bench or load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((TRAFFIC / f"{w['traffic']}.json").read_text())

    def reported(m: dict) -> bool:
        return workload in m["workloads"] if "workloads" in m else True

    e2e = [m for m in bench["end_to_end"] if reported(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, per_layer, DATA / w["config"])


def _load(path: Path, module: str):
    spec = importlib.util.spec_from_file_location(module, path)
    if spec is None or spec.loader is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_DRIVERS: dict[str, object] = {}


def load_driver(name: str):
    """``drivers/<name>.py``, loaded once a process."""
    if name not in _DRIVERS:
        _DRIVERS[name] = _load(DRIVERS / f"{name}.py", f"bench_driver_{name}")
    return _DRIVERS[name]


def metric_path(name: str) -> Path:
    """``metrics/<name>.py``, or for a name with a family suffix
    (``device_idle_pct.live``) without a reader of its own, the reader
    of the name without it (``metrics/device_idle_pct.py``)."""
    own = METRICS / f"{name}.py"
    if own.is_file() or "." not in name:
        return own
    return METRICS / f"{name.rsplit('.', 1)[0]}.py"


def metric_reader(name: str):
    """``read(ctx)`` of the metric's reader: the metric's value, or None
    where the run gave it nothing to read."""
    return _load(metric_path(name), f"metric_{name.replace('.', '_')}").read


def reference_clips(config: dict, seed: int) -> list[Clip]:
    """The bank's patterns, made from the configuration (and, for seeded
    clips, the seed) without the port."""
    sr = int(config["sample_rate"])
    if "bank" in config:
        rng = np.random.default_rng(np.random.SeedSequence([seed, 0]))
        normal, marker = config["bank"]["normal"], config["bank"]["marker"]
        clips = [Clip(f"normal_{i}", (normal["rms"] * rng.standard_normal(int(normal["seconds"] * sr)))
                      .astype(np.float32)) for i in range(normal["count"])]
        m = round(marker["seconds"] * sr)
        t = np.arange(m) / sr
        for i in range(marker["count"]):
            f = marker["first_hz"] + marker["step_hz"] * i
            clips.append(Clip(f"marker_{i}", np.sin(2 * np.pi * f * t).astype(np.float32),
                              MARKER_STRATEGY, f))
        return clips
    return [_pattern_file(CONFIGS / p, sr) for p in config["patterns"]]


def pattern_paths(config: dict) -> list[str]:
    return [str(CONFIGS / p) for p in config.get("patterns", [])]


def _pattern_file(path: Path, sr: int) -> Clip:
    if path.name.endswith(".apd.toml"):
        doc = tomllib.loads(path.read_text())
        clip, ver = doc["clip"], dict(doc["verification"])
        if clip["source"] != "sine":
            raise ValueError(f"{path}: only sine clips are configured")
        n = int(round(float(clip["duration_seconds"]) * sr))
        t = np.arange(n, dtype=np.float32) / np.float32(sr)
        amp = float(clip.get("amplitude", 0.9))
        audio = (amp * np.sin((2.0 * np.pi * float(clip["frequency_hz"])) * t)).astype(np.float32)
        strategy = ver.pop("strategy")
        tone = float(ver.pop("dominant_frequency_hz", clip["frequency_hz"]))
        return Clip(path.name[: -len(".apd.toml")], audio, strategy, tone, ver)
    x, rate = read_wav_int16(path)
    if rate != sr:
        raise ValueError(f"{path}: {rate} Hz, the configuration runs at {sr} Hz")
    return Clip(path.stem, pcm16_to_f32(x))
