"""What a run reads: the cell named in ``BENCHMARK.json``, its
configuration's file and its traffic mix's file, all found by name."""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

#: the repository root (the checkout the benchmark runs in)
ROOT = Path(__file__).resolve().parents[2]
#: keys every configuration file gives
CONFIG_KEYS = ("name", "n", "k", "setup", "auth", "stark", "source", "reduced")
#: keys every traffic mix file gives
MIX_KEYS = ("circuit", "builder", "args", "pool", "check_sample")
#: the STARK parameters a configuration states, as a container records them
STARK_KEYS = ("log_blowup", "num_queries", "proof_of_work_bits", "log_final_poly_len", "shift")


class SpecError(ValueError):
    pass


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    mix_name: str
    end_to_end: tuple  # metric entries that this cell reports with --trace 0
    per_layer: tuple  # metric entries that this cell reports with --trace 1


def _read_json(path: Path, what: str) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise SpecError(f"{what} not found: {path}") from None
    except json.JSONDecodeError as e:
        raise SpecError(f"{what} is not JSON ({path}): {e}") from None


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its configuration
    (``configs[].file``) and its mix (``portbench/traffic/<traffic>.json``)."""
    bench = _read_json(root / "BENCHMARK.json", "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json; it has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"workload {name!r} names an unknown configuration {w['config']!r}")
    config = _read_json(root / configs[w["config"]]["file"], "configuration file")
    missing = [k for k in CONFIG_KEYS if k not in config]
    if missing or config["name"] != w["config"]:
        raise SpecError(f"configuration file of {w['config']!r} lacks {missing} or names "
                        f"{config.get('name')!r}")
    if sorted(config["stark"]) != sorted(STARK_KEYS):
        raise SpecError(f"configuration {w['config']!r} states {sorted(config['stark'])}, "
                        f"not the STARK parameters {sorted(STARK_KEYS)}")
    mix = _read_json(root / "portbench" / "traffic" / f"{w['traffic']}.json", "traffic mix")
    missing = [k for k in MIX_KEYS if k not in mix]
    if missing:
        raise SpecError(f"traffic mix {w['traffic']!r} lacks {missing}")
    e2e = tuple(m for m in bench["end_to_end"] if _applies(m, name))
    reported = {m["name"] for m in e2e}
    per_layer = tuple(m for m in bench["per_layer"]
                      if _applies(m, name) and m["moves"] in reported)
    return Cell(name, int(w["chips"]), config, mix, w["traffic"], e2e, per_layer)
