"""The one traffic generator: a mix file's parameters, a configuration and
``--seed`` in, scenario JSON texts out.

Each scenario is a fresh committee of the configuration's n and k whose
seed bytes come from the seed and the scenario's index; the mix's builder
(a method of the frozen ``DkgCommittee``) makes its fault or ceremony with
the mix's arguments.  The same seed gives the same texts, and no two
indices give the same committee, so no scenario is proved twice in a run.
"""

from __future__ import annotations

import hashlib
import json

from ..traffic.generator import DkgCommittee

#: the index of the warm-up scenario, outside every pool
WARM = "warm"


def committee_seed(config: dict, mix_name: str, seed: int, index) -> bytes:
    """The committee seed bytes of scenario ``index`` of a run."""
    tag = f"portbench/{config['name']}/{mix_name}/{int(seed)}/{index}"
    return hashlib.sha256(tag.encode()).digest()


def scenario(config: dict, mix: dict, mix_name: str, seed: int, index) -> str:
    """The JSON text of one scenario, as a client would send it."""
    committee = DkgCommittee(int(config["n"]), int(config["k"]),
                             seed=committee_seed(config, mix_name, seed, index))
    data = getattr(committee, mix["builder"])(*mix["args"])
    return json.dumps(data.to_json(bool(config["auth"])))


def pool(config: dict, mix: dict, mix_name: str, seed: int, count: int) -> list:
    """Scenarios 0 .. count - 1 of a run."""
    return [scenario(config, mix, mix_name, seed, i) for i in range(count)]
