"""The system under test: the port's own entry points, called as the
port's CLI and HTTP node call them, for one configuration and one circuit.

This is the only module of the benchmark that imports the port."""

from __future__ import annotations

import json
import os

#: the package the benchmark measures
PACKAGE = "dvt_circuits_tpu_torch"
#: switches of the port that a configuration fixes: one card (no sharding
#: over a process group) and every curve relation proven in-circuit
PINNED_ENV = {"DVT_DIST": "0", "DVT_EP": "0", "DVT_G1": "1"}
#: controls, for showing that the comparison fails them (never in a measured
#: run): the port with its curve tables switched off (``DVT_G1=0``: faster,
#: and hash-bound where the configuration states curve-bound), and with
#: every prove answered by the first container it made (the warm-up's: a
#: cache keyed on nothing)
CONTROLS = ("g1-omitted", "stale-container")


class Program:
    """parse → prove → verify, as one operator's card runs them."""

    def __init__(self, config: dict, circuit: str, device: str, control: str = "") -> None:
        if control and control not in CONTROLS:
            raise ValueError(f"unknown control {control!r}; expected one of {CONTROLS}")
        os.environ.update(PINNED_ENV)
        if control == "g1-omitted":
            os.environ["DVT_G1"] = "0"  # curve relations left out: hash-bound
        import torch
        from dvt_circuits_tpu_torch.circuits.registry import get_circuit
        from dvt_circuits_tpu_torch.prover.pipeline import prove_circuit, verify_proof
        from dvt_circuits_tpu_torch.stark.config import StarkConfig

        self._torch = torch
        self._prove, self._verify = prove_circuit, verify_proof
        self.circuit = circuit
        self.setup = config["setup"]
        self.auth = bool(config["auth"])
        self.device = device
        self.spec = get_circuit(circuit, self.setup)
        self.stark = StarkConfig(**{k: int(v) for k, v in config["stark"].items()})
        self.control = control
        self._first = None

    def sync(self) -> None:
        if self.device == "cuda":
            self._torch.cuda.synchronize()

    def parse(self, raw: str):
        """The scenario's JSON text into the port's typed input (``cli.py``)."""
        return self.spec.data_type.from_json(json.loads(raw), self.spec.setup.layout, self.auth)

    def prove(self, data) -> dict:
        container = self._prove(self.circuit, data, auth=self.auth, config=self.stark,
                                setup=self.setup, device=self.device)
        self.sync()
        if self.control == "stale-container":
            self._first = self._first or container
            return self._first
        return container

    def verify(self, container: dict):
        result = self._verify(container, self.circuit, strict=True, device=self.device)
        self.sync()
        return result
