"""Port parity for the service surface: the input schemas (``dkg/schemas.py``)
byte for byte against the JAX package's for every circuit in both auth
modes, the CLI's ``get-schema`` and ``validate-schema`` against the JAX
CLI, the ``node`` HTTP routes against the JAX package's node, and
``prove_batch`` against ``prove_circuit`` one by one, on the CPU."""

import hashlib
import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from dvt_circuits_tpu import cli as jax_cli
from dvt_circuits_tpu.circuits.registry import get_circuit as jax_get_circuit
from dvt_circuits_tpu.dkg import schemas as jax_schemas
from dvt_circuits_tpu.service import node as jax_node
from dvt_circuits_tpu_torch import cli
from dvt_circuits_tpu_torch.circuits.registry import CIRCUITS, get_circuit
from dvt_circuits_tpu_torch.dkg import schemas
from dvt_circuits_tpu_torch.dkg.keys import BlsDkgWithSecp256kCommitment
from dvt_circuits_tpu_torch.dkg.scenario_gen import DkgCommittee
from dvt_circuits_tpu_torch.dkg.types import SHA256Raw
from dvt_circuits_tpu_torch.dkg.verification import compute_seed_exchange_hash
from dvt_circuits_tpu_torch.prover import pipeline
from dvt_circuits_tpu_torch.service import node
from dvt_circuits_tpu_torch.stark.config import TEST_CONFIG


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: the suite runs several test processes at once, and
    torch's spinning worker threads slow every process on a shared CPU (the
    plain curve and prover paths are thousands of small ops)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pre_curve_fault(sender: int, receiver: int):
    """Auth seed exchange sender → receiver of a 2-of-3 committee whose
    dst_base_hash lies outside the committee, re-hashed and re-signed: the
    guest slashes before the curve check."""
    com = DkgCommittee(3, 2)
    data = com.shared_data(sender, receiver, True)
    sec = data.seeds_exchange_commitment
    sec.shared_secret.dst_base_hash = SHA256Raw(hashlib.sha256(b"outsider").digest())
    h = compute_seed_exchange_hash(BlsDkgWithSecp256kCommitment, sec)
    sec.commitment.hash = h
    sec.commitment.signature = com.secp_keys[sender].sign(bytes(h)).to_bytes()
    return data


@pytest.mark.parametrize("auth", [True, False], ids=["auth", "no-auth"])
@pytest.mark.parametrize("circuit", sorted(CIRCUITS))
def test_schemas_equal_jax(circuit, auth):
    spec, jspec = get_circuit(circuit), jax_get_circuit(circuit)
    assert spec.schema_name == jspec.schema_name
    for layout_name in ("BLS_SECP_LAYOUT", "BLS_BLS_LAYOUT"):
        layout = getattr(schemas, layout_name)
        jlayout = getattr(jax_schemas, layout_name)
        assert schemas.schema_for(spec.schema_name, layout, auth) == \
            jax_schemas.schema_for(spec.schema_name, jlayout, auth)
        assert schemas.json_schema_for(spec.schema_name, layout, auth) == \
            jax_schemas.json_schema_for(spec.schema_name, jlayout, auth)
        assert schemas.yaml_schema_for(spec.schema_name, layout, auth) == \
            jax_schemas.yaml_schema_for(spec.schema_name, jlayout, auth)


@pytest.mark.parametrize("schema_type", ["json", "yaml"])
def test_get_schema_cli_equals_jax(schema_type, capsys):
    argv = ["--auth-commitment", "get-schema", "--type=bad-share", f"--schema-type={schema_type}"]
    assert cli.run(argv) == 0
    ours = capsys.readouterr()
    assert jax_cli.run(argv) == 0
    theirs = capsys.readouterr()
    assert ours.out == theirs.out
    assert "Commit Hash" in ours.err  # the banner, on stderr


def test_validate_schema_cli(tmp_path, monkeypatch):
    monkeypatch.setenv("DVT_NO_BANNER", "1")
    schema = tmp_path / "schema.json"
    assert cli.run(["--auth-commitment", "get-schema", "--type=bad-share", "--schema-type=json",
                    "-o", str(schema)]) == 0
    scenario = tmp_path / "scenario.json"
    scenario.write_text(json.dumps(_pre_curve_fault(0, 1).to_json(True)))
    bad = tmp_path / "bad.json"
    bad.write_text('{"wrong": 1}')
    for run in (cli.run, jax_cli.run):
        assert run(["validate-schema", "-s", str(schema), "-j", str(scenario)]) == 0
        assert run(["validate-schema", "-s", str(schema), "-j", str(bad)]) == 1
        # the schema gate in front of execute: a body that fails it exits 1
        assert run(["--auth-commitment", "execute", "--type=bad-share", "-i", str(scenario),
                    "--json-schema-file", str(schema)]) == 0
        assert run(["--auth-commitment", "execute", "--type=bad-share", "-i", str(bad),
                    "--json-schema-file", str(schema)]) == 1


def _request(port: int, method: str, path: str, body: bytes | None = None):
    """(status, decoded JSON payload) of one request to the local server."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class _Served:
    """A node server on a free local port, in a thread, for a ``with``."""

    def __init__(self, server):
        self.server = server
        self.port = server.server_address[1]
        self.thread = threading.Thread(target=server.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()
        return False


def test_node_routes_equal_jax(monkeypatch):
    data = _pre_curve_fault(0, 1)
    body = json.dumps(data.to_json(True)).encode()
    routes = [
        ("GET", "/prove/bad-share/spec", None),
        ("GET", "/execute/finalization/spec", None),
        ("GET", "/prove/no-such-circuit/spec", None),
        ("GET", "/nowhere", None),
        ("POST", "/execute/bad-share", body),
        ("POST", "/execute/bad-share", b"{}"),
        ("POST", "/execute/bad-share", b"{not json"),
        ("POST", "/execute/no-such-circuit", body),
        ("POST", "/nowhere/bad-share", body),
    ]
    with _Served(node.make_server("127.0.0.1", 0, True, device="cpu")) as ours, \
            _Served(jax_node.make_server("127.0.0.1", 0, True)) as theirs:
        for method, path, payload in routes:
            got = _request(ours.port, method, path, payload)
            assert got == _request(theirs.port, method, path, payload), (method, path)
        assert _request(ours.port, "POST", "/execute/bad-share", body)[0] == 200
        assert _request(ours.port, "POST", "/execute/bad-share", b"{}")[0] == 500
        status, spec = _request(ours.port, "GET", "/prove/bad-share/spec")
        assert status == 200 and spec["schema"] == schemas.schema_for(
            "SharedData", get_circuit("bad-share").setup.layout, True)

        # a prove through the route equals prove_circuit on the same data
        monkeypatch.setattr(node, "DEFAULT_CONFIG", TEST_CONFIG)
        status, proved = _request(ours.port, "POST", "/prove/bad-share", body)
    assert status == 200 and proved["status"] == "proved"
    assert proved["circuit"] == "bad-share"
    direct = pipeline.prove_circuit("bad-share", data, True, TEST_CONFIG, device="cpu")
    assert proved["public_values"] == direct["public_values"]


def test_node_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        node.make_server("127.0.0.1", 0, True)


def test_prove_batch_equals_prove_circuit():
    datas = [_pre_curve_fault(0, 1), _pre_curve_fault(2, 0)]
    batch = pipeline.prove_batch("bad-share", datas, True, TEST_CONFIG, device="cpu")
    assert len(batch) == 2
    singles = [pipeline.prove_circuit("bad-share", d, True, TEST_CONFIG, device="cpu")
               for d in datas]
    digests = [pipeline.container_digest(c) for c in batch]
    assert digests == [pipeline.container_digest(c) for c in singles]
    assert digests[0] != digests[1]
