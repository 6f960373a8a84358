"""Port parity for the verifier's legacy wide ``g1`` gadget kind
(``prover/pipeline.py:_verify_g1_gadget`` on ``stark/g1_air.py:G1PolyAir``)
at production widths (sk 256 bits, id 32 bits) on the 2-of-3 curve-fault
bad-share scenario (``DkgCommittee(3, 2).shared_data_bad_secret(0, 1,
True)``, auth).

No prover of either package emits this kind, so ``_g1_container``
assembles one as the legacy prover did, with the helpers ``chip_smoke.py``
drives on the card: the scenario's stream and SHA-256 tables (taken from
the port's ``prove_circuit`` with its prover stubbed), then a
``G1PolyAir`` table of the recorded curve relation, whose descriptor (kind
id 3) carries the extras [k, 256, 32, seed_ref, init_ref]: the SHA-table
indices that the same scenario's g1mul descriptor binds.  The stream words
are the port's ``_stream_words`` over that gadget set.  The tables'
STARKs are stubbed by ``monkeypatch`` in the tier-1 cases (as
``tests/test_torch_verify.py`` does), so that each verifier's binding
checks alone are held against the other's, message for message; the real
round trip (the three tables proven by the port's ``prove_tables`` on the
CPU, about two minutes on one core, and both verifiers) is ``heavy``, as
the JAX package gates its own ``G1PolyAir`` tests
(``tests/test_g1_air.py``); ``chip_smoke.py`` proves and verifies such a
container on the card."""

import copy

import numpy as np
import pytest

import chip_smoke
from dvt_circuits_tpu.prover import pipeline as jax_pipeline
from dvt_circuits_tpu.stark.g1_air import G1PolyAir as JaxG1PolyAir
from dvt_circuits_tpu_torch.dkg.scenario_gen import DkgCommittee
from dvt_circuits_tpu_torch.hostcrypto import bls12_381 as host
from dvt_circuits_tpu_torch.prover import pipeline
from dvt_circuits_tpu_torch.stark import TEST_CONFIG, prove_tables
from dvt_circuits_tpu_torch.stark import bigfield as bf
from dvt_circuits_tpu_torch.stark.g1_air import G1PolyAir

from .test_torch_native import jax_native_poseidon2  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def parts():
    """The curve fault's stream and SHA-256 tables, its descriptors and the
    recorded curve relation (``chip_smoke._g1_parts``: the port's
    ``prove_circuit`` with its prover stubbed)."""
    data = DkgCommittee(3, 2).shared_data_bad_secret(0, 1, True)
    return chip_smoke._g1_parts(data, TEST_CONFIG)


def _g1_container(parts, prove: bool) -> dict:
    """A ``g1``-kind container (``chip_smoke._g1_entries``): [stream,
    SHA-256, G1PolyAir] on one transcript, proven by the port's
    ``prove_tables`` on the CPU when ``prove``, else with stub proofs that
    carry the public values."""
    entries, gadgets = chip_smoke._g1_entries(*parts)
    proofs = (prove_tables(entries, TEST_CONFIG, device="cpu") if prove
              else [{"public_values": [int(v) for v in pub]} for _, _, pub in entries])
    return chip_smoke._g1_container(parts[0], gadgets, proofs)


@pytest.fixture(scope="module")
def stubbed(parts):
    return _g1_container(parts, prove=False)


@pytest.fixture
def no_stark(monkeypatch):
    """Both verifiers with every table's STARK stubbed out."""
    monkeypatch.setattr(pipeline, "stark_verify", lambda *args: True)
    monkeypatch.setattr(jax_pipeline, "stark_verify", lambda *args: True)


def _fields(res):
    return (res.circuit, res.binding, res.g1_relations, res.g1_omitted, res.sig_checks)


def test_g1_air_trace_equals_jax_at_production_widths(parts):
    _, _, rel = parts
    k = len(rel["points"])
    ours, theirs = G1PolyAir(k), JaxG1PolyAir(k)
    assert (ours.num_public_values, ours.min_rows) == (theirs.num_public_values, theirs.min_rows)
    trace, publics = ours.generate_trace(rel["secret"], rel["dest_id"], rel["points"])
    jtrace, jpublics = theirs.generate_trace(rel["secret"], rel["dest_id"], rel["points"])
    assert trace.shape == (512, 26477) and np.array_equal(trace, jtrace) and publics == jpublics
    # the relation is the slashable one: pk = sk·G differs from Σ id^j·C_j
    (infa, xa, ya), (infb, xb, yb) = ours.out_points(publics)
    assert (xa, ya) == host.g1_mul(host.G1_GEN, int.from_bytes(rel["secret"], "big"))
    assert (xa, ya) != (xb, yb)


def test_g1_container_accepted_by_both(stubbed, no_stark):
    ours = pipeline.verify_proof(stubbed, "bad-share", strict=True, device="cpu")
    theirs = jax_pipeline.verify_proof(stubbed, "bad-share", strict=True)
    assert _fields(ours) == _fields(theirs) == ("bad-share", "curve-bound", 1, 0, 0)


def _g1(c):
    return c["gadgets"][1]


def _g1_publics(c):
    return _g1(c)["proof"]["public_values"]


def _air(c):
    return G1PolyAir(_g1(c)["extras"][0])


def _set_point(c, base: int, point) -> None:
    pub = _g1_publics(c)
    pub[base : base + 2 * bf.NLIMBS] = bf.int_to_limbs(point[0]) + bf.int_to_limbs(point[1])


def _other_c0(c):
    air = _air(c)
    pub = _g1_publics(c)
    c0 = (bf.limbs_to_int(pub[air.c_base : air.c_base + bf.NLIMBS]),
          bf.limbs_to_int(pub[air.c_base + bf.NLIMBS : air.c_base + 2 * bf.NLIMBS]))
    _set_point(c, air.c_base, host.g1_add(c0, c0))


def _unanchor_init_digest(c):
    """The initial-commitment digest's hex text in the stream changed (and
    its SHA-table offset dropped, so the SHA gadget does not look for it)."""
    import hashlib

    from dvt_circuits_tpu_torch.stark.sha256_air import Sha256Air, message_from_publics

    sha = c["gadgets"][0]
    init_ref = _g1(c)["extras"][4]
    sha_air = Sha256Air(tuple(sha["block_counts"]))
    init_msg = message_from_publics(sha_air, sha["proof"]["public_values"], init_ref - 1)
    text = hashlib.sha256(init_msg).hexdigest().encode("ascii")
    stream = bytes.fromhex(c["public_values"])
    assert text in stream
    swapped = (b"1" if text[:1] == b"0" else b"0") + text[1:]
    c["public_values"] = stream.replace(text, swapped).hex()
    sha["stream_offsets"][init_ref - 1] = None


def _break_hash_chain(c):
    """Byte 3 of the seed-exchange preimage (in its first 32 bytes, the
    initial-commitment digest) flipped in the SHA table's message limbs."""
    from dvt_circuits_tpu_torch.stark.sha256_air import Sha256Air

    sha = c["gadgets"][0]
    off = Sha256Air(tuple(sha["block_counts"])).public_offset(_g1(c)["extras"][3] - 1)
    sha["proof"]["public_values"][off] ^= 1


def _wrong_id(c):
    air = _air(c)
    _g1_publics(c)[air.c_base - 1] += 1


def _valid_share(c):
    """Result B set to result A: the share the relation shows is valid."""
    air = _air(c)
    pub = _g1_publics(c)
    width = 1 + 2 * bf.NLIMBS
    pub[air.ob_base : air.ob_base + width] = pub[air.oa_base : air.oa_base + width]


def _noauth_id_outside(c):
    """A no-auth container whose id lies past the committee."""
    c["auth"] = False
    air = _air(c)
    _g1_publics(c)[air.c_base - 1] = 99


def _set_extras(extras):
    def tamper(c):
        _g1(c)["extras"] = extras(_g1(c)["extras"])

    return tamper


@pytest.mark.parametrize("tamper, message", [
    (_set_extras(lambda e: e[:4]), "g1 extras malformed"),
    (_set_extras(lambda e: [e[0], 16, 8, *e[3:]]),
     "g1 chip scalar widths not the production widths"),
    (_set_extras(lambda e: [1, *e[1:]]), "g1 chip k out of range"),
    (_set_extras(lambda e: [33, *e[1:]]), "g1 chip k out of range"),
    (_other_c0, "g1 C_j not bound to the committed initial-commitment preimage"),
    (_unanchor_init_digest, "g1 initial-commitment digest not among the committed hashes"),
    (lambda c: _g1_publics(c).__setitem__(0, _g1_publics(c)[0] ^ 1),
     "g1 secret not bound to the seed-exchange preimage"),
    (_break_hash_chain, "g1 hash chain broken (init digest vs seed preimage)"),
    (_wrong_id, "g1 id not bound to the sorted-hash index"),
    (_valid_share, "g1 relation shows a VALID share — no slashable fault to prove"),
    (_noauth_id_outside, "g1 id outside the committed committee range"),
], ids=["extras", "widths", "k-low", "k-high", "c-j", "init-digest", "secret", "hash-chain",
        "id", "valid-share", "noauth-id"])
def test_g1_tamper_rejected_by_both(stubbed, no_stark, tamper, message):
    bad = copy.deepcopy(stubbed)
    tamper(bad)
    with pytest.raises(pipeline.VerifyError) as ours:
        pipeline.verify_proof(bad, "bad-share", device="cpu")
    with pytest.raises(jax_pipeline.VerifyError) as theirs:
        jax_pipeline.verify_proof(bad, "bad-share")
    assert str(ours.value) == str(theirs.value) == message


@pytest.mark.heavy  # three tables proven on the CPU (~2 minutes), both verifiers
def test_g1_container_round_trip(parts):
    container = _g1_container(parts, prove=True)
    assert container["gadgets"][1]["proof"]["width"] == 26477
    ours = pipeline.verify_proof(container, "bad-share", strict=True, device="cpu")
    theirs = jax_pipeline.verify_proof(container, "bad-share", strict=True)
    assert _fields(ours) == _fields(theirs) == ("bad-share", "curve-bound", 1, 0, 0)
    bad = copy.deepcopy(container)
    air = _air(bad)
    _g1_publics(bad)[air.oa_base + 3] ^= 1
    with pytest.raises(pipeline.VerifyError, match="STARK verification failed"):
        pipeline.verify_proof(bad, device="cpu")
    with pytest.raises(jax_pipeline.VerifyError, match="STARK verification failed"):
        jax_pipeline.verify_proof(bad)
