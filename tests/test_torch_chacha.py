"""Port parity for the ChaCha20 slice: the ChaCha20 AIR (trace, publics,
preprocessed columns), the batched block function, and the bad-encrypted-
share container.

The scenario is built here from ``DkgCommittee``: receiver 1 decrypts a
payload from sender 0 that has the full auth layout of the guest's parser
but a wrong ``gen_id``, so the guest takes its only exit-0 path (a parse
error) after one ChaCha20 decrypt of 178 bytes (3 keystream blocks).  The
2-of-3 container, proven once per module by each package (the JAX one on
its numpy host prover), must be equal field by field except ``timing``;
each verifier accepts the other's with the same ``binding`` and rejects the
tampered ones.  Field values are compared exactly."""

import contextlib
import copy
import hashlib
import json

import numpy as np
import pytest
import torch

from dvt_circuits_tpu.circuits.registry import get_circuit as jax_get_circuit
from dvt_circuits_tpu.dkg import hash_recorder as jax_hash_recorder
from dvt_circuits_tpu.hash import chacha20_tpu as jax_chacha
from dvt_circuits_tpu.prover import pipeline as jax_pipeline
from dvt_circuits_tpu.stark.chacha20_air import ChaCha20Air as JaxChaCha20Air
from dvt_circuits_tpu.stark.config import TEST_CONFIG as JAX_TEST_CONFIG
from dvt_circuits_tpu_torch.dkg import hash_recorder
from dvt_circuits_tpu_torch.dkg.keys import BlsDkgWithSecp256kCommitment as Setup
from dvt_circuits_tpu_torch.dkg.keys import BlsSecretKey
from dvt_circuits_tpu_torch.dkg.scenario_gen import DkgCommittee
from dvt_circuits_tpu_torch.dkg.types import BadEncryptedShare
from dvt_circuits_tpu_torch.hash import chacha20
from dvt_circuits_tpu_torch.hostcrypto.chacha20 import (
    chacha20_block,
    chacha20_keystream,
    chacha20_xor,
)
from dvt_circuits_tpu_torch.prover import pipeline
from dvt_circuits_tpu_torch.stark.chacha20_air import (
    ChaCha20Air,
    init_from_publics,
    init_publics,
    keystream_from_publics,
)
from dvt_circuits_tpu_torch.stark.config import TEST_CONFIG

from .test_torch_native import jax_native_poseidon2  # noqa: F401  (autouse)

CIRCUIT = "bad-encrypted-share"


def bad_encrypted_share(n: int, k: int) -> BadEncryptedShare:
    """Sender 0's share payload to receiver 1 of an n-participant, threshold-k
    committee, encrypted under the ECDH key of the guest's convention (the
    bytewise-largest base pubkey of each side; key = SHA-256 of the
    compressed ECDH point, nonce = its first 12 bytes), with a wrong
    ``gen_id``."""
    com = DkgCommittee(n, k)
    sender_encr_pubkey = max(com.vvs[0], key=bytes)
    j = max(range(k), key=lambda i: bytes(com.vvs[1][i]))
    receiver_encr_seckey = BlsSecretKey(com.polys[1][j]).to_bytes()
    point = Setup.Point.from_bytes(bytes(sender_encr_pubkey)).mul_scalar(
        Setup.Scalar.from_bytes(receiver_encr_seckey))
    key = hashlib.sha256(bytes(point.to_bytes())).digest()
    sec = com.shared_data(0, 1, True).seeds_exchange_commitment
    payload = (hashlib.sha256(b"another generation").digest()[:16] + bytes([3])
               + bytes(sec.shared_secret.secret) + bytes(sec.commitment.hash)
               + bytes(sec.commitment.pubkey) + bytes(sec.commitment.signature))
    obj = {
        "sender_pubkey": bytes(com.secp_keys[0].to_public_key().to_bytes()).hex(),
        "sender_encr_pubkey": bytes(sender_encr_pubkey).hex(),
        "receiver_encr_seckey": bytes(receiver_encr_seckey).hex(),
        "encrypted_data": chacha20_xor(key, key[:12], payload).hex(),
        "settings": com.settings.to_json(),
        "base_hashes": [bytes(h).hex() for h in com.base_hashes],
        "sender_base_pubkeys": [bytes(p).hex() for p in com.vvs[0]],
        "receiver_base_pubkeys": [bytes(p).hex() for p in com.vvs[1]],
    }
    return BadEncryptedShare.from_json(obj, Setup.layout, True)


def _jax_data(data):
    spec = jax_get_circuit(CIRCUIT)
    return spec.data_type.from_json(json.loads(json.dumps(data.to_json(True))),
                                    spec.setup.layout, True)


@contextlib.contextmanager
def _one_torch_thread():
    """Torch on one thread: the suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _fields(res):
    return (res.circuit, res.binding, res.g1_relations, res.g1_omitted, res.sig_checks)


# -- the AIR and the batched block function ---------------------------------

#: block counters the AIR and the batched block function are held at
_COUNTERS = (0, 1, 7, (1 << 32) - 1)


def _blocks():
    rng = np.random.default_rng(20)
    return [(bytes(rng.integers(0, 256, 32, dtype=np.uint8)), ctr,
             bytes(rng.integers(0, 256, 12, dtype=np.uint8))) for ctr in _COUNTERS]


def test_air_trace_publics_and_preprocessed_equal_jax():
    blocks = _blocks()
    air, jax_air = ChaCha20Air(len(blocks)), JaxChaCha20Air(len(blocks))
    trace, publics = air.generate_trace(blocks)
    jax_trace, jax_publics = jax_air.generate_trace(blocks)
    assert np.array_equal(trace, jax_trace) and publics == jax_publics
    n = trace.shape[0]
    assert n == 1 << air.log_rows and air.preprocessed_width == jax_air.preprocessed_width
    assert np.array_equal(air.preprocessed_trace(n), jax_air.preprocessed_trace(n))


@pytest.mark.parametrize("blk", range(len(_COUNTERS)), ids=[f"counter-{c}" for c in _COUNTERS])
def test_air_keystream_equals_the_host_cipher(blk):
    blocks = _blocks()
    _, publics = ChaCha20Air(len(blocks)).generate_trace(blocks)
    key, counter, nonce = blocks[blk]
    assert keystream_from_publics(publics, blk) == chacha20_block(key, counter, nonce)
    assert init_from_publics(publics, blk) == (key, counter, nonce)
    assert publics[56 * blk : 56 * blk + 24] == init_publics(key, counter, nonce)


@pytest.mark.parametrize("counter", _COUNTERS)
def test_batched_block_function_equals_jax_and_host(counter):
    key, _, nonce = _blocks()[0]
    # the JAX package's block counters are uint32: it stops at 2^32 - 1
    n_blocks = min(5, (1 << 32) - counter)
    want = chacha20_keystream(key, nonce, 64 * n_blocks, counter)
    assert chacha20.keystream(key, nonce, 64 * n_blocks, counter, device="cpu") == want
    assert jax_chacha.keystream(key, nonce, 64 * n_blocks, counter) == want
    data = bytes(range(177))
    assert chacha20.xor(key, nonce, data, counter, device="cpu") == chacha20_xor(
        key, nonce, data, counter)
    states = chacha20.make_states(key, nonce, range(counter, counter + n_blocks), device="cpu")
    jax_states = jax_chacha.make_states(key, nonce, range(counter, counter + n_blocks))
    assert np.array_equal(states.numpy(), np.asarray(jax_states).astype(np.int64))
    assert np.array_equal(chacha20.chacha20_blocks(states).numpy(),
                          np.asarray(jax_chacha.chacha20_blocks(jax_states)).astype(np.int64))


def test_keystream_across_counter_2_32_wraps_like_the_host_cipher():
    """Past block counter 2^32 - 1 the port wraps to 0, as the host cipher
    does; the JAX package's batched keystream raises there (its counters
    are numpy uint32).  The guests start every keystream at counter 0."""
    key, _, nonce = _blocks()[0]
    counter = (1 << 32) - 1
    want = chacha20_keystream(key, nonce, 128, counter)
    assert want[64:] == chacha20_block(key, 0, nonce)
    assert chacha20.keystream(key, nonce, 128, counter, device="cpu") == want
    with pytest.raises(OverflowError):
        jax_chacha.keystream(key, nonce, 128, counter)


# -- the bad-encrypted-share container ---------------------------------------


@pytest.fixture(scope="module")
def containers():
    """(port, JAX) 2-of-3 containers, each proven once."""
    with _one_torch_thread(), pytest.MonkeyPatch.context() as mp:
        mp.setenv("DVT_PROVER", "host")
        data = bad_encrypted_share(3, 2)
        yield (pipeline.prove_circuit(CIRCUIT, data, True, TEST_CONFIG, device="cpu"),
               jax_pipeline.prove_circuit(CIRCUIT, _jax_data(data), True, JAX_TEST_CONFIG))


def _chacha_gadget(container):
    return next(g for g in container["gadgets"] if g["kind"] == "chacha20")


def test_container_equals_jax(containers):
    ours, theirs = containers
    assert ours.keys() == theirs.keys()
    for key in theirs:
        if key != "timing":
            assert ours[key] == theirs[key], key
    assert [g["kind"] for g in ours["gadgets"]] == ["sha256", "chacha20"]
    g = _chacha_gadget(ours)
    # 178 bytes: 3 keystream blocks, padded to 4 (84 rows, 2^7)
    assert g["block_counts"] == [3] and g["extras"][:2] == [4, 178]
    assert g["proof"]["log_n"] == 7 and g["proof"]["width"] == 1080
    assert ours["chacha_omitted"] == 0 and g["stream_offsets"][0] is not None


@pytest.mark.parametrize("maker, checker", [("port", "jax"), ("jax", "port"), ("port", "port"),
                                            ("jax", "jax")])
def test_each_verifier_accepts_each_container(containers, maker, checker):
    container = containers[maker == "jax"]
    if checker == "port":
        res = pipeline.verify_proof(container, CIRCUIT, strict=True, device="cpu")
    else:
        res = jax_pipeline.verify_proof(container, CIRCUIT, strict=True)
    assert _fields(res) == (CIRCUIT, "hash-bound", 0, 0, 0)


def test_keystream_matches_the_cipher_and_the_stream(containers):
    ours, _ = containers
    g = _chacha_gadget(ours)
    publics = g["proof"]["public_values"]
    key, ctr0, nonce = init_from_publics(publics, 0)
    assert ctr0 == 0 and nonce == key[:12]
    nb, ct_len = g["block_counts"][0], g["extras"][1]
    ks = b"".join(keystream_from_publics(publics, j) for j in range(nb))
    assert ks[:ct_len] == chacha20_keystream(key, nonce, ct_len)
    stream = bytes.fromhex(ours["public_values"])
    off = g["stream_offsets"][0]
    ct = bytes.fromhex(stream[off : off + 2 * ct_len].decode("ascii"))
    # the recomputed plaintext is the parser's payload: its gen_id is wrong
    plain = bytes(a ^ b for a, b in zip(ct, ks))
    assert len(plain) == 178 and plain[16] == 3


def _flip_keystream_limb(container):
    pv = _chacha_gadget(container)["proof"]["public_values"]
    pv[30] = int(pv[30]) ^ 1


def _key_at_another_message(container):
    g = _chacha_gadget(container)
    g["extras"][2] = (g["extras"][2] + 1) % 4


def _strip_chacha(container):
    container["gadgets"] = [g for g in container["gadgets"] if g["kind"] != "chacha20"]


@pytest.mark.parametrize("tamper", [_flip_keystream_limb, _key_at_another_message, _strip_chacha],
                         ids=["flipped-keystream-limb", "key-at-another-message",
                              "stripped-chacha-table"])
def test_tampered_container_rejected_by_both(containers, tamper):
    bad = copy.deepcopy(containers[0])
    tamper(bad)
    with pytest.raises(pipeline.VerifyError):
        pipeline.verify_proof(bad, device="cpu")
    with pytest.raises(jax_pipeline.VerifyError):
        jax_pipeline.verify_proof(bad)


def test_invocations_outside_the_carry_rules_are_counted_like_jax(monkeypatch):
    """Besides the guest's own decrypt, the witness records an empty
    ciphertext, a start counter of 1, a nonce that is not key[:12] and a key
    that is no SHA-256 digest of the table: each is counted in
    ``chacha_omitted`` by both packages, and the carried one still proves."""
    monkeypatch.setenv("DVT_PROVER", "host")
    data = bad_encrypted_share(3, 2)

    def with_extra(execute, recorder):
        def run(*args, **kwargs):
            result = execute(*args, **kwargs)
            # the guest's own key, from the decrypt it recorded
            key = recorder._get("chacha")[0][0]
            recorder.record_chacha(key, key[:12], 0, b"")
            recorder.record_chacha(key, key[:12], 1, b"ciphertext")
            recorder.record_chacha(key, bytes(12), 0, b"ciphertext")
            recorder.record_chacha(bytes(32), bytes(12), 0, b"ciphertext")
            return result

        return run

    monkeypatch.setattr(pipeline, "execute_circuit",
                        with_extra(pipeline.execute_circuit, hash_recorder))
    monkeypatch.setattr(jax_pipeline, "execute_circuit",
                        with_extra(jax_pipeline.execute_circuit, jax_hash_recorder))
    with _one_torch_thread():
        ours = pipeline.prove_circuit(CIRCUIT, data, True, TEST_CONFIG, device="cpu")
    theirs = jax_pipeline.prove_circuit(CIRCUIT, _jax_data(data), True, JAX_TEST_CONFIG)
    assert ours["chacha_omitted"] == theirs["chacha_omitted"] == 4
    assert {k: v for k, v in ours.items() if k != "timing"} == {
        k: v for k, v in theirs.items() if k != "timing"}
    assert _chacha_gadget(ours)["block_counts"] == [3]
    assert pipeline.verify_proof(ours, CIRCUIT, device="cpu")
