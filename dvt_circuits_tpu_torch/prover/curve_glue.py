"""G1 curve-relation glue: DKG statements → scalar-mul chains + bindings.

The tall chip (stark/g1mul_air.py) proves batches of scalar-muls
R_c = s_c·P_c.  Everything else in the reference's curve math is GLUE the
verifier recomputes host-side from public data — group additions, Horner
recombination, Lagrange coefficients in Fr, sorted-id assignment — so each
DKG statement becomes: (1) a list of chains for the chip, (2) a
deterministic host-side re-derivation that checks the chip's public
scalars/operands/results against SHA-proven preimages and the committed
stream.  Three relation kinds (ids absorbed in the gadget descriptor):

  1 "poly"    — bad-share Feldman check (verification.rs:107-118):
                pk = sk·G  vs  poly(id) = Horner(C, id)
  2 "agg"     — finalization aggregation (verification.rs:262-331):
                per-id Horner over column sums Σ_i C_ij, then TWO
                Lagrange-at-0 reconstructions (computed partials AND input
                partial pubkeys) both equal to the committed aggregate key
  3 "partial" — bad-partial-key expected-key check (verification.rs:422-466):
                Horner(Σ_i C_i·, perp_id)  vs  the accused partial pubkey

Remaining (documented) trust gap after this module: BLS pairings and
secp256k1 ECDSA verifications — the group-arithmetic skeleton is fully
in-circuit (VERDICT r3 item 2).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..hostcrypto import bls12_381 as bls
from ..hostcrypto.bls12_381 import G1_GEN, R as FR_ORDER

Point = Optional[Tuple[int, int]]  # None = point at infinity

#: relation kind ids absorbed into the gadget descriptor
KIND_IDS = {"poly": 1, "agg": 2, "partial": 3}

#: chip table height cap (rows = Σ bits_c·7 + 2·chains); beyond this the
#: relation is counted omitted rather than silently dropped
MAX_CHAIN_ROWS = 1 << 17

ID_BITS = 32  # ids are bls_id_from_u32 embeds (bls_keys.rs:244-273)
FULL_BITS = 256  # secrets and Fr scalars
MAX_CLEARTEXT = 4096  # committed message-cleartext size cap (bytes)


class Unprovable(ValueError):
    """The relation cannot be carried by the chip (identity points,
    x-collisions, oversize tables) — counted in the omitted counter."""


def lagrange_at_zero(ids: Sequence[int]) -> List[int]:
    """λ_i = Π_{j≠i} x_j / (x_j − x_i) mod r (dkg_math.rs:178-227 at x=0)."""
    out = []
    for i, xi in enumerate(ids):
        num = den = 1
        for j, xj in enumerate(ids):
            if j == i:
                continue
            num = num * xj % FR_ORDER
            den = den * ((xj - xi) % FR_ORDER) % FR_ORDER
        out.append(num * pow(den, FR_ORDER - 2, FR_ORDER) % FR_ORDER)
    return out


def _req_point(p: Point) -> Tuple[int, int]:
    if p is None:
        raise Unprovable("point at infinity in chain glue")
    return p


def _scalar_bytes(v: int, bits: int) -> bytes:
    return int(v).to_bytes(bits // 8, "big")


def _add(a: Point, b: Point) -> Point:
    return bls.g1_add(a, b)


def _mul(p: Point, k: int) -> Point:
    if p is None or k % FR_ORDER == 0:
        return None
    return bls.g1_mul(p, k)


# ---------------------------------------------------------------------------
# Chain planning (shared by prover and verifier glue)
# ---------------------------------------------------------------------------


def horner_chain_plan(coeffs: Sequence[Point], id_val: int):
    """Chains for Horner(coeffs, id) = ((C_{k-1}·id + C_{k-2})·id + …)·id + C_0.

    Returns (chains, final_point) where chains = [(bits, scalar_bytes,
    operand, result)] — k−1 chains of ID_BITS each; between chains the
    verifier host-adds the next coefficient.  k = 1 degenerates to zero
    chains (the polynomial is the constant C_0)."""
    k = len(coeffs)
    if k == 1:
        return [], coeffs[0]
    chains = []
    h = _req_point(coeffs[k - 1])
    for j in range(k - 2, -1, -1):
        m = _mul(h, id_val)
        chains.append((ID_BITS, _scalar_bytes(id_val, ID_BITS), h, m))
        h = _add(m, coeffs[j])
        if j > 0:
            h = _req_point(h)
    return chains, h


def agg_vectors(vvs: Sequence[Sequence[Point]]) -> List[Point]:
    """Column sums Σ_i C_ij (dkg_math.rs:230-248 agg_coefficients' sum)."""
    k = len(vvs[0])
    out = []
    for j in range(k):
        s: Point = None
        for vv in vvs:
            s = _add(s, vv[j])
        out.append(s)
    return out


def plan_poly(rel: dict):
    """bad-share: chains [sk·G] + Horner(C, id)."""
    pts = [_req_point(p) for p in rel["points"]]
    sk_int = int.from_bytes(rel["secret"], "big")
    chains = [
        (FULL_BITS, rel["secret"], G1_GEN, _mul(G1_GEN, sk_int))
    ]
    h_chains, poly = horner_chain_plan(pts, rel["dest_id"])
    chains += h_chains
    return chains, {"k": len(pts)}


def plan_agg(rel: dict):
    """finalization: per-id Horner over column sums + two Lagrange paths."""
    vvs = [[_req_point(p) for p in vv] for vv in rel["vvs"]]
    partials = [_req_point(p) for p in rel["partials"]]
    n = len(vvs)
    k = len(vvs[0])
    avec = [_req_point(p) for p in agg_vectors(vvs)]
    lam = lagrange_at_zero(list(range(1, n + 1)))
    chains = []
    computed = []
    for i in range(n):
        h_chains, part = horner_chain_plan(avec, i + 1)
        chains += h_chains
        computed.append(_req_point(part))
    for i in range(n):  # path A: λ over computed partials
        chains.append(
            (FULL_BITS, _scalar_bytes(lam[i], FULL_BITS), computed[i],
             _mul(computed[i], lam[i]))
        )
    for i in range(n):  # path B: λ over input partial pubkeys
        chains.append(
            (FULL_BITS, _scalar_bytes(lam[i], FULL_BITS), partials[i],
             _mul(partials[i], lam[i]))
        )
    return chains, {"n": n, "k": k}


def plan_partial(rel: dict):
    """bad-partial-key: Horner over column sums at the perpetrator id."""
    vvs = [[_req_point(p) for p in vv] for vv in rel["vvs"]]
    n = len(vvs)
    k = len(vvs[0])
    avec = [_req_point(p) for p in agg_vectors(vvs)]
    chains, expected = horner_chain_plan(avec, rel["perp_id"])
    return chains, {"n": n, "k": k, "expected": expected}


PLANNERS = {"poly": plan_poly, "agg": plan_agg, "partial": plan_partial}


def build_chip(rel: dict, device="cpu"):
    """(air, trace, publics, chain_bits, meta) for one recorded relation,
    the chip's trace assembled on ``device``.

    Raises Unprovable for the documented pathologies (identity points in
    the glue, x-collisions mid-ladder, oversize tables)."""
    from ..stark.g1mul_air import G1MulAir

    chains, meta = PLANNERS[rel["kind"]](rel)
    rows = sum(b * 7 + 2 for b, *_ in chains)
    if rows > MAX_CHAIN_ROWS:
        raise Unprovable(f"chip table too tall ({rows} rows)")
    chain_bits = tuple(b for b, *_ in chains)
    air = G1MulAir(chain_bits)
    try:
        trace, publics = air.generate_trace(
            [(sb, op) for _, sb, op, _ in chains], device
        )
    except ValueError as e:  # x-collision guard
        raise Unprovable(str(e)) from None
    return air, trace, publics, chain_bits, meta


class GlueError(ValueError):
    """Verifier-side glue failure (binding or recomputation mismatch)."""


# ---------------------------------------------------------------------------
# Prover-side gadget assembly
# ---------------------------------------------------------------------------


def _find_digest_ref(sha_digests: Sequence[bytes], digest: bytes) -> int:
    """1-based SHA-table message index carrying ``digest``, or 0."""
    for i, d in enumerate(sha_digests):
        if d == digest:
            return i + 1
    return 0


def build_gadget(
    rel: dict,
    sha_originals: Sequence[bytes],
    sha_digests: Sequence[bytes],
    stream: bytes,
    auth: bool,
    device="cpu",
):
    """(gadget_descriptor, (air, trace, publics)) for one recorded relation,
    the chip's trace assembled on ``device``.

    Validates every binding the verifier will demand BEFORE committing to
    the gadget (advisor r3 finding 3: an unanchored gadget yields a
    guaranteed-reject container) — raises Unprovable otherwise."""
    import hashlib

    air, trace, publics, chain_bits, meta = build_chip(rel, device)
    kind = rel["kind"]
    frames = _split_frames(stream)
    hashes = _hash_frames(frames)

    if kind == "poly":
        init_ref = seed_ref = 0
        for mi, orig in enumerate(sha_originals):
            if init_ref == 0 and _parse_vv_preimage(orig) is not None:
                pts = _parse_vv_preimage(orig)
                if pts == [tuple(p) for p in rel["points"]]:
                    init_ref = mi + 1
        if init_ref == 0:
            raise Unprovable("no initial-commitment preimage in the SHA table")
        init_digest = hashlib.sha256(sha_originals[init_ref - 1]).digest()
        if init_digest not in hashes:
            raise Unprovable("initial-commitment digest not stream-committed")
        if auth:
            for mi, orig in enumerate(sha_originals):
                if (
                    len(orig) == 96
                    and orig[0:32] == init_digest
                    and orig[32:64] == rel["secret"]
                ):
                    seed_ref = mi + 1
                    break
            if seed_ref == 0:
                raise Unprovable("no seed-exchange preimage in the SHA table")
        extras = [KIND_IDS[kind], meta["k"], seed_ref, init_ref]
        if auth:
            # commit the ECDSA commitment credentials: the verifier re-runs
            # verify_commitment (verification.rs:365-374) over the SHA-proven
            # seed-exchange digest — zero witness trust for the identity check
            cpk, csig = rel.get("commit_pubkey"), rel.get("commit_sig")
            if cpk is None or csig is None or len(cpk) != 33 or len(csig) != 64:
                raise Unprovable("missing ECDSA commitment credentials")
            extras += list(cpk) + list(csig)
    elif kind == "agg":
        n = meta["n"]
        if len(hashes) != n:
            raise Unprovable("stream hash count does not match n")
        refs = _sorted_gen_refs(sha_digests, hashes)
        # Commit the sorted partial pubkeys (48B compressed each) so the
        # verifier can bind every path-B λ-chain operand to container bytes
        # (advisor r4 high finding: unbound operands made the second
        # Lagrange reconstruction claim vacuous), plus the sorted BLS
        # message signatures and the shared cleartext so the verifier
        # re-runs every per-generation BLS verification from public data
        # (verify_generation_hashes, verification.rs:211-260).
        partial_bytes = b"".join(
            g1_compress(tuple(p)) for p in rel["partials"]
        )
        sigs, cleartext = rel.get("sigs"), rel.get("cleartext")
        if (
            sigs is None
            or cleartext is None
            or len(sigs) != n
            or any(len(s) != 96 for s in sigs)
            or len(cleartext) > MAX_CLEARTEXT
        ):
            raise Unprovable("missing BLS signature binding data")
        extras = (
            [KIND_IDS[kind], n, meta["k"]]
            + refs
            + list(partial_bytes)
            + list(b"".join(sigs))
            + [len(cleartext)]
            + list(cleartext)
        )
    else:  # partial
        n = meta["n"]
        if len(hashes) != n:
            raise Unprovable("stream hash count does not match n")
        refs = _sorted_gen_refs(sha_digests, hashes)
        perp_index = rel["perp_id"] - 1
        actual = rel["actual"]
        if actual is None:
            raise Unprovable("accused key is the identity")
        actual_bytes = g1_compress(actual)
        pshare_ref = 0
        if auth:
            for mi, orig in enumerate(sha_originals):
                f = _parse_partial_share_preimage(orig)
                if f is not None and f["partial_pubkey"] == actual_bytes:
                    pshare_ref = mi + 1
                    break
            if pshare_ref == 0:
                raise Unprovable("no partial-share preimage in the SHA table")
        msg_sig, cleartext = rel.get("msg_sig"), rel.get("cleartext")
        if (
            msg_sig is None
            or cleartext is None
            or len(msg_sig) != 96
            or len(cleartext) > MAX_CLEARTEXT
        ):
            raise Unprovable("missing BLS signature binding data")
        extras = (
            [KIND_IDS[kind], n, meta["k"], perp_index]
            + refs
            + [pshare_ref]
            + list(actual_bytes)
            + list(msg_sig)
            + [len(cleartext)]
            + list(cleartext)
        )
        if auth:
            cpk, csig = rel.get("commit_pubkey"), rel.get("commit_sig")
            if cpk is None or csig is None or len(cpk) != 33 or len(csig) != 64:
                raise Unprovable("missing ECDSA commitment credentials")
            extras += list(cpk) + list(csig)

    gadget = {
        "kind": "g1mul",
        "block_counts": list(chain_bits),
        "stream_offsets": [None],
        "extras": extras,
        "proof": None,  # filled by the pipeline
    }
    return gadget, (air, trace, publics)


def _sorted_gen_refs(sha_digests, hashes) -> List[int]:
    refs = []
    for h in sorted(hashes):
        ref = _find_digest_ref(sha_digests, h)
        if ref == 0:
            raise Unprovable("generation base-hash preimage missing from table")
        refs.append(ref)
    return refs


# ---------------------------------------------------------------------------
# Stream / preimage parsing (shared)
# ---------------------------------------------------------------------------


def _split_frames(stream: bytes) -> List[bytes]:
    """Length-prefixed frames (guest_api.GuestContext.commit framing)."""
    frames = []
    off = 0
    while off < len(stream):
        if off + 8 > len(stream):
            raise GlueError("truncated stream frame header")
        ln = int.from_bytes(stream[off : off + 8], "little")
        off += 8
        if off + ln > len(stream):
            raise GlueError("truncated stream frame")
        frames.append(stream[off : off + ln])
        off += ln
    return frames


def _hash_frames(frames: Sequence[bytes]) -> List[bytes]:
    """All frames but the last, decoded as 32-byte hex hashes."""
    hashes = []
    for fr in frames[:-1]:
        try:
            h = bytes.fromhex(fr.decode("ascii"))
        except (UnicodeDecodeError, ValueError):
            raise GlueError("malformed verification-hash frame") from None
        if len(h) != 32:
            raise GlueError("verification-hash frame has the wrong length")
        hashes.append(h)
    return hashes


def _parse_vv_preimage(msg: bytes) -> Optional[List[Tuple[int, int]]]:
    """Commitment-hash preimage (verification.rs:151-175): gen_id(16) ‖
    n(1) ‖ k(1) ‖ len(1) ‖ len × compressed pubkeys → decompressed points
    (None if the shape or any point is invalid, or any point is ∞)."""
    if len(msg) < 19:
        return None
    ln = msg[18]
    if ln == 0 or len(msg) != 19 + 48 * ln:
        return None
    out = []
    for j in range(ln):
        try:
            pt = bls.g1_from_compressed(msg[19 + 48 * j : 19 + 48 * (j + 1)])
        except bls.InvalidPoint:
            return None
        if pt is None:
            return None
        out.append((int(pt[0]), int(pt[1])))
    return out


def _parse_partial_share_preimage(msg: bytes) -> Optional[dict]:
    """Partial-share commitment preimage (verification.rs:334-362):
    gen_id(16) ‖ n ‖ k ‖ len ‖ vv(48·len) ‖ base_hash(32) ‖
    partial_pubkey(48) ‖ clen(1) ‖ cleartext ‖ signature(96)."""
    if len(msg) < 19:
        return None
    ln = msg[18]
    base = 19 + 48 * ln
    if len(msg) < base + 32 + 48 + 1:
        return None
    clen = msg[base + 80]
    if len(msg) != base + 81 + clen + 96:
        return None
    return {
        "prefix": msg[:19],
        "vv": msg[19:base],
        "base_hash": msg[base : base + 32],
        "partial_pubkey": msg[base + 32 : base + 80],
        "cleartext": msg[base + 81 : base + 81 + clen],
        "message_signature": msg[base + 81 + clen :],
    }


def g1_compress(pt: Tuple[int, int]) -> bytes:
    return bls.g1_to_compressed(pt)


# ---------------------------------------------------------------------------
# Verifier-side glue
# ---------------------------------------------------------------------------


def _chip_chain(air, publics, c) -> Tuple[bytes, Tuple[int, int], Point]:
    """(scalar bytes, operand, result point) of chain c from chip publics."""
    sb = air.scalar_bytes_of(publics, c)
    op = air.operand_of(publics, c)
    inf, x, y = air.result_of(publics, c)
    return sb, op, (None if inf else (x, y))


def _expect(cond: bool, msg: str) -> None:
    if not cond:
        raise GlueError(msg)


def _verify_horner(air, publics, c0, coeffs, id_val):
    """Check chains c0.. prove Horner(coeffs, id) and return (next chain
    index, final point)."""
    k = len(coeffs)
    if k == 1:
        return c0, coeffs[0]
    h: Point = coeffs[k - 1]
    c = c0
    for j in range(k - 2, -1, -1):
        sb, op, res = _chip_chain(air, publics, c)
        _expect(air.chain_bits[c] == ID_BITS, "horner chain width mismatch")
        _expect(sb == _scalar_bytes(id_val, ID_BITS), "horner scalar ≠ id")
        _expect(h is not None and op == h, "horner operand not chained")
        h = _add(res, coeffs[j])
        c += 1
    return c, h


def _load_gen_vectors(sha_air, sha_publics, refs, hashes, n):
    """The n sorted generations' verification vectors from SHA preimages."""
    import hashlib

    from ..stark.sha256_air import message_from_publics as _msg

    _expect(len(hashes) == n, "stream hash count ≠ n")
    _expect(len(refs) == n, "generation preimage ref count ≠ n")
    sorted_hashes = sorted(hashes)
    vvs = []
    prefix = None
    for i, ref in enumerate(refs):
        _expect(
            1 <= ref <= sha_air.num_messages, "generation preimage ref range"
        )
        try:
            msg = _msg(sha_air, sha_publics, ref - 1)
        except ValueError as e:
            raise GlueError(f"generation preimage: {e}") from None
        _expect(
            hashlib.sha256(msg).digest() == sorted_hashes[i],
            "generation preimage digest ≠ sorted base hash",
        )
        pts = _parse_vv_preimage(msg)
        _expect(pts is not None, "generation preimage unparseable")
        if prefix is None:
            prefix = msg[:19]
        else:
            _expect(msg[:19] == prefix, "generation settings differ")
        vvs.append(pts)
    _expect(all(len(vv) == len(vvs[0]) for vv in vvs), "ragged vectors")
    return vvs, sorted_hashes


def _bytes_of(extras: Sequence[int], lo: int, hi: int) -> bytes:
    if any(not 0 <= int(v) < 256 for v in extras[lo:hi]):
        raise GlueError("extras byte out of range")
    return bytes(int(v) for v in extras[lo:hi])


def _ecdsa_check(pubkey_bytes: bytes, digest: bytes, sig_bytes: bytes) -> None:
    """Re-run verify_commitment's ECDSA (verification.rs:365-374) on
    container-committed public data."""
    from ..hostcrypto import secp256k1 as secp

    try:
        pk = secp.pubkey_from_bytes(pubkey_bytes)
        sig = secp.sig_from_compact(sig_bytes)
    except Exception:
        raise GlueError("committed ECDSA credential does not parse") from None
    _expect(secp.verify(pk, digest, sig), "ECDSA commitment signature invalid")


def _bls_check(pk_point, h_point, sig_bytes: bytes) -> None:
    """Re-run one BLS verification e(pk, H(m)) = e(g1, sig)
    (bls_common.rs:26-40) on container-committed public data."""
    try:
        sig = bls.g2_from_compressed(sig_bytes)
    except bls.InvalidPoint:
        raise GlueError("committed BLS signature does not decompress") from None
    _expect(sig is not None, "committed BLS signature is the identity")
    _expect(
        bls.pairings_equal(pk_point, h_point, G1_GEN, sig),
        "BLS message signature invalid",
    )


def verify_gadget_glue(
    air,
    publics: Sequence[int],
    extras: Sequence[int],
    stream: bytes,
    sha_ctx,
    auth: bool,
    circuit_name: str,
) -> Tuple[str, int]:
    """Re-derive a g1mul gadget's statement host-side and check every chip
    public against it.  Returns (relation kind name, number of BLS/ECDSA
    signature verifications re-run from committed public data).  Raises
    GlueError on any mismatch.  (The chip STARK itself is verified by the
    caller.)"""
    import hashlib

    from ..stark.sha256_air import message_from_publics as _msg

    _expect(len(extras) >= 1, "empty g1mul extras")
    kind_id = int(extras[0])
    sig_checks = 0
    frames = _split_frames(stream)
    hashes = _hash_frames(frames)
    if sha_ctx is None:
        raise GlueError("g1mul gadget requires the SHA-256 table")
    sha_air, sha_publics = sha_ctx

    if kind_id == KIND_IDS["poly"]:
        _expect(circuit_name in ("bad-share", "bad-encrypted-share"),
                "poly relation in the wrong circuit")
        _expect(len(extras) == (4 + 97 if auth else 4), "poly extras malformed")
        _, k, seed_ref, init_ref = (int(v) for v in extras[:4])
        _expect(2 <= k <= 64, "poly k out of range")
        _expect(
            tuple(air.chain_bits) == (FULL_BITS,) + (ID_BITS,) * (k - 1),
            "poly chain structure mismatch",
        )
        _expect(1 <= init_ref <= sha_air.num_messages, "init ref range")
        try:
            init_msg = _msg(sha_air, sha_publics, init_ref - 1)
        except ValueError as e:
            raise GlueError(f"init preimage: {e}") from None
        pts = _parse_vv_preimage(init_msg)
        _expect(pts is not None and len(pts) == k, "init preimage unparseable")
        init_digest = hashlib.sha256(init_msg).digest()
        _expect(init_digest in hashes, "init digest not stream-committed")

        sb0, op0, pk = _chip_chain(air, publics, 0)
        _expect(op0 == G1_GEN, "chain 0 operand is not the generator")
        if auth:
            _expect(1 <= seed_ref <= sha_air.num_messages, "seed ref range")
            try:
                seed_msg = _msg(sha_air, sha_publics, seed_ref - 1)
            except ValueError as e:
                raise GlueError(f"seed preimage: {e}") from None
            _expect(len(seed_msg) == 96, "seed preimage shape")
            _expect(seed_msg[0:32] == init_digest, "hash chain broken")
            _expect(seed_msg[32:64] == sb0, "secret not seed-bound")
            dst = seed_msg[64:96]
            try:
                idx = sorted(hashes).index(dst)
            except ValueError:
                raise GlueError("dst hash not among committed hashes") from None
            id_val = idx + 1
            # Re-run verify_commitment (verification.rs:365-374) from the
            # committed ECDSA credentials: the commitment hash equals the
            # SHA-proven seed-exchange digest on every slashable path that
            # reaches the curve check (hash equality is checked by the
            # witness BEFORE evaluate_polynomial, verification.rs:90-99).
            _ecdsa_check(
                bytes(int(v) for v in extras[4:37]),
                hashlib.sha256(seed_msg).digest(),
                bytes(int(v) for v in extras[37:101]),
            )
            sig_checks += 1
        else:
            # no_auth: the id is committee-anchored (a valid sorted index);
            # the secret stays existential, as in the reference's own
            # no_auth SP1 proofs (verification.rs:30 auth-gating)
            sb1 = air.scalar_bytes_of(publics, 1)
            id_val = int.from_bytes(sb1, "big")
            _expect(1 <= id_val <= len(hashes), "id outside the committee")
        _, poly = _verify_horner(air, publics, 1, pts, id_val)
        _expect(pk != poly, "relation shows a VALID share — nothing to slash")
        return "poly", sig_checks

    if kind_id == KIND_IDS["agg"]:
        _expect(circuit_name == "finalization", "agg relation in the wrong circuit")
        _expect(len(extras) >= 3, "agg extras malformed")
        n, k = int(extras[1]), int(extras[2])
        _expect(2 <= n <= 64 and 1 <= k <= 64, "agg n/k out of range")
        base = 3 + n + 48 * n + 96 * n
        _expect(len(extras) >= base + 1, "agg extras malformed")
        clen = int(extras[base])
        _expect(0 <= clen <= MAX_CLEARTEXT, "agg cleartext length")
        _expect(len(extras) == base + 1 + clen, "agg extras malformed")
        refs = [int(v) for v in extras[3 : 3 + n]]
        pbytes = _bytes_of(extras, 3 + n, 3 + n + 48 * n)
        sig_bytes = _bytes_of(extras, 3 + n + 48 * n, base)
        cleartext = _bytes_of(extras, base + 1, base + 1 + clen)
        partials = []
        for i in range(n):
            try:
                pt = bls.g1_from_compressed(pbytes[48 * i : 48 * (i + 1)])
            except bls.InvalidPoint:
                raise GlueError("committed partial pubkey does not decompress") from None
            _expect(pt is not None, "committed partial pubkey is the identity")
            partials.append(tuple(pt))
        # re-run verify_generation_hashes' n BLS verifications
        # (verification.rs:211-260) on the committed partials/signatures:
        # ONE hash-to-curve of the shared cleartext + ONE batched pairing
        # check (random-linear-combination, bls_batch_verify_precomputed_hash);
        # per-signature fallback on failure for an exact error
        h_point = bls.hash_to_g2(cleartext)
        sig_pts = []
        for i in range(n):
            sb = sig_bytes[96 * i : 96 * (i + 1)]
            try:
                sp = bls.g2_from_compressed(sb)
            except bls.InvalidPoint:
                raise GlueError("committed BLS signature does not decompress") from None
            _expect(sp is not None, "committed BLS signature is the identity")
            sig_pts.append(tuple(sp))
        if not bls.bls_batch_verify_precomputed_hash(partials, sig_pts, h_point):
            for i in range(n):
                _expect(
                    bls.pairings_equal(partials[i], h_point, G1_GEN, sig_pts[i]),
                    f"BLS message signature {i} invalid",
                )
        sig_checks += n
        vvs, _sorted = _load_gen_vectors(sha_air, sha_publics, refs, hashes, n)
        _expect(len(vvs[0]) == k, "vector width ≠ k")
        try:
            agg_key = bls.g1_from_compressed(bytes.fromhex(frames[-1].decode("ascii")))
        except (bls.InvalidPoint, UnicodeDecodeError, ValueError):
            raise GlueError("malformed aggregate-key frame") from None
        avec = agg_vectors([[tuple(p) for p in vv] for vv in vvs])
        _expect(all(p is not None for p in avec), "aggregated vector has ∞")
        lam = lagrange_at_zero(list(range(1, n + 1)))
        c = 0
        computed = []
        for i in range(n):
            c, part = _verify_horner(air, publics, c, avec, i + 1)
            computed.append(part)
        sum_a: Point = None
        for i in range(n):
            sb, op, res = _chip_chain(air, publics, c)
            _expect(air.chain_bits[c] == FULL_BITS, "λ chain width")
            _expect(sb == _scalar_bytes(lam[i], FULL_BITS), "λ scalar mismatch")
            _expect(computed[i] is not None and op == computed[i],
                    "λ operand ≠ computed partial")
            sum_a = _add(sum_a, res)
            c += 1
        sum_b: Point = None
        for i in range(n):
            sb, op, res = _chip_chain(air, publics, c)
            _expect(air.chain_bits[c] == FULL_BITS, "λ chain width")
            _expect(sb == _scalar_bytes(lam[i], FULL_BITS), "λ scalar mismatch")
            _expect(op == partials[i],
                    "λ operand ≠ committed partial pubkey")
            sum_b = _add(sum_b, res)
            c += 1
        _expect(c == air.num_chains, "chain count mismatch")
        _expect(sum_a == (None if agg_key is None else tuple(agg_key)),
                "coefficient path ≠ aggregate key")
        _expect(sum_b == (None if agg_key is None else tuple(agg_key)),
                "partial-key path ≠ aggregate key")
        return "agg", sig_checks

    if kind_id == KIND_IDS["partial"]:
        _expect(circuit_name == "bad-partial-key", "partial relation in the wrong circuit")
        _expect(len(extras) >= 4, "partial extras malformed")
        n, k, perp_index = int(extras[1]), int(extras[2]), int(extras[3])
        _expect(2 <= n <= 64 and 2 <= k <= 64, "partial n/k out of range")
        base = 4 + n + 1 + 48 + 96
        _expect(len(extras) >= base + 1, "partial extras malformed")
        clen = int(extras[base])
        _expect(0 <= clen <= MAX_CLEARTEXT, "partial cleartext length")
        _expect(
            len(extras) == base + 1 + clen + (97 if auth else 0),
            "partial extras malformed",
        )
        refs = [int(v) for v in extras[4 : 4 + n]]
        pshare_ref = int(extras[4 + n])
        actual_bytes = _bytes_of(extras, 5 + n, 5 + n + 48)
        msg_sig = _bytes_of(extras, 5 + n + 48, 5 + n + 48 + 96)
        cleartext = _bytes_of(extras, base + 1, base + 1 + clen)
        vvs, sorted_hashes = _load_gen_vectors(
            sha_air, sha_publics, refs, hashes, n
        )
        _expect(len(vvs[0]) == k, "vector width ≠ k")
        _expect(0 <= perp_index < n, "perpetrator index range")
        perp_hash = sorted_hashes[perp_index]
        # last-match-wins (verification.rs:498-521)
        _expect(
            all(sorted_hashes[j] != perp_hash for j in range(perp_index + 1, n)),
            "perpetrator index is not the last match",
        )
        try:
            actual = bls.g1_from_compressed(actual_bytes)
        except bls.InvalidPoint:
            raise GlueError("accused key does not decompress") from None
        _expect(actual is not None, "accused key is the identity")
        if auth:
            _expect(1 <= pshare_ref <= sha_air.num_messages, "pshare ref range")
            try:
                pmsg = _msg(sha_air, sha_publics, pshare_ref - 1)
            except ValueError as e:
                raise GlueError(f"partial-share preimage: {e}") from None
            f = _parse_partial_share_preimage(pmsg)
            _expect(f is not None, "partial-share preimage unparseable")
            _expect(f["partial_pubkey"] == actual_bytes,
                    "accused key not bound to the commitment preimage")
            _expect(f["base_hash"] == perp_hash,
                    "perpetrator hash not bound to the commitment preimage")
            _expect(f["cleartext"] == cleartext,
                    "cleartext not bound to the commitment preimage")
            _expect(f["message_signature"] == msg_sig,
                    "message signature not bound to the commitment preimage")
            # re-run _verify_commitment_signature (verification.rs:468-496):
            # ECDSA over the SHA-proven partial-share commitment digest
            _ecdsa_check(
                _bytes_of(extras, base + 1 + clen, base + 1 + clen + 33),
                hashlib.sha256(pmsg).digest(),
                _bytes_of(extras, base + 1 + clen + 33, base + 1 + clen + 97),
            )
            sig_checks += 1
        # re-run the perpetrator's BLS message-signature check
        # (verification.rs:447) on committed public data
        _bls_check(tuple(actual), bls.hash_to_g2(cleartext), msg_sig)
        sig_checks += 1
        avec = agg_vectors([[tuple(p) for p in vv] for vv in vvs])
        _expect(all(p is not None for p in avec), "aggregated vector has ∞")
        c, expected = _verify_horner(air, publics, 0, avec, perp_index + 1)
        _expect(c == air.num_chains, "chain count mismatch")
        _expect(expected != tuple(actual),
                "expected key matches — nothing to slash")
        return "partial", sig_checks

    raise GlueError(f"unknown g1mul relation kind {kind_id}")
