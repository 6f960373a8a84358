"""Kernel tests that need a CUDA card (marker ``cuda``; they skip without
one).  This file imports only the port, so on a machine without jax it
runs with ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``."""

import hashlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dvt_circuits_tpu_torch import probe_vpu
from dvt_circuits_tpu_torch.curve import fp, g1, g2
from dvt_circuits_tpu_torch.hash import keccak
from dvt_circuits_tpu_torch.hash import poseidon2 as p2
from dvt_circuits_tpu_torch.hostcrypto import bls12_381 as host
from dvt_circuits_tpu_torch.stark import TEST_CONFIG, g1mul_air, prove_tables, verify
from dvt_circuits_tpu_torch.stark.airs import FibonacciAir
from dvt_circuits_tpu_torch.utils import spans

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 127, 129, 8192])
def test_poseidon2_kernel_matches_plain(card, n):
    x = np.random.default_rng(n).integers(0, p2.bb.P, (n, 16), dtype=np.int64)
    x[0] = p2.bb.P - 1
    t = torch.as_tensor(x, device=card)
    before = p2.poseidon2_permute.launches
    got = p2.poseidon2_permute(t)
    assert p2.poseidon2_permute.launches == before + 1
    assert torch.equal(got, p2.permute_plain(t))
    assert got[0].tolist() == p2.s_permute(x[0].tolist())


@pytest.mark.parametrize("n", [1, 300])
def test_keccak_kernel_matches_plain(card, n):
    y = torch.as_tensor(
        np.random.default_rng(n).integers(-(1 << 63), (1 << 63) - 1, (n, 25)), device=card
    )
    assert torch.equal(keccak.keccak_f1600(y), keccak.keccak_f1600_plain(y))
    for msgs in ([b""], [b"abc" * 50, b"xyz" * 50]):  # one length per batch
        assert keccak.sha3_256_batch(msgs) == [hashlib.sha3_256(m).digest() for m in msgs]


@pytest.mark.parametrize("n_blocks, n", [(1, 1), (3, 1), (1, 4096), (3, 4096)])
def test_keccak_sponge_kernel_matches_plain(card, n_blocks, n):
    blocks = torch.as_tensor(np.random.default_rng(n + n_blocks).integers(
        -(1 << 63), (1 << 63) - 1, (n_blocks, n, 17)), device=card)
    before = keccak.keccak_sponge.launches
    got = keccak.keccak_sponge(blocks)
    assert keccak.keccak_sponge.launches == before + 1
    assert torch.equal(got, keccak.keccak_sponge_plain(blocks))


def test_proof_on_card_equals_cpu_proof(card):
    trace = FibonacciAir.generate_trace(64)
    entry = [(FibonacciAir(), trace, FibonacciAir.public_values(trace))]
    assert prove_tables(entry, TEST_CONFIG, device=card) == prove_tables(
        entry, TEST_CONFIG, device="cpu"
    )


@pytest.mark.parametrize("n", [1, 4096])
def test_mulchain_kernel_matches_plain(card, n):
    x = np.random.default_rng(n).integers(0, 1 << 32, (19, n), dtype=np.int64)
    x[0], x[1], x[2] = 0, 1, (1 << 32) - 1
    t = torch.as_tensor(x, device=card)
    before = probe_vpu.mulchain.launches
    got = probe_vpu.mulchain(t)
    assert probe_vpu.mulchain.launches == before + 1
    assert torch.equal(got, probe_vpu.mulchain_plain(t))


def test_verifier_on_card_accepts_card_proof(card):
    trace = FibonacciAir.generate_trace(64)
    publics = FibonacciAir.public_values(trace)
    proof, = prove_tables([(FibonacciAir(), trace, publics)], TEST_CONFIG, device=card)
    before = p2.poseidon2_permute.launches
    assert verify(FibonacciAir(), proof, publics, TEST_CONFIG, device=card)
    assert p2.poseidon2_permute.launches > before
    assert verify(FibonacciAir(), proof, publics, TEST_CONFIG, device="cpu")


def _g1mul_chains(count, bits):
    rng = np.random.default_rng(count * bits)
    return [(rng.bytes(bits // 8), host.g1_mul(host.G1_GEN, int(rng.integers(2, 1 << 40))))
            for _ in range(count)]


@pytest.mark.parametrize("row_chunk", [None, 1000])
def test_g1mul_trace_on_card_equals_cpu(card, monkeypatch, row_chunk):
    """Three 256-bit chains: the trace assembled on the card equals the
    CPU's byte for byte; under a profiler session ``g1_trace_rows`` counts
    the table's rows and the reads bring back the trace and the checks'
    flags, no more."""
    if row_chunk:
        monkeypatch.setattr(g1mul_air, "ROW_CHUNK", row_chunk)
    chains = _g1mul_chains(3, 256)
    air = g1mul_air.G1MulAir((256,) * 3)
    want, want_pub = air.generate_trace(chains, device="cpu")
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("probe"):
            got, pub = air.generate_trace(chains, device=card)
    probe, = [r for r in spans.records() if r.name == "probe"]
    spans.clear()
    n = got.shape[0]
    assert got.dtype == np.uint32 and np.array_equal(got, want) and pub == want_pub
    assert probe.counters["g1_trace_rows"] == n == 8192
    trace_bytes = n * g1mul_air.WIDTH * 4
    assert trace_bytes <= probe.counters["d2h_bytes"] <= trace_bytes + len(g1mul_air._CHECKS)


def test_g1mul_trace_on_card_refuses_a_planted_quotient(card, monkeypatch):
    divmod_p = g1mul_air._divmod_p

    def planted(vals):
        q, r = divmod_p(vals)
        q = q.copy()
        q[1] += 1
        return q, r

    monkeypatch.setattr(g1mul_air, "_divmod_p", planted)
    with pytest.raises(AssertionError, match="mul witness"):
        g1mul_air.G1MulAir((256,) * 3).generate_trace(_g1mul_chains(3, 256), device=card)


def _k1c_launches(n):
    """Launches of K1c for n leaves: one per level of more than 128
    parents, one for the levels above."""
    count, n_out = 0, n // 2
    while n_out > 128:
        count, n_out = count + 1, n_out // 2
    return count + (n_out >= 1)


@pytest.mark.parametrize("n, lanes", [((1 << 14) - 1, 4), (1 << 14, 1), ((1 << 14) + 3, 1)])
def test_permute_kernel_lanes_match_plain(card, n, lanes):
    assert p2._lanes(n) == lanes  # each layout is reached through the batch size
    x = torch.as_tensor(np.random.default_rng(9).integers(0, p2.bb.P, (n, 16)), device=card)
    assert torch.equal(p2.poseidon2_permute(x), p2.permute_plain(x))


# (1 << 14) rows take one lane per row, the others 4
@pytest.mark.parametrize("rows, width", [(1, 1), (2, 7), (1024, 8), (1024, 9), (1024, 33),
                                         (1024, 4314), (1 << 12, 336), (1 << 14, 32),
                                         (1 << 14, 9)])
def test_sponge_kernel_matches_plain(card, rows, width):
    rng = np.random.default_rng(rows + width)
    m = torch.as_tensor(rng.integers(0, p2.bb.P, (rows, width)), device=card)
    before = p2.poseidon2_hash_rows.launches
    got = p2.poseidon2_hash_rows(m)
    assert p2.poseidon2_hash_rows.launches == before + 1
    assert torch.equal(got, p2.hash_rows_plain(m))
    wide = torch.as_tensor(rng.integers(0, p2.bb.P, (2 * rows, 2 * width + 1)), device=card)
    view = wide[::2, 1::2]  # (rows, width), row stride 4w + 2, column stride 2
    assert torch.equal(p2.poseidon2_hash_rows(view), p2.hash_rows_plain(view))


@pytest.mark.parametrize("n", [1, 2, 256, 1024, 1 << 14, 1 << 15])
def test_merkle_levels_kernel_matches_plain(card, n):
    leaves = torch.as_tensor(np.random.default_rng(n).integers(0, p2.bb.P, (n, 8)), device=card)
    buf = torch.empty((2 * n - 1, 8), dtype=torch.int64, device=card)
    buf[:n] = leaves
    want = buf.clone()
    p2.merkle_levels_plain(want, n)
    before = p2.poseidon2_merkle_levels.launches
    p2.poseidon2_merkle_levels(buf, n)
    assert p2.poseidon2_merkle_levels.launches == before + _k1c_launches(n)
    assert torch.equal(buf, want)


@pytest.mark.parametrize("pos", [0, 3, 7])
def test_grind_kernel_matches_plain(card, pos):
    # 2^16 candidates take one lane each; the short batches below, 4
    base = torch.as_tensor(np.random.default_rng(pos).integers(0, p2.bb.P, 16), device=card)
    want = p2.grind_plain(base, pos, 12, 0, 1 << 16)
    before = p2.poseidon2_grind.launches
    assert p2.poseidon2_grind(base, pos, 12, 0, 1 << 16) == want
    assert p2.poseidon2_grind.launches == before + 1
    assert want is not None
    assert p2.poseidon2_grind(base, pos, 12, 0, want) is None
    assert p2.poseidon2_grind(base, pos, 12, max(want - 5, 0), 11) == want


def test_sponge_and_tree_past_2_31_elements(card):
    """K1b and K1c at the 9-of-13 finalization's g1mul LDE, (2^19, 4,314):
    2.26e9 elements, so the flat index passes 2^31 inside row 497,794."""
    from dvt_circuits_tpu_torch.pcs.merkle import build_tree

    n, w = 1 << 19, 4314
    row = (1 << 31) // w
    assert row == 497_794 and row * w < 1 << 31 < (row + 1) * w
    gen = torch.Generator(device=card).manual_seed(19)
    m = torch.randint(0, p2.bb.P, (n, w), dtype=torch.int64, device=card, generator=gen)
    leaves = p2.poseidon2_hash_rows(m)
    rows = torch.tensor([0, 1, row - 1, row, row + 1, n - 1], device=card)
    assert torch.equal(leaves[rows], p2.hash_rows_plain(m[rows]))
    tree = build_tree(m)
    del m
    assert torch.equal(tree[:n], leaves)
    buf = torch.empty((2 * n - 1, 8), dtype=torch.int64, device=card)
    buf[:n] = leaves
    p2.merkle_levels_plain(buf, n)
    assert torch.equal(tree[-1], buf[-1])


def test_open_many_on_card_equals_cpu(card):
    """A batch of openings gathered on the card, at the 3-of-4 g1mul
    table's (2^14, 4,314), equals the batch gathered from a CPU copy."""
    from dvt_circuits_tpu_torch.pcs.merkle import MerkleTree, merkle_root

    n, w = 1 << 14, 4314
    m = torch.as_tensor(np.random.default_rng(14).integers(0, p2.bb.P, (n, w)))
    lo = np.random.default_rng(4314).integers(0, n // 2, 40)
    indices = [int(i) for li in lo for i in (li, li + n // 2)] + [0, n - 1, int(lo[0])]
    on_card, on_cpu = MerkleTree(m.to(card)), MerkleTree(m)
    for got, want in zip(on_card.open_many(indices), on_cpu.open_many(indices)):
        assert got.dtype == want.dtype == np.uint32 and np.array_equal(got, want)
    assert on_card.root == on_cpu.root == merkle_root(m.to(card))


# n = tiles * kTile + extra: one product, a tile less one, a tile and one,
# 1,000, and 2^16 + 3 over many tiles; each also on views whose rows start 8
# bytes off a 16-byte boundary (the wrapper copies them for the bulk copies)
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("tiles, extra", [(0, 1), (1, -1), (1, 1), (0, 1000), (0, 65539)],
                         ids=["1", "T-1", "T+1", "1000", "65539"])
def test_fp_mont_mul_kernel_matches_plain(card, tiles, extra, misaligned):
    n = tiles * fp._library().fp_mont_mul_tile() + extra
    rng = np.random.default_rng(n)
    vals = [int.from_bytes(rng.bytes(48), "big") % host.P for _ in range(min(n, 1000))]
    vals = (vals * (n // len(vals) + 1))[:n] + [0, 1, host.P - 1, host.P - 2]
    a = torch.as_tensor(np.stack([fp.int_to_limbs(v) for v in vals]), device=card)
    b = a.flip(0)
    want = fp.mont_mul_plain(a, b)
    if misaligned:
        views = []
        for x in (a, b):
            view = torch.empty(x.numel() + 1, dtype=torch.int64, device=card)[1:].view(x.shape)
            view.copy_(x)
            assert view.data_ptr() % 16 == 8
            views.append(view)
        a, b = views
    before = fp.mont_mul.launches
    got = fp.mont_mul(a, b)
    assert fp.mont_mul.launches == before + 1
    assert torch.equal(got, want)


def _edge_batch(rng):
    """Zero scalars, identity points, a repeated point and a P / -P pair."""
    pts = [host.g1_mul(host.G1_GEN, 7 * i + 3) for i in range(4)]
    points = [None, pts[0], pts[1], pts[1], pts[2], host.g1_neg(pts[2]), pts[3], host.G1_GEN]
    scalars = [5, 0, 7, 7, 11, 11, int.from_bytes(rng.bytes(32), "big") % host.R, host.R - 1]
    want = None
    for p, s in zip(points, scalars):
        want = host.g1_add(want, host.g1_mul(p, s) if p else None)
    return points, scalars, want


def test_g1_msm_windowed_kernel_matches_plain(card):
    points, scalars, want = _edge_batch(np.random.default_rng(1))
    p = g1.from_affine_points(points, card)
    digits = g1.scalars_to_digits(scalars, card)
    before = g1.msm_jacobian.launches
    got = g1.msm_jacobian(p, digits)
    assert g1.msm_jacobian.launches == before + 1
    # the kernel pairs the additions as the JAX tree does: the same limbs
    for a, b in zip(got, g1.msm_plain(p, digits)):
        assert torch.equal(a, b)
    assert g1.msm(points, scalars, device=card) == want


def _skewed_batch(batch: str, rng):
    """Batches that skew C3's buckets: every scalar equal, scalars below 2^16,
    every point equal, P beside -P; with the host oracle's sum."""
    pts = [host.g1_mul(host.G1_GEN, 7 * i + 3) for i in range(8)]
    scalar = int.from_bytes(rng.bytes(32), "big") % host.R
    if batch == "equal-scalars":
        points, scalars = pts, [scalar] * 8
    elif batch == "small-scalars":
        points, scalars = pts, [int(v) for v in rng.integers(0, 1 << 16, 8)]
    elif batch == "equal-points":
        points, scalars = [pts[1]] * 8, [scalar] * 4 + [scalar + i for i in range(4)]
    else:
        points = [q for p in pts[:4] for q in (p, host.g1_neg(p))]
        scalars = [5, 5, 7, 7, 9, 8, scalar, scalar]
    want = None
    for p, s in zip(points, scalars):
        want = host.g1_add(want, host.g1_mul(p, s))
    return points, scalars, want


@pytest.mark.parametrize("window_bits", [2, 4, 8])
@pytest.mark.parametrize("batch", ["edge", "equal-scalars", "small-scalars", "equal-points",
                                   "p-and-minus-p"])
def test_g1_msm_bucket_kernel_matches_host(card, window_bits, batch):
    rng = np.random.default_rng(window_bits)
    points, scalars, want = (_edge_batch(rng) if batch == "edge"
                             else _skewed_batch(batch, rng))
    counters = [g1.msm_bucket_jacobian, *g1.stage_counts.values()]
    before = [c.launches for c in counters]
    assert g1.msm_bucket(points, scalars, window_bits, device=card) == want
    # one call of the wrapper, one launch of each stage C3a-C3d
    assert [c.launches for c in counters] == [n + 1 for n in before]
    p, digits = g1.bucket_inputs(points, scalars, window_bits, card)
    got = g1.msm_bucket_jacobian(p, digits, window_bits)
    again = g1.msm_bucket_jacobian(p, digits, window_bits)
    # the kernel adds in the staged plain version's order: the same limbs,
    # and the same in every run
    for a, b, c in zip(got, again, g1.msm_bucket_plain(p, digits, window_bits)):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("copies", [40, 1000])
def test_g1_msm_bucket_kernel_joins_many_partials(card, copies):
    """One bucket a window spans many of C3b's chunks: its partials go
    through a tree of several levels, joined across blocks."""
    points, scalars, want = _skewed_batch("equal-scalars", np.random.default_rng(copies))
    points, scalars = points * copies, scalars * copies
    p, digits = g1.bucket_inputs(points, scalars, 4, card)
    got = g1.msm_bucket_jacobian(p, digits, 4)
    for a, b in zip(got, g1.msm_bucket_plain(p, digits, 4)):
        assert torch.equal(a, b)
    assert g1.to_affine_points(tuple(c[None] for c in got))[0] == host.g1_mul(want, copies)


def test_g2_scalar_mul_kernel_matches_plain(card):
    rng = np.random.default_rng(4)
    points = [host.g2_mul(host.G2_GEN, k) for k in (3, 7)] + [None]
    scalars = [int.from_bytes(rng.bytes(32), "big") % host.R for _ in range(2)] + [5]
    p = g2.from_host_points(points, card)
    bits = g1.scalars_to_bits(scalars, card)
    before = g2.scalar_mul.launches
    got = g2.scalar_mul(p, bits)
    assert g2.scalar_mul.launches == before + 1
    for a, b in zip(got, g2.scalar_mul_plain(p, bits)):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert g2.to_host_points(got) == [host.g2_mul(q, s) if q else None
                                      for q, s in zip(points, scalars)]


def _cpu(t):
    return tuple(_cpu(c) for c in t) if isinstance(t, tuple) else t.cpu()


def _limbs_equal(a, b) -> bool:
    if isinstance(a, tuple):
        return all(_limbs_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a.cpu(), b.cpu())


# C2 runs 4 lanes a point, 8 points a warp and a block, then a launch a level
# of the tree: n = 1 (no level), odd n (a point moved up a level), n that
# is not a multiple of the 8 points a block (groups past n run on the
# identity), all-zero digits, an identity, and digits that differ between
# the points of a warp
@pytest.mark.parametrize("case", ["n=1", "n=5", "n=13", "zero-digits", "identity", "mixed-warp"])
def test_g1_msm_windowed_kernel_edge_shapes(card, case):
    rng = np.random.default_rng(len(case))
    n = {"n=1": 1, "n=5": 5, "n=13": 13}.get(case, 8)
    points = [host.g1_mul(host.G1_GEN, int(k)) for k in rng.integers(2, 1 << 40, n)]
    scalars = [int.from_bytes(rng.bytes(32), "big") % host.R for _ in range(n)]
    if case == "zero-digits":
        scalars = [0] * n
    if case == "identity":
        points[3] = None
    if case == "mixed-warp":  # four points of one warp: 0, 1, R - 1 and a random scalar
        scalars[:4] = [0, 1, host.R - 1, scalars[3]]
    p = g1.from_affine_points(points, card)
    digits = g1.scalars_to_digits(scalars, card)
    before = g1.msm_jacobian.launches
    got = g1.msm_jacobian(p, digits)
    again = g1.msm_jacobian(p, digits)
    assert g1.msm_jacobian.launches == before + 2
    assert _limbs_equal(got, again)
    assert _limbs_equal(got, g1.msm_plain(_cpu(p), digits.cpu()))
    want = None
    for q, s in zip(points, scalars):
        want = host.g1_add(want, host.g1_mul(q, s) if q else None)
    assert g1.to_affine_points(tuple(c[None] for c in got))[0] == want


# C4 runs a warp a point: n = 1, then the identity, all-zero bits, the
# scalars R - 1 and 1 and random scalars side by side
@pytest.mark.parametrize("n", [1, 6])
def test_g2_scalar_mul_kernel_edge_shapes(card, n):
    rng = np.random.default_rng(n)
    points = [host.g2_mul(host.G2_GEN, k) for k in (3, 5, 7, 9, 11)][:n] + [None] * (n - 5)
    scalars = [int.from_bytes(rng.bytes(32), "big") % host.R, 0, host.R - 1, 1, 77, 12345][:n]
    p = g2.from_host_points(points, card)
    bits = g1.scalars_to_bits(scalars, card)
    before = g2.scalar_mul.launches
    got = g2.scalar_mul(p, bits)
    again = g2.scalar_mul(p, bits)
    assert g2.scalar_mul.launches == before + 2
    assert _limbs_equal(got, again)
    # the plain version on the CPU (the same ops; on the card it launches
    # tens of thousands of small kernels)
    assert _limbs_equal(got, g2.scalar_mul_plain(_cpu(p), bits.cpu()))
    assert g2.to_host_points(got) == [host.g2_mul(q, k) if q else None
                                      for q, k in zip(points, scalars)]


def _stream_entry():
    from dvt_circuits_tpu_torch.stark.poseidon2_air import Poseidon2StreamAir, stream_to_words

    frames = [bytes.fromhex("ab" * 32).hex().encode()] * 3 + [b"99" * 48]
    words = stream_to_words(b"".join(len(f).to_bytes(8, "little") + f for f in frames))
    air = Poseidon2StreamAir(max(1, -(-len(words) // 8)))
    return (air, *air.generate_trace(words))


def _rank_sharded(rank, world, points, scalars):
    """One NCCL rank: the stream table sharded over every card, then
    ``dist_msm`` over them, each with its kernels' launches."""
    from dvt_circuits_tpu_torch.parallel.dist_stark import dist_prove
    from dvt_circuits_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh({"sp": world}, "cuda")
    before = p2.poseidon2_hash_rows.launches
    proof = dist_prove(*_stream_entry(), TEST_CONFIG, mesh)
    sponge = p2.poseidon2_hash_rows.launches - before
    before = g1.msm_jacobian.launches
    msm = g1.dist_msm(points, scalars, mesh)
    return proof, sponge, msm, g1.msm_jacobian.launches - before


def test_sharded_stream_table_and_dist_msm_on_every_card(card):
    from dvt_circuits_tpu_torch.parallel.mesh import spawn
    from dvt_circuits_tpu_torch.pcs.challenger import DuplexChallenger
    from dvt_circuits_tpu_torch.stark.prover import prove

    rng = np.random.default_rng(7)
    points = [host.g1_mul(host.G1_GEN, int(k)) for k in rng.integers(1, 1 << 30, 64)]
    scalars = [int.from_bytes(rng.bytes(32), "big") % host.R for _ in range(64)]
    world = torch.cuda.device_count()
    ranks = spawn(_rank_sharded, world, backend="nccl", device="cuda", timeout=600,
                  args=(points, scalars))
    want = prove(*_stream_entry(), TEST_CONFIG, DuplexChallenger("cpu"))
    msm = g1.msm(points, scalars, device="cpu")
    for proof, sponge, got, c2 in ranks:
        assert proof == want
        assert sponge > 0 and c2 == 1
        assert got == msm
