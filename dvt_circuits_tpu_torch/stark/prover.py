"""Uni-STARK phase prover (DEEP-ALI + batched FRI) on PyTorch tensors.

Port of ``dvt_circuits_tpu/stark/prover.py`` (phase bodies) with the
transcript of ``stark/host_prover.py`` / ``stark/fused.py``:

  trace → column LDEs (NTT) → Merkle commit → α-folded constraint quotient
  → chunked quotient commit → openings at ζ, g·ζ → γ-batched DEEP
  codeword → FRI commit/fold/grind/query.

``prove`` is the one statement of the protocol: the input checks, the
transcript's order, the phases with their spans and the proof dict.  It
takes a layout, which says where each matrix's rows live and how it is
committed and opened: ``OneCard`` (the default: every matrix whole on one
device) or the sharded prover's ``parallel.dist_stark.RowBlocks``; this
package imports nothing of ``parallel/``.  Arrays are int64 standard-form
tensors; the Fiat–Shamir transcript is the host-side ``DuplexChallenger``
whose permutations run on the prover's device.  Constraint evaluation
takes an AIR's ``eval_tensor`` where it has one (``TensorBuilder``: whole
(rows, m) constraint groups over row chunks of the LDE domain, as the
reference's prover does), else drives its generic ``eval`` with a column
algebra (``ProverBuilder``: every builder value is a full LDE column).
No phase copies a whole LDE matrix to read the next row.  The proof dict
is in exactly the format of the JAX provers (``stark/fused.py:598-624``).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from ..field import babybear as bb
from ..field import ext
from ..ntt.ntt import coeffs_to_coset_evals, coset_evals_to_coeffs, coset_lde
from ..pcs.challenger import DuplexChallenger
from ..pcs.fri import OneCardFri, fri_prove
from ..pcs.merkle import MerkleTree, merkle_root
from ..utils import spans
from ..utils.packing import pack_u32
from .air import Air, AirBuilder
from .config import StarkConfig

P = bb.P

#: columns folded per batch: (rows, k, 4) products, each reduced before
#: the k-term sum (k·p < 2⁶³ for any k below 2³²)
_FOLD_BATCH = 128


def _fold_into(acc: torch.Tensor, mat: torch.Tensor, coeffs: torch.Tensor) -> None:
    """acc (rows, 4) += Σⱼ coeffsⱼ·mat[:, j] for base-field columns ``mat``
    (rows or 1, m) and BB4 ``coeffs`` (m, 4), _FOLD_BATCH columns at a time;
    acc is left reduced."""
    rows = acc.shape[0]
    for s in range(0, mat.shape[1], _FOLD_BATCH):
        part = mat[:, s : s + _FOLD_BATCH].expand(rows, -1)
        acc += (part[:, :, None] * coeffs[None, s : s + _FOLD_BATCH] % P).sum(dim=1)
    acc %= P


@lru_cache(maxsize=None)
def _domain_tables(log_n: int, log_blowup: int, shift: int, device: torch.device) -> dict:
    """LDE-domain tables: x, 1/Z_H and the first/last/transition selectors."""
    n = 1 << log_n
    n_lde = n << log_blowup
    x = bb.powers(bb.two_adic_generator(log_n + log_blowup), n_lde, device, start=shift)
    # Z_H(x_i) = shift^N·ω_b^i − 1, period `blowup` in i
    w_b = bb.two_adic_generator(log_blowup) if log_blowup else 1
    s_n = pow(shift, n, P)
    zh_short = [(s_n * pow(w_b, i, P) - 1) % P for i in range(1 << log_blowup)]
    zh = torch.tensor(zh_short, dtype=torch.int64, device=device).repeat(n)
    zh_inv = torch.tensor([bb.s_inv(z) for z in zh_short], dtype=torch.int64,
                          device=device).repeat(n)
    g_last = pow(bb.two_adic_generator(log_n), n - 1, P)
    transition = (x - g_last) % P
    return dict(
        x=x,
        zh_inv=zh_inv,
        first=zh * bb.inv((x - 1) % P) % P,
        last=zh * bb.inv(transition) % P,
        transition=transition,
    )


class ProverBuilder(AirBuilder):
    """AirBuilder whose values are (n_lde,) int64 LDE columns (or Python
    ints for constants and publics); folds Σ αⁱ·cᵢ into a (n_lde, 4) BB4
    accumulator in emission order."""

    P = P

    def __init__(self, t, nxt, pre, pre_nxt, publics, sels, alpha):
        self._t = t
        self._n = nxt
        self._p = pre
        self._pn = pre_nxt
        self._pub = publics
        self._sels = sels
        self._alpha = tuple(alpha)
        self._alpha_pow = ext.S_ONE
        self._pending: list = []
        self._coeffs: list = []
        self._acc = t.new_zeros((t.shape[0], ext.D))
        self.count = 0

    def _local(self, j):
        return self._t[:, j]

    def _next(self, j):
        return self._n[:, j]

    def _pre(self, j):
        return self._p[:, j]

    def _pre_next(self, j):
        return self._pn[:, j]

    def _public(self, i):
        return self._pub[i]

    def _const(self, c):
        return c % P

    def _add(self, a, b):
        return (a + b) % P

    def _sub(self, a, b):
        return (a - b) % P

    def _mul(self, a, b):
        return a * b % P

    def _sel_first(self):
        return self._sels["first"]

    def _sel_last(self):
        return self._sels["last"]

    def _sel_transition(self):
        return self._sels["transition"]

    def _accumulate(self, expr):
        self._pending.append(expr)
        self._coeffs.append(self._alpha_pow)
        self._alpha_pow = ext.s_mul(self._alpha_pow, self._alpha)
        self.count += 1
        if len(self._pending) == _FOLD_BATCH:
            self._flush()

    def _flush(self):
        if not self._pending:
            return
        n = self._acc.shape[0]
        cols = [
            e.expand(n) if isinstance(e, torch.Tensor) else self._acc.new_full((n,), int(e))
            for e in self._pending
        ]
        coeffs = torch.tensor(self._coeffs, dtype=torch.int64, device=self._acc.device)
        _fold_into(self._acc, torch.stack(cols, dim=1), coeffs)
        self._pending.clear()
        self._coeffs.clear()

    def finalize(self) -> torch.Tensor:
        """Σ αⁱ·cᵢ over every constraint → (n_lde, 4)."""
        self._flush()
        return self._acc


class _AlphaPowers:
    """[α⁰, α¹, …] as a (k, 4) tensor that grows on demand (at least
    doubling; the powers computed on the host, as ``ProverBuilder`` does, and
    copied over once per growth), shared by the row chunks of one quotient."""

    def __init__(self, alpha, device):
        self._alpha = tuple(alpha)
        self._device = device
        self._host = [ext.S_ONE]
        self._table = None

    def __call__(self, off: int, m: int) -> torch.Tensor:
        if self._table is None or self._table.shape[0] < off + m:
            k = max(off + m, 2 * len(self._host))
            while len(self._host) < k:
                self._host.append(ext.s_mul(self._host[-1], self._alpha))
            self._table = torch.tensor(self._host, dtype=torch.int64, device=self._device)
        return self._table[off : off + m]


class TensorBuilder:
    """Builder of ``Air.eval_tensor`` over a block of LDE rows: the AIR emits
    whole (rows, m) constraint tensors (or (rows,) for one constraint), and
    ``assert_group`` folds each at once into the (rows, 4) accumulator with
    the next m consecutive α powers: the α-power order is that of ``eval``
    (the reference concatenates its groups and folds once,
    ``dvt_circuits_tpu/stark/prover.py:158-186``; the values are the same).
    Values are int64 standard form; ``publics`` is an int64 tensor on the
    rows' device."""

    def __init__(self, t, nxt, pre, pre_nxt, publics, sels, alpha_pows: _AlphaPowers):
        self.local = t
        self.next = nxt
        self.pre = pre
        self.pre_next = pre_nxt
        self.publics = publics
        self.sel_first = sels["first"]
        self.sel_last = sels["last"]
        self.sel_transition = sels["transition"]
        self._alpha_pows = alpha_pows
        self.acc = t.new_zeros((t.shape[0], ext.D))
        self.count = 0

    def assert_group(self, tensor: torch.Tensor) -> None:
        if tensor.dim() == 1:
            tensor = tensor[:, None]
        m = tensor.shape[1]
        _fold_into(self.acc, tensor, self._alpha_pows(self.count, m))
        self.count += m


#: bytes of one (rows, trace width) int64 matrix in a row chunk of the tensor
#: quotient; the widest constraint group keeps a few such temporaries alive
_QUOTIENT_CHUNK_BYTES = 1 << 30


def quotient_chunk_rows(width: int, n_lde: int) -> int:
    """Rows per chunk of the tensor quotient: the largest power of two whose
    (rows, width) int64 matrix fits ``_QUOTIENT_CHUNK_BYTES``, at most n_lde."""
    rows = max(1, _QUOTIENT_CHUNK_BYTES // (8 * max(width, 1)))
    return min(n_lde, 1 << (rows.bit_length() - 1))


def _rows_at(mat: torch.Tensor, r0: int, r1: int, shift: int, halo=None) -> torch.Tensor:
    """Rows r + shift for r in [r0, r1): a view unless they run past the
    last row.  Past it they continue into ``halo`` (the ``shift`` rows that
    follow ``mat``, a row block's cyclic successor) or, without one, wrap to
    the first rows by an index gather of those rows alone."""
    n = mat.shape[0]
    if r1 + shift <= n:
        return mat[r0 + shift : r1 + shift]
    if halo is not None:
        return torch.cat([mat[min(r0 + shift, n) :], halo[max(r0 + shift - n, 0) : r1 + shift - n]])
    idx = (torch.arange(r0, r1, device=mat.device) + shift) % n
    return mat.index_select(0, idx)


def _tensor_constraints(air: Air, t_lde, p_lde, alpha, publics, tables, blowup: int,
                        halos=(None, None)):
    """Σ αⁱ·cᵢ over every constraint of ``air.eval_tensor``, evaluated over
    row chunks of the LDE rows → ((rows, 4), constraint count).  ``halos``:
    the rows that follow the trace and preprocessed blocks (``_rows_at``)."""
    n_lde = t_lde.shape[0]
    chunk_rows = quotient_chunk_rows(air.width, n_lde)
    dev = t_lde.device
    pub = torch.tensor(publics or [0], dtype=torch.int64, device=dev)
    pows = _AlphaPowers(alpha, dev)
    acc = t_lde.new_empty((n_lde, ext.D))
    count = None
    for r0 in range(0, n_lde, chunk_rows):
        r1 = min(n_lde, r0 + chunk_rows)
        sels = {k: tables[k][r0:r1] for k in ("first", "last", "transition")}
        tb = TensorBuilder(t_lde[r0:r1], _rows_at(t_lde, r0, r1, blowup, halos[0]),
                           p_lde[r0:r1], _rows_at(p_lde, r0, r1, blowup, halos[1]), pub,
                           sels, pows)
        air.eval_tensor(tb)
        acc[r0:r1] = tb.acc
        count = tb.count
    return acc, count


# ---------------------------------------------------------------------------
# Phase bodies
# ---------------------------------------------------------------------------


def lde_body(mat: torch.Tensor, config: StarkConfig) -> torch.Tensor:
    """(n, w) trace columns → their coset LDE (n·blowup, w)."""
    return coset_lde(mat, config.log_blowup, config.shift)


def constraint_fold(air: Air, t_lde, p_lde, alpha, publics, tables, blowup: int,
                    halos=(None, None)):
    """Σ αⁱ·cᵢ over every constraint at each LDE row → ((rows, 4), count).

    An AIR with ``eval_tensor`` is evaluated through ``TensorBuilder`` over
    row chunks of ``quotient_chunk_rows`` rows (the result does not depend
    on it); any other AIR drives its generic ``eval`` through
    ``ProverBuilder``.  The rows may be a block of the domain: ``halos``
    then holds the ``blowup`` rows that follow each matrix (None: the
    matrices are the whole domain, and the next rows wrap)."""
    if getattr(air, "eval_tensor", None):
        return _tensor_constraints(air, t_lde, p_lde, alpha, publics, tables, blowup, halos)

    def nxt(mat, halo):
        if halo is None:
            return torch.roll(mat, -blowup, dims=0)
        return torch.cat([mat[blowup:], halo])

    pre_nxt = nxt(p_lde, halos[1]) if air.preprocessed_width else p_lde
    builder = ProverBuilder(t_lde, nxt(t_lde, halos[0]), p_lde, pre_nxt, publics, tables, alpha)
    air.eval(builder)
    return builder.finalize(), builder.count


def quotient_chunks(quotient: torch.Tensor, log_n: int, config: StarkConfig):
    """The (n_lde, 4) quotient's chunked commitment matrix: chunk k holds
    coefficients [k·n, (k+1)·n), one BB4 column group each, and the chunk
    LDEs are independent columns of one transform.  Returns (q_matrix
    (n_lde, 4·blowup), q_col_coeffs (n, 4·blowup))."""
    n = 1 << log_n
    q_coeffs = coset_evals_to_coeffs(quotient, config.shift)
    q_col_coeffs = torch.cat([q_coeffs[k * n : (k + 1) * n] for k in range(config.blowup)], dim=1)
    q_matrix = coeffs_to_coset_evals(q_col_coeffs, config.log_blowup, config.shift)
    return q_matrix, q_col_coeffs


def quotient_body(air: Air, t_lde, p_lde, alpha, publics, tables, log_n: int,
                  config: StarkConfig):
    """Constraint quotient and its chunked commitment matrix.  Returns
    (q_matrix (n_lde, 4·blowup), q_col_coeffs (n, 4·blowup), constraint
    count)."""
    folded, count = constraint_fold(air, t_lde, p_lde, alpha, publics, tables, config.blowup)
    quotient = ext.mul_base(folded, tables["zh_inv"])  # (n_lde, 4)
    return (*quotient_chunks(quotient, log_n, config), count)


def cols_at(coeffs: torch.Tensor, point) -> torch.Tensor:
    """(n, w) coefficient columns at a BB4 point → (w, 4) int64 values."""
    pw = ext.powers(point, coeffs.shape[0], coeffs.device)  # (n, 4)
    return torch.stack(
        [(coeffs * pw[:, c : c + 1] % P).sum(dim=0) % P for c in range(ext.D)], dim=1
    )


def _eval_cols_at(coeffs: torch.Tensor, point) -> np.ndarray:
    """(n, w) coefficient columns at a BB4 point → (w, 4) uint32 values."""
    vals = cols_at(coeffs, point)
    spans.host_read(vals)
    return vals.cpu().numpy().astype(np.uint32)


def coeffs_head(lde: torch.Tensor, shift: int, n: int) -> torch.Tensor:
    """The first n coefficients of LDE columns over shift·K; they alone stay
    alive (the transform's buffer is as large as the LDE)."""
    return coset_evals_to_coeffs(lde, shift)[:n].clone()


def openings_body(air: Air, t_lde, p_lde, q_col_coeffs, zeta, gzeta, log_n: int,
                  config: StarkConfig) -> dict:
    """Openings of trace, quotient and preprocessed columns at ζ and g·ζ."""
    n = 1 << log_n
    t_coeffs = coeffs_head(t_lde, config.shift, n)
    out = {
        "t_zeta": _eval_cols_at(t_coeffs, zeta),
        "t_gzeta": _eval_cols_at(t_coeffs, gzeta),
        "q_zeta": _eval_cols_at(q_col_coeffs, zeta),
    }
    if air.preprocessed_width:
        p_coeffs = coeffs_head(p_lde, config.shift, n)
        out["p_zeta"] = _eval_cols_at(p_coeffs, zeta)
        out["p_gzeta"] = _eval_cols_at(p_coeffs, gzeta)
    return out


def preprocessed_commitment(air: Air, log_n: int, config: StarkConfig, device):
    """Verifying-key material: the Merkle root of the AIR's preprocessed
    columns' LDE at 2^log_n rows (None without preprocessed columns)."""
    if not air.preprocessed_width:
        return None
    pre = np.asarray(air.preprocessed_trace(1 << log_n), dtype=np.int64)
    return merkle_root(lde_body(torch.as_tensor(pre, device=device), config))


def opened_digest_std(opened: dict, device) -> list:
    """Merkle digest (8 words) of a table's opened values, rows in the
    γ-power order p@ζ, p@gζ, t@ζ, t@gζ, q@ζ, zero-padded to a power of two
    (``dvt_circuits_tpu/stark/prover.py:opened_digest_std``)."""
    names = ("p_zeta", "p_gzeta", "t_zeta", "t_gzeta", "q_zeta")
    rows = np.concatenate([opened[k] for k in names if k in opened]).astype(np.int64)
    m = rows.shape[0]
    target = 1 << max(0, m - 1).bit_length()
    rows = np.concatenate([rows, np.zeros((target - m, ext.D), dtype=np.int64)])
    return merkle_root(torch.as_tensor(rows, device=device))


def deep_body(air: Air, t_lde, p_lde, q_matrix, opened: dict, zeta, gzeta, gamma,
              tables, config: StarkConfig) -> torch.Tensor:
    """G = Σᵢ γⁱ(colᵢ − oᵢ)/(x − ptᵢ), grouped by opening point; γ-power
    order p@ζ, p@gζ, t@ζ, t@gζ, q@ζ (the verifier's)."""
    width = air.width
    pre_width = air.preprocessed_width
    dev = t_lde.device
    n_lde = t_lde.shape[0]
    total = 2 * pre_width + 2 * width + 4 * config.blowup
    gp = ext.powers(gamma, total, dev)  # (total, 4)
    x4 = ext.from_base(tables["x"])
    inv_z = ext.inv(ext.sub(x4, ext.tensor(zeta, dev)))
    inv_gz = ext.inv(ext.sub(x4, ext.tensor(gzeta, dev)))

    def fold_group(parts, inv_den):
        num = t_lde.new_zeros((n_lde, ext.D))
        o_fold = t_lde.new_zeros((ext.D,))
        for mat, vals, off in parts:
            coeff = gp[off : off + mat.shape[1]]  # (m, 4)
            _fold_into(num, mat, coeff)
            o = torch.as_tensor(vals.astype(np.int64), device=dev)
            o_fold += ext.mul(coeff, o).sum(dim=0)
        num = ext.sub(num, o_fold % P)
        return ext.mul(num, inv_den)

    z_parts, gz_parts = [], []
    if pre_width:
        z_parts.append((p_lde, opened["p_zeta"], 0))
        gz_parts.append((p_lde, opened["p_gzeta"], pre_width))
    z_parts.append((t_lde, opened["t_zeta"], 2 * pre_width))
    gz_parts.append((t_lde, opened["t_gzeta"], 2 * pre_width + width))
    z_parts.append((q_matrix, opened["q_zeta"], 2 * pre_width + 2 * width))
    return ext.add(fold_group(z_parts, inv_z), fold_group(gz_parts, inv_gz))


# ---------------------------------------------------------------------------
# One table
# ---------------------------------------------------------------------------


class OneCard(OneCardFri):
    """``prove``'s default layout: every matrix whole on one device.  A
    layout says where each matrix's rows live and how it is committed and
    opened: ``lde`` (host columns → their LDE as the openings read it, and
    its rows as the quotient and DEEP read them), ``tree`` (a committed
    matrix: ``root``, ``open_many``, its rows as ``matrix``), ``domain``
    (the domain tables at those rows), ``quotient`` (→ the quotient's rows,
    its chunks' coefficients, the constraint count), ``openings`` (the
    columns at ζ and g·ζ) and ``OneCardFri``'s FRI rounds.  The sharded
    prover's is ``parallel.dist_stark.RowBlocks``."""

    def __init__(self, device):
        self.device = device

    def lde(self, cols, config: StarkConfig):
        cols = np.asarray(cols).astype(np.int64, copy=False)
        lde = lde_body(torch.as_tensor(cols, device=self.device), config)
        return lde, lde

    def tree(self, rows: torch.Tensor) -> MerkleTree:
        return MerkleTree(rows)

    def domain(self, log_n: int, config: StarkConfig) -> dict:
        return _domain_tables(log_n, config.log_blowup, config.shift, self.device)

    def quotient(self, air: Air, t_rows, p_rows, alpha, publics, tables, log_n: int,
                 config: StarkConfig):
        return quotient_body(air, t_rows, p_rows, alpha, publics, tables, log_n, config)

    def openings(self, air: Air, t_lde, p_lde, q_col_coeffs, zeta, gzeta, log_n: int,
                 config: StarkConfig) -> dict:
        return openings_body(air, t_lde, p_lde, q_col_coeffs, zeta, gzeta, log_n, config)


def _commit(layout, rows: torch.Tensor):
    """A matrix's tree as ``layout`` commits it, and its root (8 words read
    from the device)."""
    with spans.span("commit"):
        tree = layout.tree(rows)
        return tree, tree.root


def _lde_commit(layout, cols, config: StarkConfig):
    """The LDE of the host columns ``cols()`` and its tree: (LDE, tree)."""
    with spans.span("lde"):
        lde, rows = layout.lde(cols(), config)
    return lde, _commit(layout, rows)[0]


def commit_columns(air: Air, trace, config: StarkConfig, layout) -> dict:
    """The phases of ``prove`` that draw nothing from the transcript, for
    ``prove(..., precommit=...)`` on the same layout: the preprocessed and
    trace columns' (LDE, tree) as "p" (None without preprocessed columns)
    and "t"."""
    trace = np.asarray(trace)
    pre = (_lde_commit(layout, lambda: air.preprocessed_trace(trace.shape[0]), config)
           if air.preprocessed_width else None)
    return {"p": pre, "t": _lde_commit(layout, lambda: trace, config)}


def prove(
    air: Air,
    trace,
    public_values: Sequence[int],
    config: StarkConfig,
    challenger: DuplexChallenger,
    layout=None,
    precommit: dict | None = None,
) -> dict:
    """Prove one AIR instance; chains onto the challenger's transcript.
    ``trace``: (N, width) standard-form ints.  ``layout`` (default
    ``OneCard`` on ``challenger.device``) says where the matrices' rows
    live; ``precommit``: ``commit_columns``'s result for this table and
    layout, made ahead."""
    layout = layout or OneCard(challenger.device)
    trace = np.asarray(trace)
    n, width = trace.shape
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError("trace height must be a power of two")
    if width != air.width:
        raise ValueError("trace width does not match the AIR")
    publics = [int(v) % P for v in public_values]
    if len(publics) != air.num_public_values:
        raise ValueError("wrong number of public values")
    pre_width = air.preprocessed_width
    n_lde = n << config.log_blowup
    done = precommit or {}

    challenger.observe(log_n)
    challenger.observe(width)
    challenger.observe_many(publics)

    # 0. preprocessed (fixed) columns — part of the verifying key
    p_lde = tree_p = None
    if pre_width:
        p_lde, tree_p = done.get("p") or _lde_commit(
            layout, lambda: air.preprocessed_trace(n), config)
        challenger.observe_many(tree_p.root)

    # 1. trace LDE + commit
    t_lde, tree_t = done.get("t") or _lde_commit(layout, lambda: trace, config)
    challenger.observe_many(tree_t.root)
    alpha = challenger.sample_ext()
    t_rows = tree_t.matrix
    p_rows = tree_p.matrix if pre_width else t_rows.new_zeros((t_rows.shape[0], 0))

    # 2.–3. constraint quotient + chunk commitment
    with spans.span("quotient"):
        tables = layout.domain(log_n, config)
        q_rows, q_col_coeffs, count = layout.quotient(
            air, t_rows, p_rows, alpha, publics, tables, log_n, config
        )
    tree_q, root_q = _commit(layout, q_rows)
    challenger.observe_many(root_q)
    zeta = challenger.sample_ext()
    gzeta = ext.s_mul_base(zeta, bb.two_adic_generator(log_n))

    with spans.span("open"):
        # 4. openings at ζ and g·ζ; the transcript absorbs their Merkle digest
        opened = layout.openings(air, t_lde, p_lde, q_col_coeffs, zeta, gzeta, log_n, config)
        challenger.observe_many(opened_digest_std(opened, challenger.device))
        gamma = challenger.sample_ext()

        # 5. DEEP codeword over the LDE domain, 6. FRI on it
        G = deep_body(air, t_rows, p_rows, q_rows, opened, zeta, gzeta, gamma, tables, config)
        fri_proof = fri_prove(G, config.shift, config.fri, challenger, layout)

        # 7. outer openings at i and i + N/2 for each committed matrix
        half = n_lde // 2
        trees = [("t", tree_t), ("q", tree_q)]
        if tree_p is not None:
            trees.insert(0, ("p", tree_p))
        lis = [int(q["index"]) for q in fri_proof["queries"]]
        pairs = [i for li in lis for i in (li, li + half)]
        batches = {name: tree.open_many(pairs) for name, tree in trees}
        openings = []
        for k in range(len(lis)):
            rows = {}
            for name, _ in trees:
                row, path = batches[name]
                rows[name] = {
                    "lo": {"row": pack_u32(row[2 * k]), "path": pack_u32(path[2 * k])},
                    "hi": {"row": pack_u32(row[2 * k + 1]), "path": pack_u32(path[2 * k + 1])},
                }
            openings.append(rows)

    proof = {
        "version": 1,
        "log_n": log_n,
        "width": width,
        "public_values": publics,
        "root_t": tree_t.root,
        "root_q": root_q,
        "opened_t_zeta": pack_u32(opened["t_zeta"]),
        "opened_t_gzeta": pack_u32(opened["t_gzeta"]),
        "opened_q_zeta": pack_u32(opened["q_zeta"]),
        "fri": fri_proof,
        "query_openings": openings,
        "constraint_count": count,
    }
    if pre_width:
        proof["root_p"] = tree_p.root
        proof["opened_p_zeta"] = pack_u32(opened["p_zeta"])
        proof["opened_p_gzeta"] = pack_u32(opened["p_gzeta"])
    return proof
