"""Pipeline-parallel (PP) commit: prover stages on ranks, microbatches
handed on from rank to rank.

Counterpart of ``dvt_circuits_tpu/parallel/pp_pipeline.py``, the GPipe-style
mapping of a batched commit: stage s of the commit pipeline lives on rank s
of a ``pp`` mesh axis, microbatches (independent traces of a proof batch)
stream through, and at step t rank s works on microbatch t − s; once the
pipe is full every stage is busy, and ``comm.ppermute`` carries the buffer
one hop a step (NCCL point-to-point on the card).

Stages (S = pp axis size ≥ 3), every one with real work:
  0        — coset LDE of the microbatch
  1        — Poseidon2 leaf sponge of its rows (one K1b launch)
  2..S−1   — the log₂(n_lde) Merkle compression levels, split evenly over
             the remaining stages, the earlier ones taking the extra level
             (one K1a launch a level: each parent is the permutation of its
             two children, ``left ‖ right``, first 8 words); the last emits
             the root.

A demo of the mapping: no prove path calls it.  The roots are standard
form and equal the single-device ``merkle_root`` of each microbatch's coset
LDE (and ``from_mont`` of the reference's roots).
"""

from __future__ import annotations

import torch

from ..field import babybear as bb
from ..hash.poseidon2 import DIGEST_WIDTH, WIDTH, poseidon2_permute
from ..ntt.ntt import coset_lde
from ..pcs.merkle import hash_rows
from .comm import ppermute, psum
from .ep_tables import _as_int64
from .mesh import Mesh


def pp_commit_pipeline(traces, mesh: Mesh, log_blowup: int = 1, shift: int = bb.GENERATOR,
                       axis_name: str = "pp") -> torch.Tensor:
    """Pipelined batched commit; every rank of the axis calls this with the
    same traces.

    traces: (B, n, w) standard-form words (microbatches of a proof batch).
    Returns the (B, 8) standard-form Merkle roots on every rank."""
    ax = mesh.axis(axis_name)
    S = ax.size
    if S < 3:
        raise ValueError("pipeline needs at least 3 stages (lde, hash, reduce)")
    B, n, w = traces.shape
    n_lde = n << log_blowup
    buf_w = max(w, DIGEST_WIDTH)
    steps = B + S - 1
    # distribute the log2(n_lde) compression levels over stages 2..S-1:
    # earlier reduce stages take the (larger) lower levels
    total_levels = n_lde.bit_length() - 1
    n_reduce = S - 2
    base, extra = divmod(total_levels, n_reduce)
    levels_per_stage = [base + (1 if i < extra else 0) for i in range(n_reduce)]
    # rows of live digests ENTERING each reduce stage
    rows_in = []
    rows = n_lde
    for lv in levels_per_stage:
        rows_in.append(rows)
        rows >>= lv

    stage = ax.index
    dev = mesh.device
    tr = _as_int64(traces, dev) if stage == 0 else None

    def run_stage(buf: torch.Tensor, mb: int) -> torch.Tensor:
        out = buf.new_zeros((n_lde, buf_w))
        if stage == 0:
            out[:, :w] = coset_lde(tr[mb], log_blowup, shift)
        elif stage == 1:
            out[:, :DIGEST_WIDTH] = hash_rows(buf[:, :w])
        else:
            digests = buf[: rows_in[stage - 2], :DIGEST_WIDTH]
            for _ in range(levels_per_stage[stage - 2]):
                digests = poseidon2_permute(digests.reshape(-1, WIDTH))[:, :DIGEST_WIDTH]
            out[: digests.shape[0], :DIGEST_WIDTH] = digests
        return out

    perm = [(d, (d + 1) % S) for d in range(S)]
    buf = torch.zeros((n_lde, buf_w), dtype=torch.int64, device=dev)
    roots = torch.zeros((B, DIGEST_WIDTH), dtype=torch.int64, device=dev)
    for step in range(steps):
        mb = step - stage  # the microbatch this stage holds at this step
        if 0 <= mb < B:
            buf = run_stage(buf, mb)
            if stage == S - 1:  # the root emerges at step = microbatch + S − 1
                roots[mb] = buf[0, :DIGEST_WIDTH]
        else:
            buf = buf.new_zeros((n_lde, buf_w))
        # hand the buffer one stage down the pipe (ring; stage 0 ignores it)
        buf = ppermute(buf, ax, perm)
    # only the last stage holds the roots; the sum gives them to every rank
    return psum(roots, ax)
