"""The g1mul table of the largest documented cluster, planner only.

A 9-of-13 finalization (the largest cluster SSV documents) asks for the
tallest g1mul table the planner makes: 9 − 1 Horner chains of 32 bits and
two Lagrange chains of 256 bits per operator, 130 chains and 70,148 rows,
in a table of 2^17 rows.  The port's ``plan_agg`` must give the JAX
package's chains on the relation each package's witness program records;
no trace is built and nothing is proven.
"""

from __future__ import annotations

import functools
import json

from dvt_circuits_tpu_torch.dkg.scenario_gen import DkgCommittee
from dvt_circuits_tpu_torch.prover import curve_glue
from dvt_circuits_tpu_torch.stark.g1mul_air import G1MulAir

N, K = 13, 9
CHAINS = N * (K - 1) + 2 * N
ROWS = N * (K - 1) * (32 * 7 + 2) + 2 * N * (256 * 7 + 2)


@functools.cache
def _scenario() -> str:
    data = DkgCommittee(N, K, seed=b"9-of-13").finalization_data()
    return json.dumps(data.to_json(True))


def _relations(pkg) -> list:
    """The curve relations ``pkg``'s witness program records on the
    scenario (``pkg``: the port or the JAX package)."""
    import importlib

    registry = importlib.import_module(f"{pkg}.circuits.registry")
    pipeline = importlib.import_module(f"{pkg}.prover.pipeline")
    recorder = importlib.import_module(f"{pkg}.dkg.hash_recorder")
    spec = registry.get_circuit("finalization")
    data = spec.data_type.from_json(json.loads(_scenario()), spec.setup.layout, True)
    with recorder.recording(), recorder.chacha_recording(), recorder.g1_recording() as rels:
        result = pipeline.execute_circuit("finalization", data, True)
    assert result.exit_code == 0, result.panic_message
    return list(rels)


def test_13op_finalization_plans_the_tallest_table_as_the_jax_package():
    from dvt_circuits_tpu.prover import curve_glue as jax_glue

    ours, theirs = _relations("dvt_circuits_tpu_torch"), _relations("dvt_circuits_tpu")
    assert [r["kind"] for r in ours] == [r["kind"] for r in theirs] == ["agg"]
    chains, meta = curve_glue.plan_agg(ours[0])
    jax_chains, jax_meta = jax_glue.plan_agg(theirs[0])
    assert meta == jax_meta == {"n": N, "k": K}
    assert len(chains) == len(jax_chains) == CHAINS == 130
    assert [(b, s, op, res) for b, s, op, res in chains] == \
        [(b, bytes(s), tuple(op), None if res is None else tuple(res))
         for b, s, op, res in jax_chains]
    rows = sum(b * 7 + 2 for b, *_ in chains)
    assert rows == ROWS == 70_148 <= curve_glue.MAX_CHAIN_ROWS
    air = G1MulAir(tuple(b for b, *_ in chains))
    assert air.min_rows == rows
    assert 1 << air.log_rows == 131_072 == curve_glue.MAX_CHAIN_ROWS
