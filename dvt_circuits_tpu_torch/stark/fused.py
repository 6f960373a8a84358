"""Multi-table proving on one Fiat–Shamir transcript.

Counterpart of ``dvt_circuits_tpu/stark/fused.py:prove_tables``.  The JAX
package traced the whole proof into one jitted dispatch; PyTorch runs
eagerly, so here the tables are proven in order by the phase prover
(``stark/prover.py``) on one shared challenger, which gives the same
transcript and the same proof dicts.
"""

from __future__ import annotations

from typing import Sequence

from ..pcs.challenger import DuplexChallenger
from .config import StarkConfig
from .prover import prove


def prove_tables(entries: Sequence[tuple], config: StarkConfig, device="cuda") -> list:
    """Prove (air, trace, public_values) tables in order on one chained
    transcript; returns one proof dict per table."""
    challenger = DuplexChallenger(device)
    return [prove(air, trace, publics, config, challenger) for air, trace, publics in entries]
