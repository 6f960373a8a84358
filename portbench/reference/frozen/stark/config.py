"""STARK configuration."""

from __future__ import annotations

from dataclasses import dataclass

from ..pcs.fri import FriConfig


@dataclass(frozen=True)
class StarkConfig:
    """log_blowup bounds the constraint degree: constraints of algebraic
    degree ≤ log_blowup+1 keep the quotient inside the LDE rate."""

    log_blowup: int = 2
    num_queries: int = 40
    proof_of_work_bits: int = 16
    log_final_poly_len: int = 3
    shift: int = 31  # LDE coset shift (the field generator)

    @property
    def blowup(self) -> int:
        return 1 << self.log_blowup

    @property
    def fri(self) -> FriConfig:
        return FriConfig(
            log_blowup=self.log_blowup,
            num_queries=self.num_queries,
            proof_of_work_bits=self.proof_of_work_bits,
            log_final_poly_len=self.log_final_poly_len,
        )


#: default production config: ~2 bits/query × 40 queries + 16-bit grind
DEFAULT_CONFIG = StarkConfig()

#: cheap config for tests
TEST_CONFIG = StarkConfig(num_queries=12, proof_of_work_bits=6, log_final_poly_len=2)
