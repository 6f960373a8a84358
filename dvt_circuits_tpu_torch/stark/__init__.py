from .air import Air
from .config import DEFAULT_CONFIG, TEST_CONFIG, StarkConfig
from .fused import prove_tables
from .prover import prove
from .verifier import StarkError, verify
