from .pipeline import (
    ProveError,
    VerifyError,
    VerifyResult,
    execute_circuit,
    load_proof,
    prove_batch,
    prove_circuit,
    save_proof,
    verify_proof,
)
