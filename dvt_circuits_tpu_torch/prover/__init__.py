from .pipeline import (
    ProveError,
    execute_circuit,
    load_proof,
    prove_circuit,
    save_proof,
)
