"""An operator's time from a fault's JSON input to its container: the
parse and prove calls' ``perf_counter`` time summed over the window,
over the proofs in it."""


def read(run):
    done = run.proven
    return 1e3 * sum(r["prove_s"] for r in done) / len(done) if done else None
